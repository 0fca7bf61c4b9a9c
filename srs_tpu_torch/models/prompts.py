"""Industry prompt templates (port of ``srs_tpu/models/prompts.py``, all of
it; the reference follows the original system's ``PromptTemplateManager``).

The same 8 category keys, each with subject/style/quality/negative
strings; ``build_prompt`` joins subject, style and quality with a
``###negative`` suffix. On the device a category steers the conditioned
polish (``models/conditioning.py``) through its conditioning vector;
``category_id`` is its stable integer id.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["PromptTemplateManager", "category_id"]

_CATEGORIES = [
    "beauty",
    "3c",
    "food",
    "fashion",
    "jewelry",
    "furniture",
    "automotive",
    "general",
]


class PromptTemplateManager:
    """8 industry templates with subject/style/quality/negative fields."""

    TEMPLATES: Dict[str, Dict[str, str]] = {
        "beauty": {
            "name": "Beauty & Skincare",
            "subject": "high-end cosmetic product with refined packaging",
            "style": "diffuse studio light, uncluttered backdrop, commercial catalog look",
            "quality": "ultra-high definition, crisp edges, faithful color",
            "negative": "soft focus, artifacts, color shifts, plastic sheen",
        },
        "3c": {
            "name": "Consumer Electronics",
            "subject": "contemporary electronic device with precise industrial design",
            "style": "clean studio setup, controlled reflections, product-hero angle",
            "quality": "ultra-high definition, exact edge geometry, neutral rendering",
            "negative": "sensor noise, halo edges, smudged reflections, banding",
        },
        "food": {
            "subject": "fresh prepared dish with appealing plating",
            "name": "Food & Beverage",
            "style": "window-light food styling, rich surface texture",
            "quality": "ultra-high definition, appetizing micro-detail, true color",
            "negative": "flat color, mushy texture, overcooked highlights",
        },
        "fashion": {
            "name": "Fashion & Apparel",
            "subject": "premium garment with visible weave and drape",
            "style": "editorial lighting, shallow depth of field",
            "quality": "ultra-high definition, thread-level fabric detail, accurate dye",
            "negative": "moire, flattened weave, hue drift, crushed blacks",
        },
        "jewelry": {
            "name": "Jewelry",
            "subject": "fine jewelry piece with cut stones and polished metal",
            "style": "macro capture, controlled sparkle, dark elegant staging",
            "quality": "ultra-high definition, facet sharpness, honest metal tone",
            "negative": "hazy stones, blown speculars, warped reflections",
        },
        "furniture": {
            "name": "Home & Furniture",
            "subject": "designer furniture piece in a lived-in setting",
            "style": "ambient interior light, warm staging",
            "quality": "ultra-high definition, true grain and fabric texture",
            "negative": "perspective warp, muddy shadows, busy background",
        },
        "automotive": {
            "name": "Automotive",
            "subject": "precision automotive component with machined surfaces",
            "style": "dramatic directional light, metallic emphasis",
            "quality": "ultra-high definition, engineering-grade edge fidelity",
            "negative": "surface blemishes, soft machining marks, proportion drift",
        },
        "general": {
            "name": "General Merchandise",
            "subject": "retail product presented for commercial listing",
            "style": "neutral backdrop, even illumination, centered composition",
            "quality": "ultra-high definition, uniform sharpness, calibrated color",
            "negative": "uneven light, casual framing, focus falloff",
        },
    }

    @classmethod
    def get_template(cls, category: str) -> Dict[str, str]:
        """Template for a category, falling back to 'general'
        (reference: sr:168-178)."""
        return cls.TEMPLATES.get(category, cls.TEMPLATES["general"])

    @classmethod
    def build_prompt(
        cls,
        category: str = "general",
        custom_subject: str = "",
        extra_requirements: str = "",
        include_negative: bool = True,
    ) -> str:
        """subject, style, quality joined by ', '; negative appended after
        '###' (reference: sr:180-217)."""
        t = cls.get_template(category)
        subject = custom_subject or t["subject"]
        parts = [subject, t["style"], t["quality"]]
        if extra_requirements:
            parts.append(extra_requirements)
        prompt = ", ".join(p for p in parts if p)
        if include_negative and t.get("negative"):
            prompt += f"###{t['negative']}"
        return prompt

    @classmethod
    def list_categories(cls) -> List[str]:
        return list(cls.TEMPLATES.keys())


def category_id(category: str) -> int:
    """Stable integer id for a category (conditioning hook)."""
    return _CATEGORIES.index(category) if category in _CATEGORIES else _CATEGORIES.index("general")
