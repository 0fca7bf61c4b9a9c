"""The text-to-image API (port of ``srs_tpu/models/generate.py``).

``ARKImageGenerator.generate(prompt)`` keeps the reference's call surface
(``ARKImageConfig``, ``ARKImageResult``, sizes "1K", "2K", "4K" or "WxH",
the watermark, the seed from the prompt's md5). Two backends serve it:

- **learned**, when a trained generator is there (``weights[("ark_gen",
  1)]`` handed in, ``ark_gen_x1.pt`` under ``checkpoint_dir``, or the
  store's, in that order; the store's is trained at 128 px): the
  class-conditional diffusion model of ``models/generative.py`` samples
  the native-size image for the prompt's class (DDIM with classifier-free
  guidance), the SR ladder of ``models/sr_module.py`` upscales it to the
  requested size, an exact-size bicubic resize finishes it, and with
  ``extra={"refine": True}`` SDEdit tiles add detail at the native size;
- **procedural**, when there is no trained generator, when the config's model
  names the procedural synthesizer, or under ``SRS_ARK_PROCEDURAL=1``: a
  deterministic low-frequency synthesizer seeded from the prompt.

Unlike the reference, a failure of the learned path is not served as the
procedural image: on the card that would hide a device or kernel fault,
so it raises. ``ARKImageResult.image`` is the float32 [H, W, 3] numpy
array (the reference's branch without PIL; the card has no PIL).
"""

from __future__ import annotations

import hashlib
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["ARKImageConfig", "ARKImageResult", "ARKImageGenerator", "generate_image"]

_SIZES = {"1K": (1024, 1024), "2K": (2048, 2048), "4K": (4096, 4096)}


@dataclass
class ARKImageConfig:
    """(reference: ark_api_module.py:17-25)."""

    model: str = "ark-gen-v1"
    size: str = "2K"
    watermark: bool = False
    seed: Optional[int] = None
    guidance_scale: float = 7.5
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ARKImageResult:
    image: Any
    prompt: str
    seed: int
    size: Tuple[int, int]
    processing_time: float
    metadata: Dict[str, Any] = field(default_factory=dict)


def _force_procedural(cfg: ARKImageConfig) -> bool:
    """True when the procedural backend is asked for: the config's model
    names it, or ``SRS_ARK_PROCEDURAL`` is a true boolean (``=0`` is not)."""
    if (cfg.model or "").lower().startswith("procedural"):
        return True
    return os.environ.get("SRS_ARK_PROCEDURAL", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


def _resolve_size(size: str) -> Tuple[int, int]:
    if size in _SIZES:
        return _SIZES[size]
    m = re.fullmatch(r"(\d+)x(\d+)", size or "")
    if m:
        return int(m.group(1)), int(m.group(2))
    return _SIZES["2K"]


class ARKImageGenerator:
    """(reference: ark_api_module.py:28-80); ``api_key`` is accepted for
    parity. The generator and the SR nets run on ``device`` (the card by
    default; raises without one). ``weights`` maps ``(net, scale)`` to a
    state dict, as for ``SuperResolutionModule``: ``("ark_gen", 1)`` is the
    generator, the rest are SR nets. ``checkpoint_dir`` is where both are
    read otherwise (``ark_gen_x1.pt`` with ``ark_meta.json``;
    ``{net}_x{scale}.pt``)."""

    def __init__(
        self,
        api_key: str = "",
        config: Optional[ARKImageConfig] = None,
        checkpoint_dir: Optional[str] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        del api_key
        self.config = config or ARKImageConfig()
        self.checkpoint_dir = os.path.expanduser(checkpoint_dir) if checkpoint_dir else None
        self.weights = dict(weights or {})
        self.device = resolve_device(device)
        self._sr = None

    def generate(self, prompt: str, config: Optional[ARKImageConfig] = None) -> ARKImageResult:
        cfg = config or self.config
        t0 = time.time()
        w, h = _resolve_size(cfg.size)
        seed = cfg.seed
        if seed is None:
            seed = int(hashlib.md5(prompt.encode()).hexdigest()[:8], 16) % (2**31)
        img = meta = None
        if not _force_procedural(cfg):
            img, meta = self._generate_learned(prompt, cfg, seed, (w, h))
        if img is None:
            img = _procedural(prompt, seed, (w, h))
            meta = {"model": "procedural-v1"}
        if cfg.watermark:
            img[-32:, -192:] = np.clip(img[-32:, -192:] * 0.6 + 80, 0, 255)
        return ARKImageResult(
            image=img, prompt=prompt, seed=seed, size=(w, h),
            processing_time=time.time() - t0, metadata=meta,
        )

    # -- learned backend ---------------------------------------------------

    def _sr_module(self):
        """The SR engine of the ladder, built once: the SR weights handed
        in and those saved in ``checkpoint_dir``."""
        if self._sr is None:
            from ..config import ModelConfig
            from .sr_module import SuperResolutionModule

            sr_weights = {k: v for k, v in self.weights.items() if k != ("ark_gen", 1)}
            self._sr = SuperResolutionModule(ModelConfig(checkpoint_dir=self.checkpoint_dir),
                                             sr_weights, device=self.device)
        return self._sr

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generate_learned(
        self, prompt: str, cfg: ARKImageConfig, seed: int, wh: Tuple[int, int]
    ) -> Tuple[Optional[np.ndarray], Dict[str, Any]]:
        """(float32 [H, W, 3] image, metadata), or (None, {}) when no
        generator is trained. The metadata carries the reference's keys
        and, the port's own, ``stage_seconds`` (sample, SR ladder, resize,
        refine; each ends in a synchronise on the card)."""
        from ..ops.resize import resize_bicubic
        from .generative import (_DEFAULT_META, ARK_CLASSES, ark_meta, build_ark,
                                 class_for_prompt, sample_ark)
        from .sr_module import scale_ladder

        handed = self.weights.get(("ark_gen", 1))
        module, _params, trained = build_ark(self.checkpoint_dir, params=handed,
                                             device=self.device)
        if not trained:
            return None, {}
        w, h = wh
        cls = class_for_prompt(prompt, cfg.extra.get("category"))
        steps = int(cfg.extra.get("steps", 50))
        # The API's guidance_scale rides the reference's diffusion range
        # (default 7.5); this small model saturates lower, so map it into
        # [1, 4] around the same default.
        g = float(np.clip(1.0 + (cfg.guidance_scale - 1.0) * 0.25, 1.0, 4.0))
        native = int(cfg.extra.get("base_size", (
            _DEFAULT_META if handed is not None else ark_meta(self.checkpoint_dir))["size"]))
        seconds: Dict[str, float] = {}
        t = time.time()
        base = sample_ark(module, cls, seed=seed, size=native, steps=steps, guidance=g)
        self._sync()
        seconds["sample"] = time.time() - t
        side = int(base.shape[1])
        total = max(w, h) / side
        ladder = []
        provider = cfg.extra.get("sr_provider", "quality")
        t = time.time()
        if total > 1.0:
            sr = self._sr_module()
            ladder = scale_ladder(total, trained=sr.trained_scales(provider))
            with torch.no_grad():
                for s in ladder:
                    base = sr.upscale_tiles(base, s, provider=provider)
        self._sync()
        seconds["sr_ladder"] = time.time() - t
        t = time.time()
        if base.shape[1] != h or base.shape[2] != w:
            base = torch.clamp(resize_bicubic(base, h, w), 0, 255)
        self._sync()
        seconds["resize"] = time.time() - t
        refined = False
        if cfg.extra.get("refine") and max(w, h) > side:
            from .generative import refine_ark

            t = time.time()
            base = refine_ark(
                module, base[0], cls, seed=seed ^ 0x5EED,
                t0=float(cfg.extra.get("refine_t0", 0.22)),
                steps=int(cfg.extra.get("refine_steps", 8)),
                guidance=g if g <= 2.0 else 1.5,
                tile=side,
            )[None]
            self._sync()
            seconds["refine"] = time.time() - t
            refined = True
        img = base[0].float().cpu().numpy()
        return img, {
            "model": "ark_gen-ddim",
            "class": ARK_CLASSES[cls],
            "guidance": g,
            "steps": steps,
            "base_size": side,
            "sr_ladder": ladder,
            "refined": refined,
            "stage_seconds": seconds,
        }


def _procedural(prompt: str, seed: int, wh: Tuple[int, int]) -> np.ndarray:
    """Deterministic low-frequency synthesizer (float32 [H, W, 3])."""
    w, h = wh
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.5, 4.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(20, 60, 3)
        wave = np.sin(xx / w * fx * 2 * np.pi + px) * np.cos(yy / h * fy * 2 * np.pi + py)
        img += wave[..., None] * amp[None, None, :]
    return np.clip(img + 127.0, 0, 255)


def generate_image(prompt: str, device: Union[str, torch.device] = "cuda",
                   **kwargs: Any) -> ARKImageResult:
    """Module-level helper (reference: ark_api_module.py:84-87); ``kwargs``
    are the fields of :class:`ARKImageConfig`."""
    return ARKImageGenerator(device=device).generate(
        prompt, ARKImageConfig(**kwargs) if kwargs else None)
