"""Commercial-advertising quality metrics (port of
``srs_tpu/qa/commercial.py``).

Detail fidelity (the FFT high-frequency ratio, 5x5 local-variance
texture, the YCrCb skin-ratio naturalness of a face), colour accuracy
(Lab L variance, brand-colour delta-E, skin tone against Lab(70, 15, 20)
in cv2's 8-bit packing) and visual comfort (Canny edge density,
variance of 8x8 block variances, high-pass noise, 4x4 brightness
uniformity), on tensors in [0, 255] on any device. Variances and
standard deviations are population statistics (``correction=0``), as
``jnp.var`` and ``jnp.std`` compute them.

ROIs are cropped on the host (their boxes are data); each metric takes a
whole image or a cropped ROI. Each returns a 0-d float32 tensor.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.colorspace import rgb_to_gray, rgb_to_lab, rgb_to_ycrcb
from ..ops.filters import box_blur, canny_edges, gaussian_blur
from .noref import contrast, sharpness

__all__ = [
    "hf_ratio",
    "texture_score",
    "face_naturalness",
    "color_variance",
    "delta_e",
    "skin_tone_naturalness",
    "oversharpen_score",
    "artifact_score",
    "noise_level",
    "brightness_uniformity",
    "evaluate_commercial_arrays",
]


def _gray(image: torch.Tensor) -> torch.Tensor:
    if image.dim() >= 3 and image.shape[-1] == 3:
        return rgb_to_gray(image).float()
    if image.dim() >= 3 and image.shape[-1] == 1:
        return image[..., 0].float()
    return image.float()


def hf_ratio(image: torch.Tensor) -> torch.Tensor:
    """Share of the centred magnitude spectrum outside the radius
    min(h, w) // 4."""
    g = _gray(image)
    h, w = g.shape[-2], g.shape[-1]
    mag = torch.fft.fftshift(torch.fft.fft2(g), dim=(-2, -1)).abs()
    yy = torch.arange(h, dtype=torch.float32, device=g.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=g.device)[None, :]
    dist = torch.sqrt((xx - w // 2) ** 2 + (yy - h // 2) ** 2)
    mask = (dist > min(h, w) // 4).float()
    return (mag * mask).sum() / (mag.sum() + 1e-10)


def texture_score(image: torch.Tensor) -> torch.Tensor:
    """Mean 5x5 local variance of grey."""
    g = _gray(image)
    return (box_blur(g * g, 5) - box_blur(g, 5) ** 2).mean()


def face_naturalness(image: torch.Tensor) -> torch.Tensor:
    """100 - |skin ratio - 0.3| * 100, the skin ratio from YCrCb bounds."""
    ycrcb = rgb_to_ycrcb(image.float())
    cr, cb = ycrcb[..., 1], ycrcb[..., 2]
    skin = (cr >= 133) & (cr <= 173) & (cb >= 77) & (cb <= 127)
    ratio = skin.float().mean()
    return torch.clamp(100.0 - (ratio - 0.3).abs() * 100.0, 0.0, 100.0)


def color_variance(image: torch.Tensor) -> torch.Tensor:
    """Variance of the Lab L channel."""
    return torch.var(rgb_to_lab(image.float())[..., 0], correction=0)


def delta_e(image: torch.Tensor, reference_rgb: torch.Tensor) -> torch.Tensor:
    """Euclidean distance in cv2 8-bit Lab between the image's mean colour
    and ``reference_rgb``."""
    mean_rgb = image.float().mean(dim=tuple(range(image.dim() - 1)))
    lab1 = rgb_to_lab(mean_rgb)
    lab2 = rgb_to_lab(reference_rgb.float())
    return torch.sqrt(((lab1 - lab2) ** 2).sum())


def skin_tone_naturalness(image: torch.Tensor) -> torch.Tensor:
    """100 - the distance of the packed Lab means from (70, 15, 20),
    floored at 0 (the reference compares the packed means directly)."""
    lab = rgb_to_lab(image.float())
    dist = torch.sqrt((lab[..., 0].mean() - 70.0) ** 2 + (lab[..., 1].mean() - 15.0) ** 2
                      + (lab[..., 2].mean() - 20.0) ** 2)
    return torch.clamp(100.0 - dist, min=0.0)


def oversharpen_score(image: torch.Tensor) -> torch.Tensor:
    """100 - Canny edge density * 500, floored at 0."""
    density = canny_edges(_gray(image), 50.0, 150.0).mean()
    return torch.clamp(100.0 - density * 500.0, min=0.0)


def artifact_score(image: torch.Tensor) -> torch.Tensor:
    """Blockiness: 100 - (variance of the 8x8 blocks' variances) / 100,
    floored at 0. Blocks start at 0, 8, ... strictly below dim - 8."""
    g = _gray(image)
    h, w = g.shape[-2], g.shape[-1]
    bh = max(1, (h - 8 + 7) // 8)
    bw = max(1, (w - 8 + 7) // 8)
    blocks = g[..., : bh * 8, : bw * 8].reshape(*g.shape[:-2], bh, 8, bw, 8)
    bvar = torch.var(blocks, dim=(-3, -1), correction=0)
    return torch.clamp(100.0 - torch.var(bvar, correction=0) / 100.0, min=0.0)


def noise_level(image: torch.Tensor) -> torch.Tensor:
    """Standard deviation of grey minus its 3x3 Gaussian blur (cv2's sigma
    rule for sigma 0: 0.8)."""
    g = _gray(image)
    return torch.std(g - gaussian_blur(g, 3, 0.0), correction=0)


def brightness_uniformity(image: torch.Tensor) -> torch.Tensor:
    """100 - the standard deviation of the 4x4 regions' mean grey, floored
    at 0."""
    g = _gray(image)
    h, w = g.shape[-2], g.shape[-1]
    rh, rw = h // 4, w // 4
    means = g[..., : rh * 4, : rw * 4].reshape(*g.shape[:-2], 4, rh, 4, rw).mean(dim=(-3, -1))
    return torch.clamp(100.0 - torch.std(means, correction=0), min=0.0)


def evaluate_commercial_arrays(
    image: torch.Tensor,
    roi_regions: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, torch.Tensor]:
    """Every commercial metric of an (H, W, C) image, with per-ROI keys and
    the commercial score. An ROI is ``{"type": ..., "bbox": [x, y, w, h]}``
    (``"reference_color": [r, g, b]`` for a brand): the box is clipped to
    the image and skipped when it has no area; its keys carry its index in
    the list."""
    metrics: Dict[str, torch.Tensor] = {}
    h, w = int(image.shape[-3]), int(image.shape[-2])
    metrics["global_sharpness"] = sharpness(image)
    metrics["high_frequency_ratio"] = hf_ratio(image)

    def crop(bbox: Sequence[int]) -> Optional[torch.Tensor]:
        x, y, rw, rh = bbox
        x, y = max(0, int(x)), max(0, int(y))
        rw, rh = min(int(rw), w - x), min(int(rh), h - y)
        if rw <= 0 or rh <= 0:
            return None
        return image[..., y : y + rh, x : x + rw, :]

    for i, roi in enumerate(roi_regions or ()):
        roi_type = roi.get("type", f"roi_{i}")
        region = crop(roi.get("bbox", [0, 0, w, h]))
        if region is None:
            continue
        if roi_type == "text":
            metrics[f"text_sharpness_{i}"] = sharpness(region)
            metrics[f"text_contrast_{i}"] = contrast(region)
        elif roi_type == "product":
            metrics[f"product_texture_{i}"] = texture_score(region)
        elif roi_type == "face":
            metrics[f"face_naturalness_{i}"] = face_naturalness(region)
            metrics[f"skin_tone_naturalness_{i}"] = skin_tone_naturalness(region)
        if roi_type == "brand" and roi.get("reference_color") is not None:
            ref = torch.from_numpy(np.array(roi["reference_color"], np.float32))
            metrics[f"brand_color_delta_e_{i}"] = delta_e(region, ref.to(image.device))

    metrics["color_variance"] = color_variance(image)
    metrics["oversharpen_score"] = oversharpen_score(image)
    metrics["artifact_score"] = artifact_score(image)
    metrics["noise_level"] = noise_level(image)
    metrics["brightness_uniformity"] = brightness_uniformity(image)
    scores = [
        torch.clamp(metrics["global_sharpness"] / 10.0, max=100.0),
        torch.clamp(metrics["high_frequency_ratio"] * 500.0, max=100.0),
        metrics["oversharpen_score"],
        metrics["artifact_score"],
    ]
    metrics["commercial_score"] = torch.stack(scores).mean()
    return metrics
