"""No-reference quality metrics (port of ``srs_tpu/qa/noref.py:35-102``):
MSCN coefficients (7x7 Gaussian, sigma 7/6), the closed-form NIQE and
BRISQUE, Laplacian-variance sharpness, grey contrast and Lab
colourfulness.

Every function takes (..., H, W, C) images in [0, 255] and reduces over
the image axes only, so a leading batch axis gives one value per image
(the reference vmaps the same functions over crops).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.colorspace import rgb_to_gray, rgb_to_lab
from ..ops.filters import gaussian_blur, laplacian, sobel

__all__ = [
    "mscn",
    "niqe",
    "brisque",
    "sharpness",
    "contrast",
    "colorfulness",
    "no_reference_metrics",
]

_HW = (-2, -1)


def _gray(image: torch.Tensor) -> torch.Tensor:
    if image.dim() >= 3 and image.shape[-1] in (1, 3):
        return rgb_to_gray(image) if image.shape[-1] == 3 else image[..., 0]
    return image


def mscn(gray: torch.Tensor) -> torch.Tensor:
    """Mean-subtracted contrast-normalized coefficients of (..., H, W)."""
    g = gray.float()
    mu = gaussian_blur(g, 7, 7.0 / 6.0)
    sigma_sq = gaussian_blur(g * g, 7, 7.0 / 6.0) - mu * mu
    sigma = torch.sqrt(torch.clamp(sigma_sq, min=0.0))
    return (g - mu) / (sigma + 1.0)


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, dim=_HW, correction=0)


def niqe(image: torch.Tensor) -> torch.Tensor:
    """Closed-form NIQE: (std + |mean|) of MSCN * 2 + 3, clipped to [1, 15]."""
    m = mscn(_gray(image))
    val = _std(m) + m.mean(dim=_HW).abs()
    return torch.clamp(val * 2.0 + 3.0, 1.0, 15.0)


def brisque(image: torch.Tensor) -> torch.Tensor:
    """Closed-form BRISQUE: mean of [MSCN mean, std, abs-mean, gradient
    magnitude mean, std] * 10 + 20, clipped to [0, 100]."""
    g = _gray(image).float()
    m = mscn(g)
    gx, gy = sobel(g)
    mag = torch.sqrt(gx * gx + gy * gy)
    feats = torch.stack([m.mean(dim=_HW), _std(m), m.abs().mean(dim=_HW),
                         mag.mean(dim=_HW), _std(mag)])
    return torch.clamp(feats.mean(dim=0) * 10.0 + 20.0, 0.0, 100.0)


def sharpness(image: torch.Tensor) -> torch.Tensor:
    """Variance of the Laplacian."""
    return torch.var(laplacian(_gray(image).float()), dim=_HW, correction=0)


def contrast(image: torch.Tensor) -> torch.Tensor:
    """Standard deviation of grey."""
    return _std(_gray(image).float())


def colorfulness(image: torch.Tensor) -> torch.Tensor:
    """sqrt(var(a) + var(b)) in Lab."""
    lab = rgb_to_lab(image.float())
    return torch.sqrt(torch.var(lab[..., 1], dim=_HW, correction=0)
                      + torch.var(lab[..., 2], dim=_HW, correction=0))


def no_reference_metrics(image: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All no-reference values of (..., H, W, C) in one pass."""
    return {
        "niqe": niqe(image),
        "brisque": brisque(image),
        "sharpness": sharpness(image),
        "contrast": contrast(image),
        "colorfulness": colorfulness(image),
    }
