"""Colour conversions with OpenCV's 8-bit conventions (port of
``srs_tpu/ops/colorspace.py:18-50``). Inputs are float tensors in
[0, 255] with channels last; Lab comes out as cv2 packs it for 8 bits
(L * 255 / 100, a and b + 128).
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray", "rgb_to_lab"]


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY: 0.299 R + 0.587 G + 0.114 B, on (..., 3) -> (...)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(t > d**3, t.clamp(min=0.0).pow(1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2LAB 8-bit convention on (..., 3) in [0, 255]: sRGB (D65,
    linearized) -> XYZ -> CIELAB, L scaled by 255/100, a/b offset +128."""
    x = rgb / 255.0
    lin = torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    X = 0.412453 * r + 0.357580 * g + 0.180423 * b
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    fx = _f_lab(X / 0.950456)
    fy = _f_lab(Y)
    fz = _f_lab(Z / 1.088754)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L * (255.0 / 100.0), a + 128.0, bb + 128.0], dim=-1)
