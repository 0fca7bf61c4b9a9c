"""Colour conversions with OpenCV's 8-bit conventions (port of
``srs_tpu/ops/colorspace.py:18-111``). Inputs are float tensors in
[0, 255] with channels last; Lab comes out as cv2 packs it for 8 bits
(L * 255 / 100, a and b + 128), YCrCb with its offset of 128.

``convert_profile`` is the export's working-space conversion (sRGB to
AdobeRGB or ProPhoto), numpy in float64 on the host, as the reference
runs it on bytes already fetched.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["rgb_to_gray", "rgb_to_lab", "rgb_to_ycrcb", "convert_profile"]


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


def rgb_to_ycrcb(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2YCrCb 8-bit convention on (..., 3) in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 128.0
    cb = (b - y) * 0.564 + 128.0
    return torch.stack([y, cr, cb], dim=-1)


_SRGB_TO_XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], np.float64)
_XYZ_TO_ADOBE = np.array(
    [[2.0413690, -0.5649464, -0.3446944],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0134474, -0.1183897, 1.0154096]], np.float64)
_BRADFORD_D65_TO_D50 = np.array(
    [[1.0478112, 0.0228866, -0.0501270],
     [0.0295424, 0.9904844, -0.0170491],
     [-0.0092345, 0.0150436, 0.7521316]], np.float64)
_XYZ50_TO_PROPHOTO = np.array(
    [[1.3459433, -0.2556075, -0.0511118],
     [-0.5445989, 1.5081673, 0.0205351],
     [0.0000000, 0.0000000, 1.2118128]], np.float64)


def _srgb_decode(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


_ADOBE = ("adobergb", "adobe", "adobe_rgb")
_PROPHOTO = ("prophoto", "prophotorgb", "prophoto_rgb")
_BAND_SAMPLES = 1 << 22  # samples a thread converts at a time


def _convert(rgb: np.ndarray, target: str) -> np.ndarray:
    lin = _srgb_decode(np.clip(np.asarray(rgb, np.float64) / 255.0, 0.0, 1.0))
    xyz = lin @ _SRGB_TO_XYZ.T
    if target in _ADOBE:
        out = np.clip(xyz @ _XYZ_TO_ADOBE.T, 0.0, 1.0) ** (256.0 / 563.0)
    else:
        xyz50 = xyz @ _BRADFORD_D65_TO_D50.T
        out = np.clip(xyz50 @ _XYZ50_TO_PROPHOTO.T, 0.0, 1.0) ** (1.0 / 1.8)
    return (out * 255.0).astype(np.float32)


def convert_profile(rgb: np.ndarray, target: str) -> np.ndarray:
    """sRGB [0, 255] -> AdobeRGB or ProPhoto [0, 255] float32, relative
    colorimetric: linearize sRGB, matrix to XYZ (D65), Bradford-adapt to
    D50 for ProPhoto, matrix to the target primaries, then the target's
    encoding gamma (AdobeRGB 563/256, ProPhoto 1.8). sRGB returns the
    input unchanged. Each pixel converts on its own, so a large image
    converts in row bands on a thread pool (numpy releases the
    interpreter lock)."""
    if target in ("sRGB", "srgb", None, ""):
        return rgb
    key = target.lower()
    if key not in _ADOBE + _PROPHOTO:
        raise ValueError(f"unknown color space {target!r}")
    rgb = np.asarray(rgb)
    if rgb.ndim < 2 or rgb.size <= _BAND_SAMPLES:
        return _convert(rgb, key)
    out = np.empty(rgb.shape, np.float32)
    rows = max(1, _BAND_SAMPLES // (rgb.size // rgb.shape[0]))

    def band(r0: int) -> None:
        out[r0 : r0 + rows] = _convert(rgb[r0 : r0 + rows], key)

    with ThreadPoolExecutor(max(1, os.cpu_count() or 1)) as pool:
        list(pool.map(band, range(0, rgb.shape[0], rows)))
    return out
