"""Separable filters with OpenCV parity (port of
``srs_tpu/ops/filters.py:31-160``).

1-D convolutions along an axis over REFLECT_101 borders, on tensors on
any device: ``gaussian_blur`` (cv2.GaussianBlur), ``box_blur``
(cv2.blur), ``sobel`` (cv2.Sobel, ksize 3) and ``laplacian``
(cv2.Laplacian, ksize 1), each over the last two (H, W) axes. Taps sum
in the reference's order, in float32. ``canny_edges`` is the
reference's approximation of cv2.Canny (commercial QA's oversharpening
score).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "gaussian_kernel1d",
    "gaussian_blur",
    "box_blur",
    "sobel",
    "laplacian",
    "sep_filter",
    "canny_edges",
]


@lru_cache(maxsize=32)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity for sigma > 0."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # cv2's default rule
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=256)
def _reflect_index(n: int, r: int) -> Tuple[int, ...]:
    """Source index of each of the n + 2r samples of an axis padded by r on
    both sides with REFLECT_101 (numpy's "reflect", folding as often as r
    needs)."""
    if n == 1:
        return (0,) * (n + 2 * r)
    period = 2 * (n - 1)
    out = []
    for j in range(-r, n + r):
        j = abs(j) % period
        out.append(period - j if j >= n else j)
    return tuple(out)


def _conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """1-D convolution along ``axis`` with REFLECT_101 padding."""
    r = len(taps) // 2
    n = x.shape[axis]
    idx = torch.tensor(_reflect_index(n, r), device=x.device)
    xp = x.index_select(axis, idx)
    acc = None
    for k, t in enumerate(taps):
        term = xp.narrow(axis, k, n) * float(np.float32(t))
        acc = term if acc is None else acc + term
    return acc


def sep_filter(x: torch.Tensor, taps_y: np.ndarray, taps_x: np.ndarray) -> torch.Tensor:
    """Separable 2-D filter over the last two (H, W) axes of (..., H, W)."""
    ah, aw = x.dim() - 2, x.dim() - 1
    return _conv_axis(_conv_axis(x, taps_y, ah), taps_x, aw)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur parity on (..., H, W) with BORDER_REFLECT_101."""
    k = gaussian_kernel1d(ksize, sigma)
    return sep_filter(x, k, k)


def box_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.blur parity (normalized box, REFLECT_101) on (..., H, W)."""
    k = np.full(ksize, 1.0 / ksize, np.float32)
    return sep_filter(x, k, k)


def sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.Sobel ksize=3 parity: (gx, gy) on (..., H, W)."""
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    ah, aw = x.dim() - 2, x.dim() - 1
    gx = _conv_axis(_conv_axis(x, s, ah), d, aw)
    gy = _conv_axis(_conv_axis(x, d, ah), s, aw)
    return gx, gy


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian ksize=1 parity: 4-neighbour kernel [[0,1,0],[1,-4,1],[0,1,0]]."""
    ah, aw = x.dim() - 2, x.dim() - 1
    k = np.array([1.0, -2.0, 1.0], np.float32)
    return _conv_axis(x, k, ah) + _conv_axis(x, k, aw)


def canny_edges(x: torch.Tensor, low: float = 50.0, high: float = 150.0,
                hysteresis_iters: int = 8) -> torch.Tensor:
    """The reference's Canny on (..., H, W) in [0, 255], as a {0, 1} float
    mask: Sobel L1 magnitude, non-maximum suppression in 4 direction bins,
    double threshold, then ``hysteresis_iters`` steps of 8-neighbour
    max-pool growth from strong into weak edges. Neighbours wrap around
    the borders (the reference's ``jnp.roll``)."""
    gx, gy = sobel(x)
    mag = gx.abs() + gy.abs()
    ax, ay = gx.abs(), gy.abs()
    horiz = ay <= ax * 0.4142135623730951  # tan 22.5 deg
    vert = ay >= ax * 2.414213562373095  # tan 67.5 deg
    same_sign = (gx * gy) >= 0

    def shift(a, dy, dx):
        return torch.roll(torch.roll(a, dy, dims=-2), dx, dims=-1)

    n1 = torch.where(horiz, shift(mag, 0, 1), torch.where(
        vert, shift(mag, 1, 0), torch.where(same_sign, shift(mag, 1, 1), shift(mag, 1, -1))))
    n2 = torch.where(horiz, shift(mag, 0, -1), torch.where(
        vert, shift(mag, -1, 0), torch.where(same_sign, shift(mag, -1, -1), shift(mag, -1, 1))))
    is_max = (mag >= n1) & (mag >= n2)
    strong = (is_max & (mag > high)).float()
    weak = (is_max & (mag > low)).float()

    def dilate(m):
        out = m
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    out = torch.maximum(out, shift(m, dy, dx))
        return out

    edges = strong
    for _ in range(hysteresis_iters):
        edges = torch.minimum(dilate(edges), weak)
    return torch.maximum(edges, strong)
