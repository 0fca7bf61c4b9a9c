"""Gaussian / Laplacian pyramids with OpenCV parity (port of
``srs_tpu/ops/pyramid.py:115-177``).

``pyr_down`` and ``pyr_up`` launch the hand-written kernels K1/K2 on a
CUDA tensor and run their plain versions on a CPU tensor
(``ops/cuda/pyramid.py``). Tensors are (..., H, W, C).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .cuda.pyramid import pyr_down, pyr_up

__all__ = [
    "pyr_down",
    "pyr_up",
    "build_gaussian_pyramid",
    "build_laplacian_pyramid",
    "collapse_laplacian_pyramid",
]


def build_gaussian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[G0..G_{L-1}], stopping early when a level would drop below 2 px."""
    pyr = [x]
    for _ in range(levels - 1):
        h, w = pyr[-1].shape[-3], pyr[-1].shape[-2]
        if min(h, w) < 2 or min((h + 1) // 2, (w + 1) // 2) < 2:
            break
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def build_laplacian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[L0..L_{n-2}, G_{n-1}] with L_i = G_i - pyrUp(G_{i+1}, size(G_i))."""
    gauss = build_gaussian_pyramid(x, levels)
    lap = []
    for i in range(len(gauss) - 1):
        hi, wi = gauss[i].shape[-3], gauss[i].shape[-2]
        lap.append(gauss[i] - pyr_up(gauss[i + 1], (hi, wi)))
    lap.append(gauss[-1])
    return lap


def collapse_laplacian_pyramid(lap: Sequence[torch.Tensor]) -> torch.Tensor:
    """G_i = L_i + pyrUp(G_{i+1}) from coarsest to finest."""
    x = lap[-1]
    for i in range(len(lap) - 2, -1, -1):
        hi, wi = lap[i].shape[-3], lap[i].shape[-2]
        x = lap[i] + pyr_up(x, (hi, wi))
    return x
