"""RCAN (Zhang et al. 2018, arXiv:1807.02758) as the program's ``RCAN``
serves it: EDSR's layout (``edsr.py``) in one group with no group skips,
each block's second 3x3 output gated per channel by a squeeze-excite of
its spatial mean (1x1 to ``features // reduction``, ReLU, 1x1 back,
sigmoid) before the scaled add."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import edsr


def layers(spec: Dict, scale: int) -> List[Tuple[str, Tuple]]:
    f = int(spec["features"])
    r = f // int(spec["reduction"])
    return edsr.layers(spec, scale, [("conv0", f, f, 3, 3, "relu", 1),
                                     ("conv1", f, f, 3, 3, "bias", 1),
                                     ("att0", r, f, 1, 1, "bias", 0),
                                     ("att1", f, r, 1, 1, "bias", 0)])


def convs(spec: Dict, scale: int) -> List[Tuple]:
    return [shape for _k, shape in layers(spec, scale)]


def flops_per_pixel(spec: Dict, scale: int) -> float:
    """As ``edsr.conv_flops``: the gate's two 1x1 convolutions too are
    counted at the input's resolution, as the program's own count does."""
    return edsr.conv_flops(convs(spec, scale))


def init(spec: Dict, scale: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """EDSR's rule (``edsr.draw``) over RCAN's layers."""
    return edsr.draw(layers(spec, scale), generator)


def _gate(y, prefix, conv):
    g = y.mean(dim=(2, 3), keepdim=True)
    g = F.relu(conv(g, f"{prefix}.att0", 0))
    return y * torch.sigmoid(conv(g, f"{prefix}.att1", 0))


def forward(sd: Dict[str, torch.Tensor], spec: Dict, scale: int, x: torch.Tensor, ops):
    return edsr.forward(sd, spec, scale, x, ops, gate=_gate)
