"""ESPCN (Shi et al. 2016, arXiv:1609.05158) as the program's ``ESPCN``
serves it: 5x5 to ``features``, ReLU, 3x3 to half of them, ReLU; a 3x3 up
convolution, pixel shuffle and ReLU for every {2, 3} factor of the scale
but the last; a 3x3 to ``channels * f**2`` and the last shuffle. The
output is that residual on a bicubic upsample of the input
(``edsr.bicubic_residual``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import edsr, factors


def layers(spec: Dict, scale: int) -> List[Tuple[str, Tuple]]:
    c, f = int(spec.get("channels", 3)), int(spec["features"])
    half = f // 2
    fs = factors(scale)
    out = [("conv_in", (f, c, 5, 5, "relu", 1)), ("conv_mid", (half, f, 3, 3, "relu", 1))]
    area = 1
    for i, g in enumerate(fs[:-1]):
        out.append((f"up_convs.{i}", (half * g * g, half, 3, 3, "bias", area)))
        area *= g * g
    out.append(("conv_out", (c * fs[-1] ** 2, half, 3, 3, "bias", area)))
    return out


def convs(spec: Dict, scale: int) -> List[Tuple]:
    return [shape for _k, shape in layers(spec, scale)]


def flops_per_pixel(spec: Dict, scale: int) -> float:
    return edsr.conv_flops(convs(spec, scale))


def init(spec: Dict, scale: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """EDSR's rule (``edsr.draw``) over ESPCN's layers."""
    return edsr.draw(layers(spec, scale), generator)


def forward(sd: Dict[str, torch.Tensor], spec: Dict, scale: int, x: torch.Tensor, ops):
    fs = factors(scale)

    def conv(h, key, pad):
        return ops.conv(h, sd[f"{key}.weight"], sd[f"{key}.bias"], pad)

    def body(h):
        h = F.relu(conv(F.relu(conv(h, "conv_in", 2)), "conv_mid", 1))
        for i, f in enumerate(fs[:-1]):
            h = F.relu(F.pixel_shuffle(conv(h, f"up_convs.{i}", 1), f))
        return conv(h, "conv_out", 1)

    return edsr.bicubic_residual(x, scale, body)
