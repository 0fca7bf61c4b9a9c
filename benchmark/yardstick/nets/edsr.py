"""EDSR (Lim et al. 2017, arXiv:1707.02921) as the program's ``EDSR``
serves it: a 3x3 head to ``features``; ``blocks`` residual blocks (3x3,
ReLU, 3x3, scaled by ``res_scale`` and added); a 3x3 body convolution plus
the head's output; a 3x3 up convolution and pixel shuffle for every {2, 3}
factor of the scale but the last; a 3x3 tail to ``channels * f**2`` and
the last shuffle. The output is the tail's residual on a bicubic upsample
of the input. ``rcan.py`` runs the same layout with a gated block."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import factors
from ..reference import resize

# The last convolution's share of a He-uniform draw in ``draw``: with the body's
# activations of order 1, it keeps the residual to a few LSB of 255.
TAIL_GAIN = 0.005


def bicubic_residual(x: torch.Tensor, scale: int,
                     body: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """bicubic(x) + 255 * shuffle(body((x / 255 - 0.5) as NCHW)), NHWC in
    and out: the global skip of every bicubic-residual kind."""
    base = resize(x, x.shape[1] * scale, x.shape[2] * scale)
    r = body((x / 255.0 - 0.5).permute(0, 3, 1, 2))
    r = F.pixel_shuffle(r, factors(scale)[-1])
    return base + r.permute(0, 2, 3, 1) * 255.0


def layers(spec: Dict, scale: int, block: Optional[List[Tuple]] = None) -> List[Tuple[str, Tuple]]:
    """[(parameter prefix, (cout, cin, kh, kw, form, area))] in launch
    order; ``block`` is one residual block's convolutions as (name, cout,
    cin, kh, kw, form, area), EDSR's by default."""
    c, f, n = int(spec.get("channels", 3)), int(spec["features"]), int(spec["blocks"])
    fs = factors(scale)
    block = block or [("conv0", f, f, 3, 3, "relu", 1), ("conv1", f, f, 3, 3, "residual", 1)]
    out = [("head", (f, c, 3, 3, "bias", 1))]
    for i in range(n):
        out += [(f"blocks.{i}.{name}", shape) for name, *shape in block]
    out.append(("body_out", (f, f, 3, 3, "residual", 1)))
    area = 1
    for i, g in enumerate(fs[:-1]):
        out.append((f"up_convs.{i}", (f * g * g, f, 3, 3, "bias", area)))
        area *= g * g
    out.append(("tail", (c * fs[-1] ** 2, f, 3, 3, "bias", area)))
    return [(k, tuple(s)) for k, s in out]


def convs(spec: Dict, scale: int) -> List[Tuple]:
    return [shape for _k, shape in layers(spec, scale)]


def conv_flops(table: List[Tuple]) -> float:
    """2 * kh * kw * cin * cout summed over ``table``'s convolutions, each
    counted at the input's resolution, as the program's own count does."""
    return float(sum(2 * co * ci * kh * kw for co, ci, kh, kw, _f, _a in table))


def flops_per_pixel(spec: Dict, scale: int) -> float:
    return conv_flops(convs(spec, scale))


def draw(table: List[Tuple[str, Tuple]], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """He-uniform weights (bound sqrt(6 / fan_in)), zero biases, and the
    last convolution's weights (the residual's) times ``TAIL_GAIN``, so
    the residual stays a few LSB and the output is not clipped wholesale
    to 0 or 255; drawn in ``table``'s order (``layers``) from
    ``generator``."""
    sd = {}
    for i, (key, (co, ci, kh, kw, _form, _area)) in enumerate(table):
        bound = math.sqrt(6.0 / (ci * kh * kw))
        w = (torch.rand((co, ci, kh, kw), generator=generator) * 2.0 - 1.0) * bound
        sd[f"{key}.weight"] = w * TAIL_GAIN if i == len(table) - 1 else w
        sd[f"{key}.bias"] = torch.zeros(co)
    return sd


def init(spec: Dict, scale: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    return draw(layers(spec, scale), generator)


def forward(sd: Dict[str, torch.Tensor], spec: Dict, scale: int, x: torch.Tensor, ops,
            gate: Optional[Callable] = None) -> torch.Tensor:
    """``gate(y, prefix, conv)``, where given, gates each block's output
    before its scaled add (RCAN's channel attention)."""
    fs = factors(scale)
    res_scale = float(spec.get("res_scale", 0.1))

    def conv(h, key, pad):
        return ops.conv(h, sd[f"{key}.weight"], sd[f"{key}.bias"], pad)

    def body(h):
        h0 = conv(h, "head", 1)
        h = h0
        for i in range(int(spec["blocks"])):
            y = conv(F.relu(conv(h, f"blocks.{i}.conv0", 1)), f"blocks.{i}.conv1", 1)
            if gate is not None:
                y = gate(y, f"blocks.{i}", conv)
            h = h + y * res_scale
        h = conv(h, "body_out", 1) + h0
        for i, f in enumerate(fs[:-1]):
            h = F.pixel_shuffle(conv(h, f"up_convs.{i}", 1), f)
        return conv(h, "tail", 1)

    return bicubic_residual(x, scale, body)
