"""Convolution FLOP of the SR nets, from the widths a configuration file
states: ``2 * sum(kh * kw * cin * cout)`` per input pixel of a pass (a
multiply-add is 2 FLOP), the same work whatever implements it. Biases,
the bicubic base, the blend and the resizes move bytes, not tensor-core
work, and are left out."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _factors(scale: int) -> List[int]:
    """{2, 3} pixel-shuffle stages of ``scale`` (4 -> 2, 2)."""
    out, s = [], int(scale)
    while s % 2 == 0 and s > 1:
        out.append(2)
        s //= 2
    while s % 3 == 0 and s > 1:
        out.append(3)
        s //= 3
    if s != 1:
        raise ValueError(f"scale {scale} is not made of 2s and 3s")
    return out


def conv_shapes(spec: Dict, scale: int) -> List[Tuple[int, int, int, int]]:
    """(cout, cin, kh, kw) of every convolution of the net ``spec`` (a
    configuration file's ``nets`` entry) at ``scale``."""
    kind, c = spec["kind"], int(spec.get("channels", 3))
    factors = _factors(scale) if scale > 1 else []
    last = c * factors[-1] ** 2 if factors else c
    if kind == "espcn":
        f = int(spec["features"])
        half = f // 2
        convs = [(f, c, 5, 5), (half, f, 3, 3)]
        convs += [(half * g * g, half, 3, 3) for g in factors[:-1]]
        return convs + [(last, half, 3, 3)]
    if kind in ("edsr", "rcan"):
        f, n = int(spec["features"]), int(spec["blocks"])
        convs = [(f, c, 3, 3)]
        for _ in range(n):
            convs += [(f, f, 3, 3), (f, f, 3, 3)]
            if kind == "rcan":
                r = f // int(spec["reduction"])
                convs += [(r, f, 1, 1), (f, r, 1, 1)]
        convs.append((f, f, 3, 3))
        convs += [(f * g * g, f, 3, 3) for g in factors[:-1]]
        return convs + [(last, f, 3, 3)]
    raise ValueError(f"unknown net kind {kind!r}")


def flops_per_pixel(spec: Dict, scale: int) -> float:
    return float(sum(2 * co * ci * kh * kw for co, ci, kh, kw in conv_shapes(spec, scale)))


def image_flops(config: Dict) -> float:
    """SR FLOP of one image of ``config``: per ladder step, each member
    net times its passes, over the tile batch at that step's input
    resolution (``route.block`` times the scales before it)."""
    route, nets = config["route"], config["nets"]
    res, total = int(route["block"]), 0.0
    for scale, members in zip(route["ladder"], route["steps"]):
        px = res * res * int(route["tiles"])
        for name, passes in members:
            total += int(passes) * flops_per_pixel(nets[name], int(scale)) * px
        res *= int(scale)
    return total
