"""FLOP and byte counts of the SR nets, from the widths a configuration
file states, each net by its kind's module (``nets/<kind>.py``).

FLOP: each kind's ``flops_per_pixel``, the tensor-core work of one pass
per input pixel (``2 * kh * kw * cin * cout`` for a convolution, and the
products of any linear layer or attention), the same work whatever
implements it. Biases, the bicubic base, the blend and the resizes move
bytes, not tensor-core work, and are left out.

Bytes of the conv epilogue (the bias and the ReLU or scaled residual that
follow each convolution, ``nets.Conv2d``): each convolution's output in
the computation type, touched twice ("bias", "relu": read and written)
or three times ("residual": the skip read too), from each kind's
``convs``."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from . import nets

# Bytes of a value in the configuration's computation type.
VALUE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
# Touches of a convolution's output by its epilogue.
TOUCHES = {"bias": 2, "relu": 2, "residual": 3}


def conv_shapes(spec: Dict, scale: int) -> List[Tuple[int, int, int, int]]:
    """(cout, cin, kh, kw) of every convolution of the net ``spec`` (a
    configuration file's ``nets`` entry) at ``scale``."""
    return [tuple(c[:4]) for c in nets.load(spec["kind"]).convs(spec, int(scale))]


def flops_per_pixel(spec: Dict, scale: int) -> float:
    return float(nets.load(spec["kind"]).flops_per_pixel(spec, int(scale)))


def _passes(config: Dict) -> Iterator[Tuple[int, Dict, int, int]]:
    """(scale, net spec, passes, input pixels of the step's tile batch)
    for each member of each ladder step: ``route.tiles`` tiles of
    ``route.block`` times the scales before it."""
    route, specs = config["route"], config["nets"]
    res = int(route["block"])
    for scale, members in zip(route["ladder"], route["steps"]):
        for name, passes in members:
            yield int(scale), specs[name], int(passes), res * res * int(route["tiles"])
        res *= int(scale)


def image_flops(config: Dict) -> float:
    """SR FLOP of one image of ``config``: per ladder step, each member
    net times its passes, over the tile batch at that step's input
    resolution."""
    return sum(passes * flops_per_pixel(spec, scale) * px
               for scale, spec, passes, px in _passes(config))


def image_epilogue(config: Dict) -> Tuple[int, float]:
    """(launches, bytes) of the conv epilogue in one image of ``config``:
    one launch per convolution of every pass of every member, over the
    step's whole tile batch."""
    size = VALUE_BYTES[config["pipeline"].get("compute_dtype", "bfloat16")]
    launches, total = 0, 0.0
    for scale, spec, passes, px in _passes(config):
        for co, _ci, _kh, _kw, form, area in nets.load(spec["kind"]).convs(spec, scale):
            launches += passes
            total += passes * TOUCHES[form] * co * area * px * size
    return launches, total
