"""Bytes and FLOP of the pyramid kernels K1 (pyrDown) and K2 (pyrUp)
from their launch shapes, and a recorder of those shapes (frozen copies
of ``chip_smoke.py``'s ``pyr_down_work``, ``pyr_up_work`` and
``pyramid_calls``)."""

from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Callable, Dict, List

import numpy as np

# The program's modules that call pyrDown/pyrUp by name, and the names.
CALL_SITES = (("ops.pyramid", "pyr_down"), ("ops.pyramid", "pyr_up"),
              ("ops.blend", "pyr_down"), ("ops.blend", "pyr_up"),
              ("parallel.halo", "pyr_up"))
# Device kernel name prefixes in a profiler trace.
KERNELS = {"pyr_down": "pyr_down_kernel", "pyr_up": "pyr_up_kernel"}


def pyr_down_work(shape_in, shape_out) -> tuple:
    """Bytes (one read of the input, one write of the output) and FLOP of
    K1: 9 FLOP per sample in each pass (5 multiplies, 4 adds), the
    vertical pass on [.., ceil(H/2), W, C], the horizontal on the output."""
    n_in, n_out = int(np.prod(shape_in)), int(np.prod(shape_out))
    n_vert = n_out // shape_out[-2] * shape_in[-2]
    return (n_in + n_out) * 4, 9 * (n_vert + n_out)


def pyr_up_work(shape_in, shape_out) -> tuple:
    """Bytes (one read of the input, one write of the output) and FLOP of
    K2: ~3 FLOP per sample in each pass (even: 4, odd: 2), the vertical
    pass on [.., n_h, m_w, C], the horizontal on the output."""
    n_in, n_out = int(np.prod(shape_in)), int(np.prod(shape_out))
    n_vert = n_out // shape_out[-2] * shape_in[-2]
    return (n_in + n_out) * 4, 3 * (n_vert + n_out)


WORK = {"pyr_down": pyr_down_work, "pyr_up": pyr_up_work}


@contextlib.contextmanager
def pyramid_calls(package: str, on_call: Callable):
    """While open, every pyrDown/pyrUp call that ``package``'s modules
    make by name runs as before and then calls ``on_call(name, input,
    output)``."""
    saved = []
    for mod_name, attr in CALL_SITES:
        mod = importlib.import_module(f"{package}.{mod_name}")
        saved.append((mod, attr, getattr(mod, attr)))
    originals = {attr: fn for _mod, attr, fn in saved}

    def down(x):
        out = originals["pyr_down"](x)
        on_call("pyr_down", x, out)
        return out

    def up(x, dst_hw=None):
        out = originals["pyr_up"](x, dst_hw)
        on_call("pyr_up", x, out)
        return out

    wrap = {"pyr_down": down, "pyr_up": up}
    for mod, attr, _fn in saved:
        setattr(mod, attr, wrap[attr])
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def recorded_shapes(package: str):
    """Yields {name: [[input shape, output shape], ...]} of every launch
    while open, in launch order (the batch's workers share it)."""
    shapes: Dict[str, List] = {"pyr_down": [], "pyr_up": []}
    lock = threading.Lock()

    def record(name, x, out):
        with lock:
            shapes[name].append([list(x.shape), list(out.shape)])

    with pyramid_calls(package, record):
        yield shapes


def bound_seconds(name: str, launches, bytes_per_s: float) -> float:
    """The least seconds the launches of kernel ``name`` could take: each
    launch's bytes over the memory rate (both kernels are bound by
    memory: their FLOP over the float32 rate is far smaller)."""
    return sum(WORK[name](a, b)[0] for a, b in launches) / bytes_per_s
