"""K1/K2: the pyramid kernels, their plain versions and launch counts.

Replaces the Pallas TPU kernels of ``srs_tpu/ops/pallas/pyramid_pallas.py``:

- K1 ``pyr_down`` <- ``pyr_down_pallas`` (pyramid_pallas.py:70-93);
- K2 ``pyr_up``   <- ``pyr_up_pallas``   (pyramid_pallas.py:118-141).

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/pyramid.cu``, built with
``nvcc`` into a shared library with a plain C interface at first use and
bound with ``ctypes`` (no PyTorch headers, no ninja); ``ptxas -v``'s
registers and spills per kernel stay beside it in ``<library>.log``. Both
are bound by
memory: the least time is the bytes of one read of the input and one
write of the output over the card's memory rate (K1 at level 0 of the
main path moves 1.91 GB, 0.57 ms at 3.35 TB/s).

Each wrapper takes NHWC float tensors with any leading dimensions:

- a CUDA tensor launches the kernel on the current stream, adds one to
  ``LAUNCHES[name]`` (under a lock: ``process_batch`` launches from
  several threads), or raises;
- a CPU tensor runs the plain PyTorch version (``pyr_down_plain``,
  ``pyr_up_plain``), the port of the XLA path in
  ``srs_tpu/ops/pyramid.py`` (``_pyr_down_xla`` / ``_pyr_up_xla``). The
  CPU tests use it, and ``chip_smoke.py`` holds the kernels against it on
  the card.

On either path a wrapper adds ``<name>.bytes`` (one read of the input
and one write of the output, float32) to the current job's record
(``utils/profiling.count``); its launches are ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from ...utils import profiling
from ...utils.build import NVCC_FLAGS, PACKAGE_DIR, build_shared, nvcc

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "pyr_down",
    "pyr_up",
    "pyr_down_plain",
    "pyr_up_plain",
    "load_library",
]

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "pyramid.cu")

# Kernel launches since the last reset, by wrapper name. Only a launch of
# the CUDA kernel counts; the plain versions never do.
LAUNCHES: Dict[str, int] = {"pyr_down": 0, "pyr_up": 0}

_G = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _record(name: str, x: torch.Tensor, out: torch.Tensor, launched: bool) -> torch.Tensor:
    """Count a ``launched`` kernel in ``LAUNCHES``, and the call's bytes in
    the current job's record; returns ``out``."""
    if launched:
        with _count_lock:
            LAUNCHES[name] += 1
    profiling.count(f"{name}.bytes", 4 * (x.numel() + out.numel()))
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            compiler = nvcc()
            path = build_shared(
                "srs_pyramid", [SOURCE],
                lambda out: [compiler, *NVCC_FLAGS, "-o", out, SOURCE],
            )
            lib = ctypes.CDLL(path)
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.srs_pyr_down_f32.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr]
            lib.srs_pyr_down_f32.restype = ctypes.c_int
            lib.srs_pyr_up_f32.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, i64, ptr]
            lib.srs_pyr_up_f32.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- plain PyTorch versions (port of srs_tpu/ops/pyramid.py:_down_axis,
#    _up_axis) ---------------------------------------------------------------


def _reflect101(j: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    j = abs(j) % period
    return period - j if j >= n else j


@lru_cache(maxsize=256)
def _down_taps(n: int) -> Tuple[Tuple[int, ...], ...]:
    """Source indices of the 5 taps of every output sample (REFLECT_101)."""
    m = (n + 1) // 2
    return tuple(
        tuple(_reflect101(2 * i + k - 2, n) for i in range(m)) for k in range(5)
    )


def _down_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    acc = None
    for k, idx in enumerate(_down_taps(x.shape[axis])):
        s = x.index_select(axis, torch.tensor(idx, device=x.device))
        acc = s * _G[k] if acc is None else acc + s * _G[k]
    return acc


def _up_axis(x: torch.Tensor, axis: int, out_n: int) -> torch.Tensor:
    n = x.shape[axis]
    if not (2 * n - 2 <= out_n <= 2 * n):
        raise ValueError(f"pyr_up dst size {out_n} incompatible with src {n}")
    left_idx = [1 if n > 1 else 0] + list(range(n - 1))  # src[-1] = src[1]
    right_idx = list(range(1, n)) + [n - 1]  # src[n] = src[n-1]
    left = x.index_select(axis, torch.tensor(left_idx, device=x.device))
    right = x.index_select(axis, torch.tensor(right_idx, device=x.device))
    even = (left + 6.0 * x + right) * 0.125
    odd = (x + right) * 0.5
    shape = list(x.shape)
    shape[axis] = 2 * n
    out = torch.stack([even, odd], dim=axis + 1).reshape(shape)
    return out.narrow(axis, 0, out_n)


def pyr_down_plain(x: torch.Tensor) -> torch.Tensor:
    """cv2-parity pyrDown on (..., H, W, C): H pass, then W pass."""
    x = x.float()
    return _down_axis(_down_axis(x, x.dim() - 3), x.dim() - 2)


def pyr_up_plain(x: torch.Tensor, dst_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """cv2-parity pyrUp on (..., H, W, C) to ``dst_hw`` (default 2x)."""
    x = x.float()
    h, w = x.shape[-3], x.shape[-2]
    th, tw = dst_hw if dst_hw is not None else (2 * h, 2 * w)
    return _up_axis(_up_axis(x, x.dim() - 3, th), x.dim() - 2, tw)


# -- wrappers -----------------------------------------------------------------


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) float32 contiguous as [N, H, W, C]."""
    if x.dim() < 3:
        raise ValueError(f"expected (..., H, W, C), got shape {tuple(x.shape)}")
    x = x.float().contiguous()
    return x.reshape(-1, *x.shape[-3:])


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _device_kind(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"pyramid ops take CPU or CUDA tensors, got {x.device}")


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """pyrDown on (..., H, W, C): K1 on a CUDA tensor, plain on the CPU."""
    if _device_kind(x) == "cpu":
        return _record("pyr_down", x, pyr_down_plain(x), launched=False)
    lib = load_library()
    p = _planes(x)
    n, h, w, c = p.shape
    out = torch.empty((n, (h + 1) // 2, (w + 1) // 2, c), device=p.device,
                      dtype=torch.float32)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _check(lib.srs_pyr_down_f32(p.data_ptr(), out.data_ptr(), n, h, w, c,
                                    stream), "pyr_down")
    return _record("pyr_down", x, out.reshape(*x.shape[:-3], *out.shape[1:]), launched=True)


def pyr_up(x: torch.Tensor, dst_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """pyrUp on (..., H, W, C) to ``dst_hw``: K2 on a CUDA tensor, plain on
    the CPU."""
    if _device_kind(x) == "cpu":
        return _record("pyr_up", x, pyr_up_plain(x, dst_hw), launched=False)
    lib = load_library()
    p = _planes(x)
    n, mh, mw, c = p.shape
    nh, nw = dst_hw if dst_hw is not None else (2 * mh, 2 * mw)
    if not (2 * mh - 2 <= nh <= 2 * mh and 2 * mw - 2 <= nw <= 2 * mw):
        raise ValueError(f"pyr_up dst size {(nh, nw)} incompatible with src {(mh, mw)}")
    out = torch.empty((n, nh, nw, c), device=p.device, dtype=torch.float32)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _check(lib.srs_pyr_up_f32(p.data_ptr(), out.data_ptr(), n, mh, mw, nh, nw,
                                  c, stream), "pyr_up")
    return _record("pyr_up", x, out.reshape(*x.shape[:-3], *out.shape[1:]), launched=True)
