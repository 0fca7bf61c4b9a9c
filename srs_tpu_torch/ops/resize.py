"""Bicubic resize with cv2 INTER_CUBIC parity (port of the pieces of
``srs_tpu/ops/resize.py`` that the quality path runs).

- :func:`resize_bicubic_up`: integer-factor upscale, the base of every
  EDSR (``models/nets.py``);
- :func:`resize_bicubic`: any target size, upscale or downscale (the QA
  downsample comparison, ``qa/metrics.py``), on the same axis plans;
- :func:`resize_area_int`: cv2 ``INTER_AREA`` at an integer factor, a box
  mean (the SR-gain probe's degradation, ``models/routing.py``);
- :func:`_down_axis_int`, :func:`_band_matrix`, :func:`_w_block_plan`,
  :func:`_resize_w_blocked`: the banded W resize of the finalize stage
  (``ops/blend.py:_finalize_band``).

Keys cubic with a = -0.75, source coordinate ``(dst + 0.5) / scale - 0.5``,
replicate-clamped borders, and the last tap taken as ``1 - w0 - w1 - w2``
as cv2 does (reference resize.py:46). Tensors are (..., H, W, C) float32;
the W resize's band operators are plain matrix products (``torch.matmul``
in full float32, as the reference's ``Precision.HIGHEST``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["cubic_weights", "resize_bicubic", "resize_bicubic_up", "resize_area_int",
           "resize_bicubic_banded"]

_A = -0.75  # cv2's bicubic coefficient


def cubic_weights(f: np.ndarray) -> np.ndarray:
    """4 Keys-cubic taps (a=-0.75) for fractional offsets ``f`` in [0,1):
    (..., 4) weights for samples at floor-1, floor, floor+1, floor+2."""
    f = np.asarray(f, dtype=np.float64)
    a = _A
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    w2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    w3 = 1.0 - w0 - w1 - w2  # cv2 normalizes the last tap
    return np.stack([w0, w1, w2, w3], axis=-1).astype(np.float32)


@lru_cache(maxsize=64)
def _axis_plan(src_n: int, dst_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(idx (dst_n, 4) int32 clamped, w (dst_n, 4) f32) for one axis."""
    scale = src_n / dst_n
    dst = np.arange(dst_n, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    w = cubic_weights(src - base)
    idx = base[:, None] + np.arange(-1, 3)[None, :]
    idx = np.clip(idx, 0, src_n - 1).astype(np.int32)
    return idx, w.astype(np.float32)


def _edge_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Replicate-pad ``axis`` by (lo, hi) samples."""
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def _strided(x: torch.Tensor, axis: int, start: int, count: int, stride: int):
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(start, start + (count - 1) * stride + 1, stride)
    return x[tuple(sl)]


def _down_axis_int(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Integer-factor bicubic decimation: one polyphase phase, 4 taps."""
    n = x.shape[axis]
    m = n // s
    off = (s - 1) / 2.0
    base = int(np.floor(off))
    w = cubic_weights(np.array([off - base]))[0]
    xp = _edge_pad(x, axis, 1, 2)
    acc = None
    for t in range(4):
        term = _strided(xp, axis, base + t, m, s) * float(w[t])
        acc = term if acc is None else acc + term
    return acc


def _resize_axis(x: torch.Tensor, axis: int, dst_n: int) -> torch.Tensor:
    """One axis to ``dst_n`` samples: identity, integer decimation, or a
    4-tap gather weighted by the axis plan (reference resize.py:102-115)."""
    src_n = x.shape[axis]
    if src_n == dst_n:
        return x
    if src_n % dst_n == 0:
        return _down_axis_int(x, axis, src_n // dst_n)
    idx, w = _axis_plan(src_n, dst_n)
    taps = x.index_select(axis, torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(x.device))
    shape = list(x.shape)
    shape[axis : axis + 1] = [dst_n, 4]
    taps = taps.reshape(shape)
    wshape = [1] * len(shape)
    wshape[axis], wshape[axis + 1] = dst_n, 4
    return (taps * torch.from_numpy(w).to(x.device).reshape(wshape)).sum(dim=axis + 1)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., out_h, out_w, C), cv2 INTER_CUBIC
    parity (no antialias on downscale, as cv2)."""
    ah, aw = x.dim() - 3, x.dim() - 2
    return _resize_axis(_resize_axis(x, ah, out_h), aw, out_w)


def resize_area_int(x: torch.Tensor, s: int) -> torch.Tensor:
    """cv2 INTER_AREA by an integer factor ``s`` on (..., H, W, C) whose H
    and W are multiples of ``s``: the mean of each s x s box."""
    *lead, h, w, c = x.shape
    if h % s or w % s:
        raise ValueError(f"resize_area_int: {h}x{w} is not divisible by {s}")
    return x.reshape(*lead, h // s, s, w // s, s, c).mean(dim=(-4, -2))


@lru_cache(maxsize=16)
def _up_phases(scale: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phase (offset (scale,) int, weights (scale, 4) f32)."""
    p = np.arange(scale, dtype=np.float64)
    src = (p + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)  # -1 or 0
    return base.astype(np.int32), cubic_weights(src - base)


def _interleave(parts: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    """``out[..., s*i + p, ...] = parts[p][..., i, ...]`` along ``axis``."""
    if len(parts) == 1:
        return parts[0]
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return torch.stack(list(parts), dim=axis + 1).reshape(shape)


def _up_axis(x: torch.Tensor, axis: int, scale: int) -> torch.Tensor:
    n = x.shape[axis]
    base, w = _up_phases(scale)
    xp = _edge_pad(x, axis, 2, 2)
    phases = []
    for p in range(scale):
        acc = None
        for t in range(4):
            term = xp.narrow(axis, 2 + int(base[p]) + t - 1, n) * float(w[p, t])
            acc = term if acc is None else acc + term
        phases.append(acc)
    return _interleave(phases, axis)


def resize_bicubic_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor bicubic upscale of (..., H, W, C), cv2 parity."""
    if scale == 1:
        return x
    return _up_axis(_up_axis(x, x.dim() - 3, scale), x.dim() - 2, scale)


def _band_matrix(idx: np.ndarray, w: np.ndarray, src_n: int) -> np.ndarray:
    """Dense [out, src_n] resize operator from a 4-tap plan."""
    out = idx.shape[0]
    r = np.zeros((out, src_n), np.float32)
    for t in range(4):
        r[np.arange(out), idx[:, t]] += w[:, t]
    return r


@lru_cache(maxsize=32)
def _w_block_plan(src_n: int, dst_n: int, block: int = 2048):
    """Column-blocked resize operators: (starts, src_b, out_b, R [nb, src_b, out_b])."""
    idx, w = _axis_plan(src_n, dst_n)
    nb = -(-dst_n // block)
    spans = []
    for b in range(nb):
        rows = idx[b * block : min((b + 1) * block, dst_n)]
        spans.append((int(rows.min()), int(rows.max()) + 1))
    src_b = min(max(hi - lo for lo, hi in spans), src_n)
    starts = []
    mats = np.zeros((nb, src_b, block), np.float32)
    for b in range(nb):
        o0, o1 = b * block, min((b + 1) * block, dst_n)
        start = min(spans[b][0], src_n - src_b)
        starts.append(start)
        mats[b, :, : o1 - o0] = _band_matrix(idx[o0:o1] - start, w[o0:o1], src_b).T
    return tuple(starts), src_b, block, mats


def _resize_w_blocked(x: torch.Tensor, dst_n: int, mats: torch.Tensor, starts,
                      src_b: int) -> torch.Tensor:
    """W-axis resize of (H, W, C) as one matrix product per column block."""
    outs = []
    for b, start in enumerate(starts):
        src = x[:, start : start + src_b, :].transpose(1, 2)  # [H, C, src_b]
        outs.append(torch.matmul(src, mats[b]).transpose(1, 2))  # [H, out_b, C]
    return torch.cat(outs, dim=1)[:, :dst_n]


def resize_bicubic_banded(
    x: torch.Tensor,
    out_h: int,
    out_w: int,
    bands: int = 8,
    crop_h: Optional[int] = None,
    crop_w: Optional[int] = None,
    to_uint8=False,
    as_iterator: bool = False,
    as_device: bool = False,
):
    """The print-grade resize (reference ops/resize.py:262): (H, W, C) to
    an (out_h, out_w, C) numpy array in uniform output row bands, with
    the optional crop, clip and quantize (``to_uint8``: True or
    "uint16"), as :func:`resize_bicubic` resizes. It is the banded
    finalize with no coarse level (``ops.blend.blend_finalize_banded``),
    and returns what that returns: an array, an iterator of bands, or
    with ``as_device`` one tensor on ``x``'s device (int32 for
    "uint16")."""
    from .blend import blend_finalize_banded  # blend imports this module

    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return blend_finalize_banded(x.float(), None, out_h, out_w, bands=bands, crop_h=crop_h,
                                 crop_w=crop_w, to_uint8=to_uint8, as_iterator=as_iterator,
                                 as_device=as_device)
