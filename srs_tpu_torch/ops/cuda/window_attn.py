"""HAT's window attention (Chen et al. 2023, arXiv:2205.04437; XPixelGroup/HAT
``hat_arch.py``): one kernel for every window and head of a hybrid
attention block (HAB) or an overlapping cross-attention block (OCAB) over
a whole batch, and its plain version.

It replaces no TPU kernel: the JAX package has no HAT. Held whole, the
scores do not fit the card (a 1536^2 map has 9216 windows of 16^2: 14.5
GB of float32 scores per HAB, 32.6 GB per OCAB), and HAT's own code
copies the map three more times (the cyclic roll, the window partition,
``nn.Unfold``'s 24^2 key windows) and holds a [windows, 256, 256] mask.
The kernel (CUDA C++ for ``sm_90a`` in ``csrc/window_attn.cu``, built with
``nvcc`` the first time a HAT net is built on a card and bound with
``ctypes``) reads q, k and v straight from the qkv projection's output in
token layout and writes each query's result at its own token, so the
partition, the shift and its reverse, and the overlapping key windows are
index arithmetic. For every (window, head):

    out = softmax(q . k^T * d^-1/2 + B + M) . v

- q, k, v: head ``h``'s ``d = C / heads`` channels of the projection's
  [q | k | v] thirds. A HAB window is ``window``^2 tokens of the map
  rolled by ``-shift`` (HAT's ``torch.roll``); its keys are its queries.
  An OCAB query window is ``window``^2 tokens of the unrolled map, its
  keys the (``window`` + ``overlap``)^2 tokens around it
  (``nn.Unfold`` with padding ``overlap / 2``): a key outside the map is
  a zero vector, so its score is the bias alone and its value zero, as
  the unfold's zero padding of the projected k and v gives.
- ``B``: the ``[T, heads]`` bias table gathered by HAT's relative position
  index (``calculate_rpi_sa``, ``calculate_rpi_oca``; the OCAB index as
  HAT computes it, wrapping below 0 as PyTorch's indexing does).
- ``M``: HAT's shift mask (``calculate_mask``), -100 where the query's and
  the key's regions of the rolled map differ; 0 without a shift.

Products in the input's type (bfloat16 on the card) with float32
accumulation; scores and softmax in float32; the output rounded to the
input's type. :func:`window_attn` launches the kernel on a CUDA input
with autograd off and runs :func:`window_attn_plain` (the same arithmetic
in torch ops, over blocks of windows) on the CPU and under autograd. One
helper counts each call, on both routes: the job's
``window_attn.launches`` (kernel) or ``window_attn.plain``, with
``window_attn.flop`` (4 * queries * keys * d per head: the two products)
and ``window_attn.bytes`` (q, k, v and the output once each, in
bfloat16), which :func:`attention_work` gives for a call's shape.
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

__all__ = ["LAUNCHES", "reset_launches", "window_attn", "window_attn_plain", "attention_work",
           "rpi_sa", "rpi_oca", "load_library"]

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "window_attn.cu")
# HAT's value for a masked pair (``calculate_mask``).
MASK_VALUE = -100.0
# Bytes of a value of q, k, v and the output as the counters count them.
_COUNT_BYTES = 2
# Scores the plain route holds at once, in float32 values.
_PLAIN_SCORES = 1 << 27

# Kernel launches since the last reset; the plain version never counts.
LAUNCHES: Dict[str, int] = {"window_attn": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["window_attn"] = 0


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            compiler = nvcc()
            path = build_shared(
                "srs_window_attn", [SOURCE],
                lambda out: [compiler, *NVCC_FLAGS, "-o", out, SOURCE],
            )
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.srs_window_attn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
                                            ctypes.c_float, ptr]
            lib.srs_window_attn.restype = i32
            _lib = lib
    return _lib


def attention_work(batch: int, h: int, w: int, channels: int, heads: int, window: int,
                   overlap: int = 0) -> Tuple[float, float]:
    """(FLOP, bytes) of one call on a [batch, h, w, 3 * channels] map: the
    two products, 2 * queries * keys * d each per head, and q, k, v and
    the output read or written once each in bfloat16."""
    tokens = batch * h * w
    keys = (window + overlap) ** 2
    return 4.0 * tokens * keys * channels, 4.0 * tokens * channels * _COUNT_BYTES


def _record(fused: bool, work: Tuple[float, float]) -> None:
    if fused:
        with _count_lock:
            LAUNCHES["window_attn"] += 1
    profiling.count("window_attn.launches" if fused else "window_attn.plain")
    profiling.count("window_attn.flop", work[0])
    profiling.count("window_attn.bytes", work[1])


# -- HAT's index arithmetic -------------------------------------------------------

@lru_cache(maxsize=None)
def rpi_sa(window: int) -> torch.Tensor:
    """HAT's ``calculate_rpi_sa``: [window^2, window^2] indices into the
    (2 * window - 1)^2 table, query by key."""
    c = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                   indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


@lru_cache(maxsize=None)
def rpi_oca(window: int, overlap: int) -> torch.Tensor:
    """HAT's ``calculate_rpi_oca``: [window^2, ext^2] indices into the
    (window + ext - 1)^2 table, ext = window + overlap, query by key; the
    values below 0 that HAT's formula gives are wrapped as its indexing
    wraps them."""
    ext = window + overlap
    ori = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                     indexing="ij")).flatten(1)
    ex = torch.stack(torch.meshgrid(torch.arange(ext), torch.arange(ext),
                                    indexing="ij")).flatten(1)
    rel = (ex[:, None, :] - ori[:, :, None]).permute(1, 2, 0) + (window - ext + 1)
    idx = rel[..., 0] * (window + ext - 1) + rel[..., 1]
    return idx % ((window + ext - 1) ** 2)


def _region_ids(n: int, window: int, shift: int) -> torch.Tensor:
    """HAT's ``calculate_mask`` regions along one side of ``n`` rolled
    tokens: 0 before ``n - window``, 1 before ``n - shift``, 2 after."""
    i = torch.arange(n)
    return (i >= n - window).long() + (i >= n - shift).long()


@lru_cache(maxsize=16)
def _plan(h: int, w: int, window: int, shift: int, overlap: int):
    """(query tokens [nW, nq], key tokens [nW, nk] with -1 outside the map,
    each query's region of the rolled map [nW, nq] for the shift mask, or
    None) of one map, windows in row-major order, tokens as flat indices
    of the unrolled map."""
    ny, nx = h // window, w // window
    t = torch.arange(window)
    ys = (torch.arange(ny)[:, None] * window + t[None, :])  # rolled rows [ny, window]
    xs = (torch.arange(nx)[:, None] * window + t[None, :])
    qy = (ys + shift) % h
    qx = (xs + shift) % w
    q = (qy[:, None, :, None] * w + qx[None, :, None, :]).reshape(ny * nx, window * window)
    if overlap == 0:
        regions = None
        if shift > 0:
            ry, rx = _region_ids(h, window, shift)[ys], _region_ids(w, window, shift)[xs]
            regions = (ry[:, None, :, None] * 3 + rx[None, :, None, :]).reshape(ny * nx, -1)
        return q, q, regions
    ext, pad = window + overlap, overlap // 2
    e = torch.arange(ext)
    ky = torch.arange(ny)[:, None] * window - pad + e[None, :]
    kx = torch.arange(nx)[:, None] * window - pad + e[None, :]
    inside = ((ky[:, None, :, None] >= 0) & (ky[:, None, :, None] < h)
              & (kx[None, :, None, :] >= 0) & (kx[None, :, None, :] < w))
    k = torch.where(inside, ky[:, None, :, None] * w + kx[None, :, None, :], -1)
    return q, k.reshape(ny * nx, ext * ext), None


def window_attn_plain(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                      shift: int = 0, overlap: int = 0) -> torch.Tensor:
    """The attention in torch ops, on any device and under autograd: q, k
    and v gathered by the kernel's indices, block by block of windows,
    products of the input's values in float32, the softmax in float32,
    the output scattered back to each query's token in the input's type."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = d ** -0.5  # HAT's qk_scale
    q_idx, k_idx, regions = (t.to(qkv.device) if t is not None else None
                             for t in _plan(h, w, window, shift, overlap))
    rpi = rpi_oca(window, overlap) if overlap else rpi_sa(window)
    bias = table.float()[rpi.to(qkv.device).reshape(-1)].reshape(*rpi.shape, heads)
    bias = bias.permute(2, 0, 1)  # [heads, nq, nk]
    nw, nq, nk = q_idx.shape[0], q_idx.shape[1], k_idx.shape[1]
    valid = (k_idx >= 0)
    k_safe = k_idx.clamp(min=0)
    flat = qkv.reshape(b, h * w, 3, heads, d)
    # every token is one window's query once: the windows' outputs in
    # window order, put back at their tokens by the inverse permutation
    back = torch.argsort(q_idx.reshape(-1))
    step = max(1, _PLAIN_SCORES // (heads * nq * nk))
    out = []
    for bi in range(b):
        blocks = []
        for w0 in range(0, nw, step):
            qi, ki = q_idx[w0:w0 + step], k_safe[w0:w0 + step]
            q = flat[bi, :, 0][qi].float().permute(0, 2, 1, 3)  # [n, heads, nq, d]
            keep = valid[w0:w0 + step, None, :, None].float()
            k = flat[bi, :, 1][ki].float().permute(0, 2, 1, 3) * keep
            v = flat[bi, :, 2][ki].float().permute(0, 2, 1, 3) * keep
            s = (q @ k.transpose(-2, -1)) * scale + bias
            if regions is not None:  # HAT's shift mask, from the regions of the window
                r = regions[w0:w0 + step]
                s = s + (r[:, None, :, None] != r[:, None, None, :]).float() * MASK_VALUE
            o = torch.softmax(s, dim=-1) @ v  # [n, heads, nq, d]
            blocks.append(o.permute(0, 2, 1, 3).reshape(-1, heads * d).to(qkv.dtype))
        out.append(torch.cat(blocks)[back])
    out = torch.stack(out)
    return out.reshape(b, h, w, c)


def _refusal(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int,
             overlap: int) -> Optional[str]:
    b, h, w, c3 = qkv.shape
    if not qkv.is_cuda or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        return f"a contiguous bfloat16 CUDA [B, H, W, 3C], got {qkv.dtype} on {qkv.device}"
    if c3 % (3 * heads) or c3 // (3 * heads) > 30 or (c3 // (3 * heads)) % 2:
        return f"an even head width of at most 30, got {c3 // 3} channels over {heads} heads"
    if window != 16 or h % window or w % window:
        return f"windows of 16 that tile the map, got {window} on {h}x{w}"
    if overlap not in (0, 8) or shift not in (0, window // 2) or (overlap and shift):
        return f"a HAB shift of 0 or 8 or an OCAB overlap of 8, got {shift}, {overlap}"
    n_table = (2 * window - 1) ** 2 if not overlap else (2 * window + overlap - 1) ** 2
    if (table.device != qkv.device or table.dtype != torch.float32 or not table.is_contiguous()
            or tuple(table.shape) != (n_table, heads)):
        return f"a contiguous float32 [{n_table}, {heads}] bias table on {qkv.device}"
    if qkv.data_ptr() % 4:
        return "a 4-byte aligned input"
    return None


def window_attn(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                shift: int = 0, overlap: int = 0) -> torch.Tensor:
    """The attention of one HAB (``shift`` 0 or ``window / 2``) or OCAB
    (``overlap``) over ``qkv`` ([B, H, W, 3C], the qkv projection's output;
    H and W multiples of ``window``) with the ``[T, heads]`` bias
    ``table``: [B, H, W, C] in ``qkv``'s type. The kernel on a card with
    autograd off (it raises on what it does not take), else the plain
    route."""
    b, h, w, c3 = qkv.shape
    work = attention_work(b, h, w, c3 // 3, heads, window, overlap)
    if not (qkv.is_cuda and not torch.is_grad_enabled()):
        out = window_attn_plain(qkv, table, heads, window, shift, overlap)
        _record(False, work)
        return out
    reason = _refusal(qkv, table, heads, window, shift, overlap)
    if reason is not None:
        raise ValueError(f"window_attn takes {reason}")
    d = c3 // (3 * heads)
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.srs_window_attn(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w,
                                 heads, d, window, shift, overlap, d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn kernel launch failed: cudaError {rc}")
    _record(True, work)
    return out
