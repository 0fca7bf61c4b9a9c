"""Laplacian canvas-pyramid blend and banded finalize (port of the profile
path of ``srs_tpu/ops/blend.py``).

Ported: ``laplacian_fusion_tiles`` (reference 273-344) with its level
clamp, ``_v2``, ``_build_gauss``, ``_accumulate_level_sep``,
``_collapse_step`` and ``_canvas_pyramid_blend_profiles`` (143-265), and
``_finalize_band`` / ``blend_finalize_banded`` (538-692), with
``as_device``.

The math is the reference's; the execution shape is the port's own. The
reference stages per-level programs, unrolls loops and caps chunks to fit
the TPU compiler; here each step is an eager op on the card. Every pyrDown
is kernel K1 and every pyrUp kernel K2 (``ops/cuda/pyramid.py``). The
vertical resize taps and the W resize are plain float32 matrix products
(``torch.matmul`` with TF32 off, as the reference's
``Precision.HIGHEST``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..tiling.geometry import TileLayout
from .pyramid import build_gaussian_pyramid, pyr_up
from .resize import _axis_plan, _band_matrix, _down_axis_int, _resize_w_blocked, _w_block_plan
from .weights import profile_pyramid

__all__ = ["laplacian_fusion_tiles", "blend_finalize_banded"]


@contextlib.contextmanager
def _full_fp32_matmul():
    """float32 matrix products without TF32, restoring the caller's flag."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _v2(n: int) -> int:
    """2-adic valuation (number of trailing zero bits); 64 for n == 0."""
    if n == 0:
        return 64
    v = 0
    while n % 2 == 0:
        n //= 2
        v += 1
    return v


def _clamp(start: int, size: int, extent: int) -> int:
    """``lax.dynamic_slice`` start clamping: the slice always fits."""
    return min(max(int(start), 0), extent - size)


def _accumulate_level_sep(
    g_i: torch.Tensor,
    g_next: Optional[torch.Tensor],
    wy: torch.Tensor,
    wx: torch.Tensor,
    pos: np.ndarray,
    ch: int,
    cw: int,
) -> torch.Tensor:
    """One canvas-pyramid level: Laplacian G_i - pyrUp(G_{i+1}) formed here
    (``g_next`` None at the coarsest level), weighted by outer(wy_t, wx_t),
    accumulated on the canvas and normalized."""
    n, tb_h, tb_w, c = g_i.shape
    lap = g_i if g_next is None else g_i - pyr_up(g_next, (tb_h, tb_w))
    num = torch.zeros((ch, cw, c), dtype=torch.float32, device=g_i.device)
    den = torch.zeros((ch, cw, 1), dtype=torch.float32, device=g_i.device)
    for t in range(n):
        w = wy[t][:, None, None] * wx[t][None, :, None]  # [h, w, 1]
        p0 = _clamp(pos[t, 0], tb_h, ch)
        p1 = _clamp(pos[t, 1], tb_w, cw)
        num[p0 : p0 + tb_h, p1 : p1 + tb_w] += lap[t] * w
        den[p0 : p0 + tb_h, p1 : p1 + tb_w] += w
    return num / torch.clamp(den, min=1e-8)


def _collapse_step(lap_i: torch.Tensor, coarser: torch.Tensor) -> torch.Tensor:
    return lap_i + pyr_up(coarser, (lap_i.shape[0], lap_i.shape[1]))


def _canvas_pyramid_blend_profiles(
    tiles: torch.Tensor,
    wy: np.ndarray,
    wx: np.ndarray,
    positions: np.ndarray,
    levels: int,
    padded_h: int,
    padded_w: int,
    collapse_last: bool = True,
):
    """Canvas-pyramid blend with separable weights. Returns the canvas, or
    ``(lap0, coarse)`` when ``collapse_last`` is False and there are two or
    more levels (the caller finishes level 0 banded)."""
    gauss = build_gaussian_pyramid(tiles.float(), levels)
    n_lv = len(gauss)
    py = profile_pyramid(wy, n_lv)
    px = profile_pyramid(wx, n_lv)
    dev = tiles.device
    canvas_lap = []
    ch, cw = padded_h, padded_w
    for i in range(n_lv):
        is_last = i == n_lv - 1
        canvas_lap.append(_accumulate_level_sep(
            gauss[i], None if is_last else gauss[i + 1],
            torch.from_numpy(py[i]).to(dev), torch.from_numpy(px[i]).to(dev),
            np.asarray(positions) // (2**i), ch, cw,
        ))
        gauss[i] = None  # consumed: frees the level before the next one
        ch, cw = (ch + 1) // 2, (cw + 1) // 2
    x = canvas_lap[-1]
    stop = 1 if not collapse_last and len(canvas_lap) > 1 else 0
    for i in range(len(canvas_lap) - 2, stop - 1, -1):
        x = _collapse_step(canvas_lap[i], x)
        canvas_lap[i] = None
    if stop:
        return canvas_lap[0], x
    return x


def laplacian_fusion_tiles(
    tiles: torch.Tensor,
    layout: TileLayout,
    weight_profiles: Tuple[np.ndarray, np.ndarray],
    levels: int = 6,
    clip_range: Optional[Tuple[float, float]] = (0.0, 255.0),
    collapse_last: bool = True,
):
    """Burt-Adelson canvas-pyramid blend of a [N, B, B, C] tile batch at
    ``layout``'s positions with separable weights ``weight_profiles=(wy,
    wx)`` ([N, B] each; the reference's dense-weight and per-tile modes are
    not ported).

    Levels are clamped so tile dyadic grids align with the canvas grid and
    the coarsest level's footprint stays inside the overlap band. With
    ``collapse_last=False`` returns ``(lap0, coarse)`` for
    :func:`blend_finalize_banded`, or the canvas when one level is left,
    unclipped either way.
    """
    if layout.num_tiles > 1:
        align = min(_v2(int(p)) for p in np.asarray(layout.positions).reshape(-1) if int(p) != 0)
        overlap_cap = max(1, int(np.log2(max(layout.overlap, 4))) - 1)
        levels = max(1, min(levels, align + 1, overlap_cap))
    wy, wx = weight_profiles
    canvas = _canvas_pyramid_blend_profiles(
        tiles, wy, wx, layout.positions, levels, layout.padded_h, layout.padded_w,
        collapse_last=collapse_last,
    )
    if not collapse_last:
        return canvas  # (lap0, coarse), or the unclipped canvas at one level
    if clip_range is not None:
        canvas = torch.clamp(canvas, clip_range[0], clip_range[1])
    return canvas


def _quantize(out: torch.Tensor, to_uint8) -> torch.Tensor:
    if to_uint8 == "uint16":
        return torch.clamp(torch.round(out * 257.0), 0, 65535).to(torch.int32)
    if to_uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def _finalize_band(
    lap0: torch.Tensor,
    coarse: Optional[torch.Tensor],
    lap_start: int,
    coarse_start: int,
    up_offset: int,
    r_h: torch.Tensor,
    band_src_h: int,
    band_coarse_h: int,
    out_w: int,
    w_plan,
    to_uint8,
) -> torch.Tensor:
    """One output band: collapse level 0 (lap0 + pyrUp(coarse)), vertical
    resize taps, horizontal resize, optional quantize."""
    s = _clamp(lap_start, band_src_h, lap0.shape[0])
    band = lap0[s : s + band_src_h]
    if coarse is not None:
        cs = _clamp(coarse_start, band_coarse_h, coarse.shape[0])
        coarse_band = coarse[cs : cs + band_coarse_h]
        # Upsample at the coarse level's full width, then cut to lap0's
        # (possibly cropped) width: cropping first would replace real
        # neighbor columns with border rules.
        up = pyr_up(coarse_band, (2 * band_coarse_h, 2 * coarse.shape[1]))
        uo = _clamp(up_offset, band_src_h, up.shape[0])
        band = band + up[uo : uo + band_src_h, : lap0.shape[1]]
    src_w, c = band.shape[1], band.shape[2]
    rows = torch.matmul(r_h, band.reshape(band_src_h, src_w * c))
    rows = rows.reshape(r_h.shape[0], src_w, c)
    if src_w == out_w:
        out = rows
    elif src_w % out_w == 0:
        out = _down_axis_int(rows, 1, src_w // out_w)
    else:
        starts, src_b, mats = w_plan
        out = _resize_w_blocked(rows, out_w, mats, starts, src_b)
    return _quantize(out, to_uint8)


def blend_finalize_banded(
    lap0: torch.Tensor,
    coarse: Optional[torch.Tensor],
    out_h: int,
    out_w: int,
    bands: int = 8,
    crop_h: Optional[int] = None,
    crop_w: Optional[int] = None,
    to_uint8=False,
    as_iterator: bool = False,
    as_device: bool = False,
):
    """Final level-0 collapse + exact-size bicubic resize + quantize, in
    uniform output row bands.

    ``lap0``/``coarse`` are the two finest canvas levels from
    ``laplacian_fusion_tiles(..., collapse_last=False)``; ``coarse=None``
    takes ``lap0`` as the finished canvas. Every band is computed on the
    device first; the host then fetches them in order. Returns an
    (out_h, out_w, C) numpy array, an iterator of row bands, or with
    ``as_device`` the bands as one tensor on the device (the QA proxy,
    reference blend.py:663).
    """
    src_h = crop_h if crop_h is not None else lap0.shape[0]
    src_w = crop_w if crop_w is not None else lap0.shape[1]
    if src_w != lap0.shape[1]:
        lap0 = lap0[:, :src_w]
    band_out_h = -(-out_h // bands)
    idx_full, w_full = _axis_plan(src_h, out_h)
    pad = bands * band_out_h - out_h
    if pad:
        idx_full = np.concatenate([idx_full, np.repeat(idx_full[-1:], pad, 0)])
        w_full = np.concatenate([w_full, np.repeat(w_full[-1:], pad, 0)])
    spans = []
    for b in range(bands):
        rows = idx_full[b * band_out_h : (b + 1) * band_out_h]
        spans.append((int(rows.min()), int(rows.max()) + 1))
    band_src_h = min(max(hi - lo for lo, hi in spans), lap0.shape[0])
    coarse_h = coarse.shape[0] if coarse is not None else 0
    # coarse halo: rows [lo//2 - 1, (hi-1)//2 + 2) cover every pyrUp tap
    # (+4: one extra for odd band heights, one for the cut rows)
    band_coarse_h = min(band_src_h // 2 + 4, coarse_h)
    dev = lap0.device
    w_plan = None
    if src_w != out_w and src_w % out_w != 0:
        starts, src_b, _out_b, mats = _w_block_plan(src_w, out_w)
        w_plan = (starts, src_b, torch.from_numpy(mats).to(dev))

    outs = []
    with _full_fp32_matmul():
        for b in range(bands):
            lo, _hi = spans[b]
            lap_start = min(lo, lap0.shape[0] - band_src_h)
            ci0 = min(max(lap_start // 2 - 1, 0), coarse_h - band_coarse_h)
            rows = idx_full[b * band_out_h : (b + 1) * band_out_h] - lap_start
            r_h = _band_matrix(rows, w_full[b * band_out_h : (b + 1) * band_out_h], band_src_h)
            outs.append(_finalize_band(
                lap0, coarse, lap_start, ci0, lap_start - 2 * ci0,
                torch.from_numpy(r_h).to(dev), band_src_h, band_coarse_h,
                out_w, w_plan, to_uint8,
            ))

    if as_device:
        return torch.cat(outs, dim=0)[:out_h]

    def bands_iter() -> Iterator[np.ndarray]:
        remaining = out_h
        for band in outs:
            arr = band.cpu().numpy()
            if to_uint8 == "uint16":
                arr = arr.astype(np.uint16)
            take = min(band_out_h, remaining)
            remaining -= take
            yield arr[:take]

    if as_iterator:
        return bands_iter()
    return np.concatenate(list(bands_iter()), axis=0)
