"""Tile fusion: the Laplacian canvas-pyramid blend, weighted and
gradient-domain fusion, seamless cloning and the banded finalize (port of
``srs_tpu/ops/blend.py``).

Ported: ``laplacian_fusion_tiles`` (reference 273-344) with its level
clamp, its separable-profile path (``_v2``, ``_build_gauss``,
``_accumulate_level_sep`` (``_accumulate_level`` here, for both weight
kinds), ``_collapse_step``,
``_canvas_pyramid_blend_profiles``, 143-265), its dense-weight path
(``_canvas_pyramid_blend``, 78-113; the reference's staged variant,
148-176, works around a TPU compiler limit and computes the same) and its
``mode="reference"`` (``_weighted_collapse``, 55-63);
``weighted_fusion_tiles`` (347-366); the spectral Poisson solver
(``_dct2``, ``_idct2``, ``poisson_solve_neumann``, 369-439, on
``torch.fft``); ``gradient_domain_fusion_tiles`` (442-476);
``seamless_clone`` (479-531); ``_finalize_band`` /
``blend_finalize_banded`` (538-692), with ``as_device``; and the
multigrid Poisson clone (``_masked_jacobi``, ``_laplace``, ``_vcycle``,
``seamless_clone_multigrid``, 695-773), whose restriction is K1 and
prolongation K2 on one image, in plain Python recursion.

The math is the reference's; the execution shape is the port's own. The
reference stages per-level programs, unrolls loops and caps chunks to fit
the TPU compiler; here each step is an eager op on the card. Both
canvas-pyramid paths keep the tiles' Gaussian pyramid and form each
Laplacian level as it is accumulated. Every pyrDown is kernel K1 and
every pyrUp kernel K2 (``ops/cuda/pyramid.py``). The vertical resize taps
and the W resize are plain float32 matrix products (``torch.matmul`` with
TF32 off, as the reference's ``Precision.HIGHEST``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..tiling.geometry import TileLayout
from .pyramid import (
    build_gaussian_pyramid,
    build_laplacian_pyramid,
    collapse_laplacian_pyramid,
    pyr_down,
    pyr_up,
)
from .resize import _axis_plan, _band_matrix, _down_axis_int, _resize_w_blocked, _w_block_plan
from .tiles import merge_tiles
from .weights import profile_pyramid

__all__ = [
    "laplacian_fusion_tiles",
    "blend_finalize_banded",
    "weighted_fusion_tiles",
    "gradient_domain_fusion_tiles",
    "poisson_solve_neumann",
    "seamless_clone",
    "seamless_clone_multigrid",
]


_fp32_lock = threading.Lock()
_fp32_holders = {"count": 0, "flag": False}


@contextlib.contextmanager
def _full_fp32_matmul():
    """float32 matrix products without TF32 while any caller, of any
    thread, is inside (``process_batch`` finalizes one job while the next
    runs); the last to leave restores the flag the first found."""
    with _fp32_lock:
        if _fp32_holders["count"] == 0:
            _fp32_holders["flag"] = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _fp32_holders["count"] += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_holders["count"] -= 1
            if _fp32_holders["count"] == 0:
                torch.backends.cuda.matmul.allow_tf32 = _fp32_holders["flag"]


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


def _accumulate_level_sums(
    g_i: torch.Tensor,
    g_next: Optional[torch.Tensor],
    weight: Callable[[int], torch.Tensor],
    pos: np.ndarray,
    ch: int,
    cw: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One canvas-pyramid level before its normalization: the Laplacian
    G_i - pyrUp(G_{i+1}) formed here (``g_next`` None: G_i as it is), tile
    t weighted by ``weight(t)`` ([h, w, 1]) and accumulated at ``pos[t]``
    (clamped as ``lax.dynamic_slice`` clamps) on a [ch, cw] canvas.
    Returns (weighted sum, weight sum). The sharded blend
    (``parallel/halo.py``) adds its neighbours' spill rows to both before
    dividing."""
    n, tb_h, tb_w, c = g_i.shape
    lap = g_i if g_next is None else g_i - pyr_up(g_next, (tb_h, tb_w))
    num = torch.zeros((ch, cw, c), dtype=torch.float32, device=g_i.device)
    den = torch.zeros((ch, cw, 1), dtype=torch.float32, device=g_i.device)
    for t in range(n):
        w = weight(t)
        p0 = _clamp(pos[t, 0], tb_h, ch)
        p1 = _clamp(pos[t, 1], tb_w, cw)
        num[p0 : p0 + tb_h, p1 : p1 + tb_w] += lap[t] * w
        den[p0 : p0 + tb_h, p1 : p1 + tb_w] += w
    return num, den


def _accumulate_level(
    g_i: torch.Tensor,
    g_next: Optional[torch.Tensor],
    weight: Callable[[int], torch.Tensor],
    pos: np.ndarray,
    ch: int,
    cw: int,
) -> torch.Tensor:
    """One canvas-pyramid level (:func:`_accumulate_level_sums`), normalized."""
    num, den = _accumulate_level_sums(g_i, g_next, weight, pos, ch, cw)
    return num / torch.clamp(den, min=1e-8)


def _collapse_step(lap_i: torch.Tensor, coarser: torch.Tensor) -> torch.Tensor:
    return lap_i + pyr_up(coarser, (lap_i.shape[0], lap_i.shape[1]))


def _canvas_pyramid(
    gauss: list,
    level_weight: Callable[[int, int], torch.Tensor],
    positions: np.ndarray,
    padded_h: int,
    padded_w: int,
    collapse_last: bool = True,
):
    """Burt-Adelson canvas pyramid from the tiles' Gaussian pyramid
    ``gauss`` (consumed): each tile's Laplacian levels, weighted by
    ``level_weight(level, tile)`` ([h, w, 1]), accumulated into canvas
    levels, normalized per level and collapsed. Returns the canvas, or
    ``(lap0, coarse)`` when ``collapse_last`` is False and there are two
    or more levels (the caller finishes level 0 banded)."""
    n_lv = len(gauss)
    canvas_lap = []
    ch, cw = padded_h, padded_w
    for i in range(n_lv):
        is_last = i == n_lv - 1
        canvas_lap.append(_accumulate_level(
            gauss[i], None if is_last else gauss[i + 1],
            lambda t, i=i: level_weight(i, t),
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


def _canvas_pyramid_blend_profiles(tiles, wy, wx, positions, levels, padded_h, padded_w,
                                   collapse_last=True):
    """Separable weights: level i of tile t weighs outer(py_i[t], px_i[t])
    from the 1-D pyramids of the profiles (exact: the binomial kernel is
    separable), never a dense [N, B, B] array."""
    gauss = build_gaussian_pyramid(tiles.float(), levels)
    dev = tiles.device
    py = [torch.from_numpy(p).to(dev) for p in profile_pyramid(wy, len(gauss))]
    px = [torch.from_numpy(p).to(dev) for p in profile_pyramid(wx, len(gauss))]
    return _canvas_pyramid(
        gauss, lambda i, t: py[i][t][:, None, None] * px[i][t][None, :, None],
        positions, padded_h, padded_w, collapse_last)


def _canvas_pyramid_blend(tiles, weights, positions, levels, padded_h, padded_w):
    """Dense weights [N, B, B]: their Gaussian pyramid (K1 at C = 1) weighs
    each level."""
    gauss = build_gaussian_pyramid(tiles.float(), levels)
    w = torch.as_tensor(weights, dtype=torch.float32, device=tiles.device)
    wpyr = build_gaussian_pyramid(w[..., None], levels)
    return _canvas_pyramid(gauss, lambda i, t: wpyr[i][t], positions, padded_h, padded_w)


def _weighted_collapse(tiles: torch.Tensor, weights: torch.Tensor, levels: int) -> torch.Tensor:
    """collapse(L_i(tile) * G_i(w)) for a [N, B, B, C] batch."""
    lap = build_laplacian_pyramid(tiles.float(), levels)
    wpyr = build_gaussian_pyramid(weights[..., None].float(), levels)
    return collapse_laplacian_pyramid([lv * wv for lv, wv in zip(lap, wpyr)])


def laplacian_fusion_tiles(
    tiles: torch.Tensor,
    layout: TileLayout,
    weight_profiles: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    levels: int = 6,
    clip_range: Optional[Tuple[float, float]] = (0.0, 255.0),
    collapse_last: bool = True,
    weights=None,
    mode: str = "canvas",
    positions: Optional[np.ndarray] = None,
):
    """Burt-Adelson blend of a [N, B, B, C] tile batch at ``positions``
    ((N, 2) (y, x); ``layout``'s by default), weighted by separable ``weight_profiles=(wy, wx)`` ([N, B]
    each) or by dense ``weights`` ([N, B, B]; ignored when profiles are
    given).

    ``mode="canvas"``: weighted Laplacian levels accumulate into canvas
    levels, normalized per level, collapsed once. Levels are clamped so
    tile dyadic grids align with the canvas grid and the coarsest level's
    footprint stays inside the overlap band. With ``collapse_last=False``
    (profiles only) returns ``(lap0, coarse)`` for
    :func:`blend_finalize_banded`, or the canvas when one level is left,
    unclipped either way.

    ``mode="reference"`` (dense weights): each tile's own
    collapse(L_i(tile) * G_i(w)), merged on the canvas and normalized by
    the level-0 weight sum, as the reference's blending module does.
    """
    if positions is None:
        positions = layout.positions
    if mode == "reference":
        w = torch.as_tensor(weights, dtype=torch.float32, device=tiles.device)
        weighted = _weighted_collapse(tiles, w, levels)
        canvas = merge_tiles(weighted, w, layout, positions, premultiplied=True)
    else:
        if layout.num_tiles > 1:
            align = min(_v2(int(p)) for p in np.asarray(layout.positions).reshape(-1)
                        if int(p) != 0)
            overlap_cap = max(1, int(np.log2(max(layout.overlap, 4))) - 1)
            levels = max(1, min(levels, align + 1, overlap_cap))
        if weight_profiles is not None:
            wy, wx = weight_profiles
            canvas = _canvas_pyramid_blend_profiles(
                tiles, wy, wx, positions, levels, layout.padded_h, layout.padded_w,
                collapse_last=collapse_last,
            )
            if not collapse_last:
                return canvas  # (lap0, coarse), or the unclipped canvas at one level
        else:
            canvas = _canvas_pyramid_blend(tiles, weights, positions, levels,
                                           layout.padded_h, layout.padded_w)
    if clip_range is not None:
        canvas = torch.clamp(canvas, clip_range[0], clip_range[1])
    return canvas


def weighted_fusion_tiles(
    tiles: torch.Tensor,
    weights,
    layout: TileLayout,
    clip_range: Optional[Tuple[float, float]] = None,
    positions: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Weighted-average fusion (ramp weights) or feather blend (distance
    weights): ``merge_tiles``, optionally clipped."""
    canvas = merge_tiles(tiles, weights, layout, positions)
    if clip_range is not None:
        canvas = torch.clamp(canvas, clip_range[0], clip_range[1])
    return canvas


# -- spectral Poisson solver -------------------------------------------------


def _phase(n: int, sign: float, scale: float, axis: int, ndim: int, device) -> torch.Tensor:
    """``scale * exp(sign * i * pi * k / (2n))`` shaped to broadcast along
    ``axis`` (k = 0..n-1, float32 angles, complex64 values)."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    shape = [1] * ndim
    shape[axis] = n
    return (scale * torch.polar(torch.ones_like(k), sign * np.float32(np.pi) * k
                                / (2 * n))).reshape(shape)


def _dct2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Unnormalized DCT-II along ``axis`` through the FFT of the even-odd
    reordering v = [x0, x2, ..., x3, x1]."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    order = torch.cat([idx[::2], idx[1::2].flip(0)])
    V = torch.fft.fft(x.index_select(axis, order), dim=axis)
    return torch.real(V * _phase(n, -1.0, 2.0, axis, x.dim(), x.device))


def _idct2(X: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact inverse of :func:`_dct2`: V[k] = (X[k] - i X[n-k]) / 2 *
    e^{i pi k / 2n} (no imaginary part at k = 0), inverse FFT, then the
    reordering undone."""
    n = X.shape[axis]
    rev = torch.cat([torch.zeros(1, dtype=torch.long, device=X.device),
                     torch.arange(n - 1, 0, -1, device=X.device)])
    shift = X.index_select(axis, rev)
    shift.narrow(axis, 0, 1).zero_()
    V = (X - 1j * shift) * _phase(n, 1.0, 0.5, axis, X.dim(), X.device)
    v = torch.real(torch.fft.ifft(V, dim=axis))
    h = (n + 1) // 2
    out = torch.empty_like(v)
    idx = torch.arange(n, device=X.device)
    out.index_copy_(axis, idx[::2], v.narrow(axis, 0, h))
    out.index_copy_(axis, idx[1::2].flip(0), v.narrow(axis, h, n - h))
    return out


def poisson_solve_neumann(div: torch.Tensor) -> torch.Tensor:
    """Solve lap(u) = div with homogeneous Neumann borders on (H, W[, C]):
    the 5-point Laplacian is diagonal in the DCT-II basis, with
    eigenvalues 2 cos(pi k / n) - 2 per axis. The zero mode (the mean) is
    set to 0. Channels are solved one after another, which bounds the
    complex temporaries to one channel's."""
    squeeze = div.dim() == 2
    if squeeze:
        div = div[..., None]
    h, w = div.shape[0], div.shape[1]
    dev = div.device
    ky = 2.0 * torch.cos(np.float32(np.pi) * torch.arange(h, dtype=torch.float32, device=dev)
                         / h) - 2.0
    kx = 2.0 * torch.cos(np.float32(np.pi) * torch.arange(w, dtype=torch.float32, device=dev)
                         / w) - 2.0
    denom = ky[:, None] + kx[None, :]
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.empty_like(div, dtype=torch.float32)
    for c in range(div.shape[2]):
        u = _dct2(_dct2(div[..., c].float(), 0), 1) / denom
        u[0, 0] = 0.0
        out[..., c] = _idct2(_idct2(u, 0), 1)
    return out[..., 0] if squeeze else out


def gradient_domain_fusion_tiles(
    tiles: torch.Tensor,
    weights,
    layout: TileLayout,
    clip_range: Optional[Tuple[float, float]] = (0.0, 255.0),
    positions: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Gradient-domain fusion: the tiles' forward differences merged on the
    canvas with ``weights``, their divergence integrated by the spectral
    Poisson solve, and the result shifted to the merged tiles' mean."""
    tiles = tiles.float()
    gx = torch.diff(tiles, dim=2, append=tiles[:, :, -1:, :])
    gy = torch.diff(tiles, dim=1, append=tiles[:, -1:, :, :])
    gx_c = merge_tiles(gx, weights, layout, positions)
    del gx
    gy_c = merge_tiles(gy, weights, layout, positions)
    del gy
    base_mean = merge_tiles(tiles, weights, layout, positions).mean(dim=(0, 1), keepdim=True)
    # backward differences, summed in the reference's order
    div = gx_c.clone()
    div[:, 1:] -= gx_c[:, :-1]
    div += gy_c
    div[1:] -= gy_c[:-1]
    del gx_c, gy_c
    u = poisson_solve_neumann(div)
    del div
    u = u - u.mean(dim=(0, 1), keepdim=True) + base_mean
    if clip_range is not None:
        u = torch.clamp(u, clip_range[0], clip_range[1])
    return u


# -- seamless clone ------------------------------------------------------------


def _clone_problem(dst, src, mask, mode: str):
    """The Poisson-editing problem of aligned (..., H, W, C) images:
    (dst, m, div, u0) with the mask as {0, 1} floats broadcasting to
    (..., H, W, 1), ``div`` the divergence of the guidance field (the
    source's forward differences for ``"normal"``, its grey's for
    ``"monochrome"``, per component the larger of the source's and the
    destination's for ``"mixed"``; backward differences summed in the
    reference's order), and the warm start ``u0`` (the source inside the
    mask, ``dst`` outside)."""
    dst = dst.float()
    src = src.float()
    m = (mask > 0).float()
    if m.dim() == 2:
        m = m[..., None]
    ay, ax = dst.dim() - 3, dst.dim() - 2

    def grads(img):
        gx = torch.diff(img, dim=ax, append=img.narrow(ax, img.shape[ax] - 1, 1))
        gy = torch.diff(img, dim=ay, append=img.narrow(ay, img.shape[ay] - 1, 1))
        return gx, gy

    if mode == "monochrome":
        gray = (0.299 * src[..., 0] + 0.587 * src[..., 1] + 0.114 * src[..., 2])[..., None]
        sx, sy = grads(gray.expand_as(src))
    else:
        sx, sy = grads(src)
    if mode == "mixed":
        dx, dy = grads(dst)
        sx = torch.where(dx.abs() > sx.abs(), dx, sx)
        sy = torch.where(dy.abs() > sy.abs(), dy, sy)
    div = sx.clone()
    div.narrow(ax, 1, div.shape[ax] - 1).sub_(sx.narrow(ax, 0, sx.shape[ax] - 1))
    div += sy
    div.narrow(ay, 1, div.shape[ay] - 1).sub_(sy.narrow(ay, 0, sy.shape[ay] - 1))
    return dst, m, div, dst * (1 - m) + src * m


def _roll4(u: torch.Tensor) -> torch.Tensor:
    """Sum of the four neighbours over the (H, W) axes of (..., H, W, C),
    wrapping around the borders as the reference's ``jnp.roll`` does."""
    return (torch.roll(u, 1, -3) + torch.roll(u, -1, -3)
            + torch.roll(u, 1, -2) + torch.roll(u, -1, -2))


def _masked_jacobi(u, div, m, dst, iters: int):
    """``iters`` Jacobi sweeps of lap(u) = div inside ``m``, ``dst``
    outside it."""
    keep = dst * (1 - m)
    for _ in range(iters):
        u = keep + (_roll4(u) - div) * 0.25 * m
    return u


def seamless_clone(
    dst: torch.Tensor,
    src: torch.Tensor,
    mask: torch.Tensor,
    mode: str = "normal",
    iters: int = 400,
) -> torch.Tensor:
    """cv2.seamlessClone equivalent on aligned (..., H, W, C) arrays: Jacobi
    relaxation of lap(u) = div(g) inside ``mask`` ((H, W), or any shape
    that broadcasts to (..., H, W, 1)) with ``dst`` held outside it
    (:func:`_clone_problem` gives g for each ``mode``). Leading dimensions
    are independent problems."""
    dst, m, div, u = _clone_problem(dst, src, mask, mode)
    return _masked_jacobi(u, div, m, dst, iters)


def _laplace(u: torch.Tensor) -> torch.Tensor:
    return _roll4(u) - 4.0 * u


def _vcycle(u, div, m, dst, depth: int, nu: int = 12):
    """One multigrid V-cycle for lap(u) = div inside ``m`` (``dst`` outside)
    on (H, W, C): smooth, restrict the residual with pyrDown (K1; times 4,
    the coarse stencil's h^2), take the coarse mask as the fine mask's
    strict interior (pyrDown(m) > 0.999, K1 at C = 1), solve the coarse
    error by recursion, prolong it with pyrUp (K2) to the fine size,
    smooth again. The recursion stops at ``depth`` 0 or below 8 px."""
    u = _masked_jacobi(u, div, m, dst, nu)
    if depth > 0 and min(u.shape[0], u.shape[1]) >= 8:
        r = (div - _laplace(u)) * m
        r_c = pyr_down(r) * 4.0
        m_c = (pyr_down(m) > 0.999).float()
        zero = torch.zeros_like(r_c)
        e_c = _vcycle(zero, r_c, m_c, zero, depth - 1, nu)
        u = u + pyr_up(e_c, (u.shape[0], u.shape[1])) * m
    return _masked_jacobi(u, div, m, dst, nu)


def seamless_clone_multigrid(
    dst: torch.Tensor,
    src: torch.Tensor,
    mask: torch.Tensor,
    mode: str = "normal",
    cycles: int = 6,
    depth: int = 5,
) -> torch.Tensor:
    """Poisson editing of aligned (H, W, C) images, the equation of
    :func:`seamless_clone` solved by ``cycles`` V-cycles of ``depth``
    levels: low-frequency error decays once a cycle instead of once every
    ~N^2 Jacobi sweeps."""
    dst, m, div, u = _clone_problem(dst, src, mask, mode)
    for _ in range(cycles):
        u = _vcycle(u, div, m, dst, depth)
    return u


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
