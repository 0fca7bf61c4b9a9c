"""Halo-exchange tile merge and Laplacian blend over a mesh row axis (port
of ``srs_tpu/parallel/halo.py``).

The canvas is sharded by row bands over the ``space`` axis. With ``ny``
tile rows split into ``S`` groups of ``k``, shard d owns canvas rows
[d*k*step, (d+1)*k*step) (the last shard also owns the trailing
``overlap`` rows). A shard accumulates only its own tiles, over
``hl = (k-1)*step + block`` rows; its last ``overlap`` rows belong to
shard d+1 and are sent down, weight sums with them, so normalization at
shard boundaries is exact.

Each shard's tensors live on its mesh device and its work is launched
there; one ``ppermute`` of the reference is one ``Tensor.to(device,
copy=True)`` per pair of neighbours (a peer copy between cards, a copy on
the card itself on a virtual mesh). Every leg reads the values before
any leg of the same exchange is added, as ``ppermute`` does. ``stats``
(a dict), when given, gets ``halo_bytes`` added: the bytes those copies
moved.

Each shard's tile pyramid is K1, each Laplacian and every collapse step
K2 (``ops/pyramid.py``). The collapse's row upsample with neighbour rows
in place of border rules (``_pyr_up_rows_halo``) is K2 on the band
extended by one halo row each side: with the halo rows in place, the
rows it keeps read no border rule.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.blend import _accumulate_level_sums, _v2
from ..ops.pyramid import build_gaussian_pyramid, pyr_up
from ..ops.weights import profile_pyramid
from ..tiling.geometry import TileLayout
from .mesh import Mesh

__all__ = ["sharded_weighted_merge", "sharded_laplacian_blend"]


def _send(x: torch.Tensor, device: torch.device, stats: Optional[Dict]) -> torch.Tensor:
    """One leg of a ``ppermute``: a copy of ``x`` on ``device``."""
    if stats is not None:
        stats["halo_bytes"] = stats.get("halo_bytes", 0) + x.numel() * x.element_size()
    return x.to(device, copy=True)


def _row_shards(layout: TileLayout, s: int, axis: str):
    """(k, own, hl, relative positions [N, 2]) of ``layout`` over ``s``
    row shards: shard d's tiles are [d*k*nx, (d+1)*k*nx), their y
    relative to its first owned row."""
    ny, nx = layout.ny, layout.nx
    if ny % s:
        raise ValueError(f"ny={ny} not divisible by mesh axis {axis}={s}")
    k = ny // s
    own = k * layout.step
    hl = (k - 1) * layout.step + layout.block
    rel = np.asarray(layout.positions).reshape(ny, nx, 2).copy()
    for d in range(s):
        rel[d * k : (d + 1) * k, :, 0] -= d * k * layout.step
    return k, own, hl, rel.reshape(ny * nx, 2)


def _stitch(parts: List[torch.Tensor], own: int, device: torch.device) -> torch.Tensor:
    """The owned rows of every shard ([0, own), all of the last one's) in
    one tensor on ``device``."""
    rows = [p[:own].to(device) for p in parts[:-1]] + [parts[-1].to(device)]
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def sharded_weighted_merge(
    tiles: torch.Tensor,
    weights,
    layout: TileLayout,
    mesh: Mesh,
    axis: str = "space",
    stats: Optional[Dict] = None,
) -> torch.Tensor:
    """Merge a [N, B, B, C] tile batch into the padded canvas with the
    canvas row-sharded over ``axis``; ``layout.ny`` must divide by the
    axis size. Returns the whole canvas on the tiles' device; the math of
    ``ops.tiles.merge_tiles``."""
    devs = mesh.axis_devices(axis)
    s = len(devs)
    k, own, hl, rel = _row_shards(layout, s, axis)
    per = k * layout.nx
    w_all = torch.as_tensor(weights, dtype=torch.float32)
    canvas, wsum = [], []
    for d, dev in enumerate(devs):
        local = tiles[d * per : (d + 1) * per].to(dev).float()
        w = w_all[d * per : (d + 1) * per].to(dev)
        c, ws = _accumulate_level_sums(local, None, lambda t, w=w: w[t][..., None],
                                       rel[d * per : (d + 1) * per], hl, layout.padded_w)
        canvas.append(c)
        wsum.append(ws)
    overlap = hl - own
    if s > 1 and overlap > 0:
        spill = [(_send(canvas[d - 1][own:hl], devs[d], stats),
                  _send(wsum[d - 1][own:hl], devs[d], stats)) for d in range(1, s)]
        for d in range(1, s):
            canvas[d][0:overlap] += spill[d - 1][0]
            wsum[d][0:overlap] += spill[d - 1][1]
    bands = [c / torch.clamp(ws, min=1e-8) for c, ws in zip(canvas, wsum)]
    return _stitch(bands, own, tiles.device)


def _pyr_up_rows_halo(coarse: torch.Tensor, top_row: torch.Tensor, bot_row: torch.Tensor,
                      out_rows: int, axis_w_dst: int) -> torch.Tensor:
    """2x upsample of a local coarse band [m, W, C] whose border rows are
    the neighbours' ``top_row`` / ``bot_row`` ([1, W, C], resolved to the
    border rules at the global edges by the caller) instead of border
    rules: K2 on [top; coarse; bot] to (2(m+2), ``axis_w_dst``), rows
    [2, 2 + out_rows). Those rows read only the band and the two halo
    rows; W keeps K2's global rules (the full width is local)."""
    m = coarse.shape[0]
    ext = torch.cat([top_row, coarse, bot_row], dim=0)
    return pyr_up(ext, (2 * (m + 2), axis_w_dst))[2 : 2 + out_rows]


def sharded_laplacian_blend(
    tiles: torch.Tensor,
    wy: np.ndarray,
    wx: np.ndarray,
    layout: TileLayout,
    mesh: Mesh,
    levels: int = 6,
    axis: str = "space",
    collapse_last: bool = True,
    stats: Optional[Dict] = None,
):
    """Canvas-pyramid Laplacian blend with the canvas row-sharded over
    ``axis``: per level, each shard accumulates its own tiles' Laplacians
    and its spill rows travel to the next shard; the collapse exchanges
    single-row halos between neighbours, and no shard holds the whole
    canvas.

    ``ny`` must divide by the axis size. Levels are clamped as the
    single-device blend clamps them (``ops.blend.laplacian_fusion_tiles``),
    then until the own band ``own`` divides by 2^(levels-1). Returns the
    owned canvas rows [S*own (+ the tail), W, C] on the tiles' device,
    the math of the single-device blend. ``collapse_last=False`` stops the
    collapse at level 1 and returns a
    :class:`srs_tpu_torch.parallel.finalize.ShardedCanvas` (the collapsed
    canvas when only one level is left).
    """
    devs = mesh.axis_devices(axis)
    s_sz = len(devs)
    k, own, hl, rel = _row_shards(layout, s_sz, axis)
    per = k * layout.nx
    block, w_pad = layout.block, layout.padded_w

    if layout.num_tiles > 1:
        align = min(_v2(int(p)) for p in np.asarray(layout.positions).reshape(-1)
                    if int(p) != 0)
        overlap_cap = max(1, int(np.log2(max(layout.overlap, 4))) - 1)
        levels = max(1, min(levels, align + 1, overlap_cap))
    lv = levels
    while lv > 1 and (own % (2 ** (lv - 1)) or block // (2 ** (lv - 1)) < 4):
        lv -= 1
    levels = lv

    own_i = [own // (2**i) for i in range(levels)]
    hl_i = [-(-hl // (2**i)) for i in range(levels)]
    cw_i = [-(-w_pad // (2**i)) for i in range(levels)]
    py = profile_pyramid(wy, levels)
    px = profile_pyramid(wx, levels)
    levels = min(levels, len(py))
    deferred = (not collapse_last) and levels > 1

    gauss, pys, pxs = [], [], []
    for d, dev in enumerate(devs):
        sl = slice(d * per, (d + 1) * per)
        gauss.append(build_gaussian_pyramid(tiles[sl].to(dev).float(), levels))
        pys.append([torch.from_numpy(p[sl]).to(dev) for p in py[:levels]])
        pxs.append([torch.from_numpy(p[sl]).to(dev) for p in px[:levels]])
    n_lv = len(gauss[0])

    canvas_lap: List[List[torch.Tensor]] = []  # [level][shard]
    for i in range(n_lv):
        nums, dens = [], []
        for d in range(s_sz):
            g = gauss[d]
            num, den = _accumulate_level_sums(
                g[i], None if i == n_lv - 1 else g[i + 1],
                lambda t, d=d: pys[d][i][t][:, None, None] * pxs[d][i][t][None, :, None],
                rel[d * per : (d + 1) * per] // (2**i), hl_i[i], cw_i[i])
            nums.append(num)
            dens.append(den)
            g[i] = None  # consumed: frees the level before the next one
        if s_sz > 1 and hl_i[i] > own_i[i]:
            pad_rows = hl_i[i] - own_i[i]
            spill = [(_send(nums[d - 1][own_i[i]:], devs[d], stats),
                      _send(dens[d - 1][own_i[i]:], devs[d], stats)) for d in range(1, s_sz)]
            for d in range(1, s_sz):
                nums[d][0:pad_rows] += spill[d - 1][0]
                dens[d][0:pad_rows] += spill[d - 1][1]
        canvas_lap.append([n / torch.clamp(dn, min=1e-8) for n, dn in zip(nums, dens)])
        del nums, dens

    # Collapse over each shard's whole band [0, hl_i): interior shards'
    # tail rows ([own_i, hl_i), authoritative on the next shard) are
    # garbage there and dropped at the stitch; the last shard's tail is
    # complete (it spilled nowhere) and owns the canvas bottom. Halos come
    # from the owned rows of the neighbours.
    x = canvas_lap[-1]
    stop = 1 if deferred else 0
    for i in range(n_lv - 2, stop - 1, -1):
        oc = own_i[i + 1] if i + 1 < len(own_i) else own_i[-1] // 2
        hc = x[0].shape[0]
        last = s_sz - 1
        # row above shard d's band = shard d-1's row oc-1; row below its
        # tail = shard d+1's row hc-oc; the first tail row (coarse row oc,
        # incomplete on interior shards) = shard d+1's row 0.
        top_from_above = [None] + [_send(x[d - 1][oc - 1 : oc], devs[d], stats)
                                   for d in range(1, s_sz)]
        bot_from_below = [_send(x[d + 1][hc - oc : hc - oc + 1], devs[d], stats)
                          for d in range(last)] + [None]
        row0_below = [_send(x[d + 1][:1], devs[d], stats) for d in range(last)]
        nxt = []
        for d in range(s_sz):
            xd = x[d]
            if d < last:
                xd = xd.clone()
                xd[oc : oc + 1] = row0_below[d]
            # global edges: REFLECT_101 on top (c[-1] = c[1]), replicate at
            # the bottom (c[m] = c[m-1]), pyrUp's border rules
            top_row = xd[1:2] if d == 0 else top_from_above[d]
            bot_row = xd[-1:] if d == last else bot_from_below[d]
            up = _pyr_up_rows_halo(xd, top_row, bot_row, hl_i[i], cw_i[i])
            nxt.append(canvas_lap[i][d] + up)
        x = nxt
        canvas_lap[i] = None
    if deferred:
        from .finalize import ShardedCanvas

        return ShardedCanvas(
            lap0=canvas_lap[0], coarse=x, devices=devs, axis=axis, s=s_sz,
            own0=own, hl0=hl, own1=own_i[1], hl1=hl_i[1], w_pad=w_pad, cw1=cw_i[1],
        )
    return _stitch(x, own, tiles.device)
