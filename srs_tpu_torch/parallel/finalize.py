"""Sharded banded finalize: the level-0 collapse, the exact-size resize and
the quantize, each shard producing its own output rows (port of
``srs_tpu/parallel/finalize.py``).

The sharded blend (:func:`..parallel.halo.sharded_laplacian_blend` with
``collapse_last=False``) leaves the two finest canvas levels row-sharded
as a :class:`ShardedCanvas`. Here each shard extends its owned rows by the
halo rows its output bands read (one copy from the shard above, one from
the shard below) and runs the port's single-device band
(``ops/blend._finalize_band``: K2 collapses the band, float32 matrix
products resize it) on its own device. The bicubic tap plan is made on
the host, so every window is known before a band runs; no shard ever
holds the whole canvas.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.blend import _finalize_band, _full_fp32_matmul, blend_finalize_banded
from ..ops.resize import _axis_plan, _band_matrix, _w_block_plan
from .halo import _send, _stitch

__all__ = ["ShardedCanvas", "gather_canvas", "sharded_finalize_banded"]

logger = logging.getLogger("srs_tpu_torch.parallel")


@dataclass
class ShardedCanvas:
    """Deferred blend output kept row-sharded over a mesh axis.

    ``lap0[d]`` is shard d's band of the finest canvas-pyramid level
    ([hl0, w_pad, C] on ``devices[d]``; on interior shards rows [own0, hl0)
    are garbage: their values live at the start of the next shard) and
    ``coarse[d]`` its band of the collapsed level 1 ([hl1, cw1, C], same
    rule). The canvas is ``lap0 + pyrUp(coarse)``; it is never formed.
    """

    lap0: List[torch.Tensor]
    coarse: List[torch.Tensor]
    devices: List[torch.device]
    axis: str
    s: int
    own0: int
    hl0: int
    own1: int
    hl1: int
    w_pad: int
    cw1: int


def gather_canvas(sc: ShardedCanvas,
                  device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The authoritative rows of ``sc`` stitched into whole ``(lap0,
    coarse)`` on ``device`` (the first shard's by default): shards
    0..S-2 own their first ``own`` rows, the last one its whole band."""
    device = device or sc.devices[0]
    return _stitch(sc.lap0, sc.own0, device), _stitch(sc.coarse, sc.own1, device)


def _extend(parts: List[torch.Tensor], devices, own: int, ht: int, hb: int,
            stats: Optional[Dict]) -> List[torch.Tensor]:
    """Each shard's owned rows with ``ht`` rows of the shard above and
    ``hb`` of the one below. Shard 0 gets zeros above (its windows never
    read above row 0); the last shard takes its own tail rows below,
    zero-padded past the canvas bottom (never read)."""
    s = len(parts)
    out = []
    for d, x in enumerate(parts):
        rows = []
        if ht > 0:
            rows.append(x.new_zeros((ht, *x.shape[1:])) if d == 0
                        else _send(parts[d - 1][own - ht : own], devices[d], stats))
        rows.append(x[:own])
        if hb > 0:
            if d == s - 1:
                avail = min(hb, x.shape[0] - own)
                rows.append(x[own : own + avail])
                if avail < hb:
                    rows.append(x.new_zeros((hb - avail, *x.shape[1:])))
            else:
                rows.append(_send(parts[d + 1][:hb], devices[d], stats))
        out.append(torch.cat(rows, dim=0) if len(rows) > 1 else rows[0])
    return out


def sharded_finalize_banded(
    sc: ShardedCanvas,
    out_h: int,
    out_w: int,
    bands: int = 8,
    crop_h: Optional[int] = None,
    crop_w: Optional[int] = None,
    to_uint8: Any = False,
    as_iterator: bool = False,
    stats: Optional[Dict] = None,
):
    """The final collapse, the exact-size bicubic resize and the quantize
    of a :class:`ShardedCanvas`, each shard computing its own output rows:
    the math of ``ops.blend.blend_finalize_banded`` on the gathered canvas.

    Output rows split uniformly over the shards (shard d owns output rows
    [d*ceil(out_h/S), ...)), and each shard's rows into ``ceil(bands/S)``
    sub-bands. Returns an (out_h, out_w, C) numpy array, or with
    ``as_iterator`` the bands in global row order. When a halo would have
    to reach past a neighbour's owned rows (tiny canvases on wide meshes)
    the canvas is gathered and finished on one device instead; ``stats``
    (a dict), when given, gets ``gather_fallback`` (true once any call
    with it gathered) and the halo copies' bytes added to ``halo_bytes``.
    """
    S = sc.s
    own0, hl0, own1, hl1 = sc.own0, sc.hl0, sc.own1, sc.hl1
    tail0, tail1 = hl0 - own0, hl1 - own1
    padded_h = S * own0 + tail0
    ch_total = S * own1 + tail1
    src_h = crop_h if crop_h is not None else padded_h
    src_w = crop_w if crop_w is not None else sc.w_pad
    if src_h > padded_h:
        raise ValueError(f"crop_h={src_h} exceeds canvas rows {padded_h}")

    idx_full, w_full = _axis_plan(src_h, out_h)
    dev_out = -(-out_h // S)
    sub = max(1, -(-bands // S))
    sb = -(-dev_out // sub)

    def g_rows(d: int, k: int) -> List[int]:
        return [min(d * dev_out + k * sb + j, out_h - 1) for j in range(sb)]

    lap_starts = np.zeros((S, sub), np.int64)
    spans = np.zeros((S, sub), np.int64)
    for d in range(S):
        for k in range(sub):
            rows = idx_full[g_rows(d, k)]
            lo, hi = int(rows.min()), int(rows.max()) + 1
            spans[d, k] = hi - lo
            lap_starts[d, k] = lo
    band_src_h = int(min(spans.max(), padded_h))
    lap_starts = np.minimum(lap_starts, padded_h - band_src_h)
    band_coarse_h = int(min(band_src_h // 2 + 4, ch_total))
    ci0 = np.clip(lap_starts // 2 - 1, 0, ch_total - band_coarse_h)
    up_off = lap_starts - 2 * ci0

    dev_idx = np.arange(S, dtype=np.int64)[:, None]
    h0t = int(max(0, (dev_idx * own0 - lap_starts).max()))
    h0b = int(max(0, (lap_starts + band_src_h - (dev_idx + 1) * own0).max()))
    h1t = int(max(0, (dev_idx * own1 - ci0).max()))
    h1b = int(max(0, (ci0 + band_coarse_h - (dev_idx + 1) * own1).max()))
    fallback = h0t > own0 or h0b > own0 or h1t > own1 or h1b > own1
    if stats is not None:
        stats["gather_fallback"] = bool(stats.get("gather_fallback")) or fallback
    # A window may overhang into the next shard's owned rows (the uniform
    # output split drifts from the last shard's longer band by up to
    # tail0), never past them. When one halo cannot cover a window, gather
    # and finish on one device: slower, never a failed job.
    if fallback:
        logger.info("sharded finalize to %dx%d: a halo exceeds a shard's owned rows; "
                    "gathering the canvas", out_h, out_w)
        lap0_full, coarse_full = gather_canvas(sc)
        return blend_finalize_banded(
            lap0_full, coarse_full, out_h, out_w, bands=bands,
            crop_h=crop_h, crop_w=crop_w, to_uint8=to_uint8, as_iterator=as_iterator,
        )

    devs = sc.devices
    lap0_ext = [x[:, :src_w] for x in _extend(sc.lap0, devs, own0, h0t, h0b, stats)]
    # coarse keeps its full width: pyrUp first, then the cut, so cropped
    # columns still see their real neighbours instead of border rules
    coarse_ext = _extend(sc.coarse, devs, own1, h1t, h1b, stats)

    w_plans: Dict[str, Any] = {}
    if src_w != out_w and src_w % out_w != 0:
        starts, src_b, _out_b, mats = _w_block_plan(src_w, out_w)
        for dev in devs:
            w_plans.setdefault(str(dev), (starts, src_b, torch.from_numpy(mats).to(dev)))

    # Window starts in ext-local rows (ext row 0 = global row
    # d*own - halo_top); the up offset does not depend on the frame.
    outs = []
    with _full_fp32_matmul():
        for d, dev in enumerate(devs):
            for k in range(sub):
                rows_g = g_rows(d, k)
                r_h = _band_matrix(idx_full[rows_g] - lap_starts[d, k], w_full[rows_g],
                                   band_src_h)
                outs.append(_finalize_band(
                    lap0_ext[d], coarse_ext[d], int(lap_starts[d, k] - (d * own0 - h0t)),
                    int(ci0[d, k] - (d * own1 - h1t)), int(up_off[d, k]),
                    torch.from_numpy(r_h).to(dev), band_src_h, band_coarse_h, out_w,
                    w_plans.get(str(dev)), to_uint8,
                ))
    del lap0_ext, coarse_ext

    def bands_iter() -> Iterator[np.ndarray]:
        for d in range(S):
            for k in range(sub):
                take = min(sb, dev_out - k * sb, out_h - d * dev_out - k * sb)
                if take <= 0:
                    continue
                arr = outs[d * sub + k][:take].cpu().numpy()
                yield arr.astype(np.uint16) if to_uint8 == "uint16" else arr

    if as_iterator:
        return bands_iter()
    return np.concatenate(list(bands_iter()), axis=0)
