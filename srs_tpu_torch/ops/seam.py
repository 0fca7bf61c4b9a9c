"""Seam detection and repair (port of ``srs_tpu/ops/seam.py``).

A seam is a window where the fused canvas, cut back into tiles, departs
from the tile that was blended in: the windowed SSIM of the two over a
16-px window at stride 8, below a threshold. Flagged windows merge with
their neighbours; each merged seam gets a fixed 64-px repair patch
(Gaussian smoothing at medium severity, a mixed-gradient Poisson clone
from the nearest source tile at high severity).

The results are the reference's; the execution shape is the port's own:

- the flagged windows are found and merged with numpy instead of one
  Python object per window (:func:`_merge_adjacent` keeps the reference's
  greedy walk, which the tests hold the vectorised merge to);
- the patches are applied in waves: a patch joins the wave after the
  latest earlier patch it overlaps, so the patches of one wave overlap
  neither each other nor any patch still to come before them, and the
  canvas ends as the reference's one-after-another loop leaves it
  (which :func:`repair_seams` called once per seam reproduces).

Detection and repair are the spans ``blending/seam_detect`` and
``blending/seam_repair`` of the current job's record
(``utils/profiling.span``), whose seconds the ``stats`` dicts also get.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..tiling.geometry import TileLayout
from ..utils import profiling
from .blend import seamless_clone
from .colorspace import rgb_to_gray
from .filters import gaussian_blur

__all__ = ["Seam", "windowed_ssim_map", "detect_seams", "repair_seams"]

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2
# cv2.GaussianBlur(15, 15) with sigma 0 takes sigma from ksize: 2.6
_BLUR_SIGMA = 0.3 * ((15 - 1) * 0.5 - 1) + 0.8


@dataclass
class Seam:
    """Detected seam region (reference seam.py:35-58)."""

    x: int
    y: int
    width: int
    height: int
    ssim_score: float

    @property
    def severity(self) -> str:
        if self.ssim_score < 0.85:
            return "high"
        if self.ssim_score < 0.92:
            return "medium"
        return "low"

    @property
    def repair_method(self) -> str:
        return {
            "high": "poisson_refinement",
            "medium": "increase_blend_width",
            "low": "none",
        }[self.severity]


def _box_means(x: torch.Tensor, win: int, stride: int) -> torch.Tensor:
    """Mean over win x win windows at ``stride`` (VALID) of [N, H, W]."""
    return F.avg_pool2d(x[:, None], win, stride)[:, 0]


def windowed_ssim_map(
    result_tiles: torch.Tensor,
    source_tiles: torch.Tensor,
    win: int = 16,
    stride: int = 8,
) -> torch.Tensor:
    """[N, Wy, Wx] SSIM with the global statistics of each window
    between two [N, B, B, C] batches (gray)."""
    x = rgb_to_gray(result_tiles.float())
    y = rgb_to_gray(source_tiles.float())
    sx = _box_means(x, win, stride)
    sy = _box_means(y, win, stride)
    sxx = _box_means(x * x, win, stride)
    syy = _box_means(y * y, win, stride)
    sxy = _box_means(x * y, win, stride)
    vx = sxx - sx * sx
    vy = syy - sy * sy
    cov = sxy - sx * sy
    return ((2 * sx * sy + _C1) * (2 * cov + _C2)) / ((sx * sx + sy * sy + _C1) * (vx + vy + _C2))


def _merge_adjacent(seams: List[Seam], distance_threshold: int) -> List[Seam]:
    """The reference's greedy walk over seams sorted by (y, x): a seam
    joins the group of the one before it when they lie closer than
    ``distance_threshold``."""
    if not seams:
        return []
    seams_sorted = sorted(seams, key=lambda s: (s.y, s.x))
    merged: List[Seam] = []
    group = [seams_sorted[0]]
    for s in seams_sorted[1:]:
        last = group[-1]
        if np.hypot(s.x - last.x, s.y - last.y) < distance_threshold:
            group.append(s)
        else:
            merged.append(_merge_group(group))
            group = [s]
    merged.append(_merge_group(group))
    return merged


def _merge_group(group: List[Seam]) -> Seam:
    if len(group) == 1:
        return group[0]
    x0 = min(s.x for s in group)
    y0 = min(s.y for s in group)
    x1 = max(s.x + s.width for s in group)
    y1 = max(s.y + s.height for s in group)
    return Seam(x0, y0, x1 - x0, y1 - y0, float(np.mean([s.ssim_score for s in group])))


def _flagged_windows(smap: np.ndarray, layout: TileLayout, threshold: float, stride: int):
    """(x, y, score) of every window under ``threshold`` in global
    coordinates, tile by tile, row-major in each tile."""
    t, wy, wx = np.nonzero(smap < threshold)
    pos = np.asarray(layout.positions, np.int64)
    return (pos[t, 1] + wx * stride, pos[t, 0] + wy * stride,
            smap[t, wy, wx].astype(np.float64))


def _merge_windows(x: np.ndarray, y: np.ndarray, score: np.ndarray, size: int) -> List[Seam]:
    """:func:`_merge_adjacent` on windows of side ``size`` at (x, y), in
    numpy: after the stable (y, x) sort, the previous seam is always the
    last of the current group, so a group ends where two neighbours in
    the order lie ``size`` or more apart."""
    if len(x) == 0:
        return []
    order = np.lexsort((x, y))
    x, y, score = x[order], y[order], score[order]
    gap = np.hypot(np.diff(x).astype(np.float64), np.diff(y).astype(np.float64)) >= size
    starts = np.concatenate([[0], np.nonzero(gap)[0] + 1])
    x0 = np.minimum.reduceat(x, starts)
    y0 = np.minimum.reduceat(y, starts)
    x1 = np.maximum.reduceat(x, starts) + size
    y1 = np.maximum.reduceat(y, starts) + size
    counts = np.diff(np.concatenate([starts, [len(x)]]))
    means = [float(np.mean(score[a : a + n])) for a, n in zip(starts, counts)]
    return [Seam(int(a), int(b), int(c - a), int(d - b), m)
            for a, b, c, d, m in zip(x0, y0, x1, y1, means)]


def detect_seams(
    result_tiles: torch.Tensor,
    source_tiles: torch.Tensor,
    layout: TileLayout,
    window_size: int = 16,
    stride: int = 8,
    threshold: float = 0.95,
    stats: Optional[Dict[str, float]] = None,
) -> List[Seam]:
    """Windows whose SSIM between the fused result (cut back into tiles)
    and the source tiles is under ``threshold``, in global coordinates,
    merged within ``window_size`` px. ``stats``, when given, receives the
    flagged-window count and the seconds of detection and merge."""
    with profiling.span("blending/seam_detect") as detect:
        smap = windowed_ssim_map(result_tiles, source_tiles, window_size, stride).cpu().numpy()
        x, y, score = _flagged_windows(smap, layout, threshold, stride)
    t1 = time.perf_counter()
    seams = _merge_windows(x, y, score, window_size)
    if stats is not None:
        stats.update(flagged_windows=int(len(x)), detect_s=detect.seconds,
                     merge_s=time.perf_counter() - t1)
    return seams


def _patch_index(y: torch.Tensor, x: torch.Tensor, patch: int):
    """Index tensors that cut [K, patch, patch] windows at (y, x) from an
    (H, W, C) array."""
    r = torch.arange(patch, device=y.device)
    return (y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]


def _blur_patch(p: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(15 x 15) of [K, patch, patch, C] patches, each on
    its own (REFLECT_101 at the patch's border)."""
    return gaussian_blur(p.permute(0, 3, 1, 2), 15, _BLUR_SIGMA).permute(0, 2, 3, 1)


def _poisson_patch(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Mixed-gradient clone of [K, patch, patch, C] source patches into the
    canvas patches ``dst``, 200 Jacobi iterations, with a 2-px rim of the
    canvas kept as the Dirichlet border."""
    patch = dst.shape[1]
    mask = torch.zeros((patch, patch, 1), dtype=torch.float32, device=dst.device)
    mask[2:-2, 2:-2] = 1.0
    return seamless_clone(dst, src, mask, mode="mixed", iters=200)


def _plan(seams: Sequence[Seam], source_tiles, layout, h: int, w: int, patch: int):
    """Per repaired seam: patch origin (cy, cx), and for a Poisson patch
    the source tile and its patch origin (t, py, px); t = -1 blurs."""
    rows = []
    for s in seams:
        if s.severity == "low":
            continue
        cy = min(max(0, s.y + s.height // 2 - patch // 2), h - patch)
        cx = min(max(0, s.x + s.width // 2 - patch // 2), w - patch)
        if s.severity == "medium" or source_tiles is None or layout is None:
            rows.append((cy, cx, -1, 0, 0))
        else:
            t = _best_tile_for(s, layout)
            ty, tx = int(layout.positions[t][0]), int(layout.positions[t][1])
            py = min(max(0, cy - ty), layout.block - patch)
            px = min(max(0, cx - tx), layout.block - patch)
            rows.append((cy, cx, t, py, px))
    return np.asarray(rows, np.int64).reshape(-1, 5)


def _waves(cy: np.ndarray, cx: np.ndarray, h: int, w: int, patch: int) -> np.ndarray:
    """Wave of each patch: one after the latest wave among the earlier
    patches it overlaps (0 when it overlaps none). A pixel map holds the
    latest wave that covered each pixel so far."""
    latest = np.full((h, w), -1, np.int32)
    wave = np.empty(len(cy), np.int32)
    for i, (y, x) in enumerate(zip(cy, cx)):
        region = latest[y : y + patch, x : x + patch]
        wave[i] = region.max() + 1
        region[...] = wave[i]
    return wave


def repair_seams(
    canvas: torch.Tensor,
    seams: Sequence[Seam],
    source_tiles: Optional[torch.Tensor] = None,
    layout: Optional[TileLayout] = None,
    patch: int = 64,
    stats: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Repair seams on the fused (H, W, C) canvas, in the order given:
    medium severity smooths a ``patch`` window centred on the seam; high
    severity clones the window's mixed gradients from the nearest source
    tile (Jacobi, 200 iterations, a 2-px Dirichlet rim). Low-severity
    seams are skipped. Waves of non-overlapping patches give the result
    of repairing the seams one after another. ``stats`` receives the wave
    count and the seconds taken."""
    with profiling.span("blending/seam_repair") as repair:
        canvas, waves = _repair_in_waves(canvas, seams, source_tiles, layout, patch)
        if stats is not None and canvas.device.type == "cuda":
            torch.cuda.synchronize(canvas.device)
    if stats is not None:
        stats.update(waves=waves, repair_s=repair.seconds)
    return canvas


def _repair_in_waves(canvas, seams, source_tiles, layout, patch: int):
    """:func:`repair_seams`' work: the repaired float copy of ``canvas``
    and the number of waves."""
    h, w = int(canvas.shape[0]), int(canvas.shape[1])
    canvas = canvas.float().clone()
    plan = _plan(seams, source_tiles, layout, h, w, patch)
    if len(plan) == 0:
        return canvas, 0
    dev = canvas.device
    waves = _waves(plan[:, 0], plan[:, 1], h, w, patch)
    src = source_tiles.float() if source_tiles is not None else None
    for k in range(int(waves.max()) + 1):
        cur = torch.from_numpy(plan[waves == k]).to(dev)
        ri, ci = _patch_index(cur[:, 0], cur[:, 1], patch)
        dst = canvas[ri, ci]
        out = torch.empty_like(dst)
        blur = cur[:, 2] < 0
        if bool(blur.any()):
            out[blur] = _blur_patch(dst[blur])
        if not bool(blur.all()):
            clone = ~blur
            c = cur[clone]
            si, sj = _patch_index(c[:, 3], c[:, 4], patch)
            src_p = src[c[:, 2][:, None, None], si, sj]
            out[clone] = _poisson_patch(dst[clone], src_p)
        canvas[ri, ci] = out
    return canvas, int(waves.max()) + 1


def _best_tile_for(seam: Seam, layout: TileLayout) -> int:
    """Tile whose centre is nearest the seam's centre."""
    cy = seam.y + seam.height / 2
    cx = seam.x + seam.width / 2
    pos = np.asarray(layout.positions, np.float64)
    centers = pos + layout.block / 2
    return int(np.argmin((centers[:, 0] - cy) ** 2 + (centers[:, 1] - cx) ** 2))
