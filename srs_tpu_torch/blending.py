"""BlendingModule, the public tile-fusion surface (port of
``srs_tpu/blending.py``).

The reference's method names, enums and return values: ``FusionMethod``,
``PoissonMode``, ``WeightType``, ``TileInfo``, ``OverlapRegion``, the
pyramids, ``laplacian_fusion``, ``multi_band_fusion``,
``weighted_average_fusion``, ``feather_blend``, ``gradient_domain_fusion``,
``poisson_fusion`` (the multigrid or the Jacobi clone), ``detect_seams``,
``repair_seams``, ``color_correction``, ``visualize_seams``, and the
functions ``create_tile_grid`` and ``compute_blend_quality``.

Images come in as numpy arrays (or tensors) in [0, 255] and go out as
float32 numpy arrays, as in the reference. The work runs on ``device``,
the card by default (raises without one): every pyrDown there is kernel
K1 and every pyrUp kernel K2 (``ops/cuda/pyramid.py``), the dense weight
pyramids at C = 1 and the multigrid clone's single-image levels included.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import BlendingConfig
from .ops import blend as B
from .ops import weights as W
from .ops.color import color_correction as _color_correction
from .ops.filters import sobel
from .ops.pyramid import (
    build_gaussian_pyramid,
    build_laplacian_pyramid,
    collapse_laplacian_pyramid,
)
from .ops.seam import Seam, detect_seams as _detect_seams_tiles, repair_seams as _repair
from .ops.tiles import extract_tiles
from .qa.metrics import ssim_global
from .tiling.geometry import TileLayout, compute_layout
from .utils.device import resolve_device

__all__ = [
    "FusionMethod",
    "PoissonMode",
    "WeightType",
    "TileInfo",
    "OverlapRegion",
    "BlendingModule",
    "create_tile_grid",
    "compute_blend_quality",
]


class FusionMethod(Enum):
    LAPLACIAN = "laplacian"
    POISSON = "poisson"
    WEIGHTED_AVERAGE = "weighted_average"
    FEATHER = "feather"
    GRADIENT_DOMAIN = "gradient_domain"
    MULTI_BAND = "multi_band"


class PoissonMode(Enum):
    NORMAL = "normal"
    MIXED = "mixed"
    MONOCHROME = "monochrome"


class WeightType(Enum):
    LINEAR = "linear"
    COSINE = "cosine"
    SIGMOID = "sigmoid"


@dataclass
class TileInfo:
    """A tile and its top-left (x, y) and grid (row, col)."""

    image: np.ndarray
    x: int
    y: int
    row: int
    col: int


@dataclass
class OverlapRegion:
    """The overlap of two neighbouring tiles, in each tile's coordinates."""

    tile1_idx: int
    tile2_idx: int
    x1_start: int
    y1_start: int
    x2_start: int
    y2_start: int
    width: int
    height: int
    direction: str


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    arr = np.ascontiguousarray(x, np.float32)
    if not arr.flags.writeable:  # torch refuses to share read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _layout_from_tiles(tiles: Sequence[TileInfo], device: torch.device
                       ) -> Tuple[TileLayout, torch.Tensor, np.ndarray]:
    """The layout of a uniform grid of square tiles (block, step and
    overlap inferred from their positions), the [N, B, B, C] batch in
    (row, col) order, and the tiles' own (y, x) positions, which the blend
    uses: they stay right where ``compute_layout`` would round the step."""
    block = tiles[0].image.shape[0]
    if not all(tuple(t.image.shape[:2]) == (block, block) for t in tiles):
        raise ValueError("the blend needs uniform square tiles; TilingModule.split_image "
                         "gives full-block layouts")
    nx = max(t.col for t in tiles) + 1
    ny = max(t.row for t in tiles) + 1
    xs = sorted({t.x for t in tiles})
    step = xs[1] - xs[0] if len(xs) > 1 else block
    overlap = block - step
    img_w = (nx - 1) * step + block
    img_h = (ny - 1) * step + block
    layout = compute_layout(img_w, img_h, block, max(overlap, 0) / block if block else 0.0)
    order = sorted(range(len(tiles)), key=lambda i: (tiles[i].row, tiles[i].col))
    batch = torch.stack([_as_tensor(tiles[i].image, device) for i in order])
    positions = np.array([[tiles[i].y, tiles[i].x] for i in order], np.int32)
    return layout, batch, positions


class BlendingModule:
    """Multi-algorithm tile fusion, seam detection and repair, and colour
    correction on ``device`` (the card by default)."""

    def __init__(
        self,
        config: Optional[BlendingConfig] = None,
        num_levels: int = 6,
        ssim_threshold: float = 0.95,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or BlendingConfig()
        # the reference's rule: an argument left at its default reads the config
        self.num_levels = num_levels if num_levels != 6 else self.config.pyramid_levels
        self.ssim_threshold = (
            ssim_threshold if ssim_threshold != 0.95 else self.config.seam_threshold
        )
        self.device = resolve_device(device)

    # -- pyramids -----------------------------------------------------------
    def build_gaussian_pyramid(self, image, levels: Optional[int] = None) -> List[torch.Tensor]:
        return build_gaussian_pyramid(_as_tensor(image, self.device), levels or self.num_levels)

    def build_laplacian_pyramid(self, image, levels: Optional[int] = None) -> List[torch.Tensor]:
        return build_laplacian_pyramid(_as_tensor(image, self.device), levels or self.num_levels)

    def collapse_laplacian_pyramid(self, pyramid) -> torch.Tensor:
        return collapse_laplacian_pyramid(pyramid)

    # -- inputs -------------------------------------------------------------
    def _prep(self, tiles, weight_type, weight_kind: str = "distance"):
        """(layout, batch, positions, dense [N, B, B] weights). Bare arrays
        are laid out edge to edge on a square grid, row by row."""
        if not isinstance(tiles[0], TileInfo):
            grid = int(np.ceil(np.sqrt(len(tiles))))
            th, tw = tiles[0].shape[0], tiles[0].shape[1]
            tiles = [TileInfo(t, (i % grid) * tw, (i // grid) * th, i // grid, i % grid)
                     for i, t in enumerate(tiles)]
        layout, batch, positions = _layout_from_tiles(tiles, self.device)
        wt = weight_type.value if isinstance(weight_type, WeightType) else weight_type
        weights = W.layout_weights(layout, kind=weight_kind, weight_type=wt)
        return layout, batch, positions, weights

    @staticmethod
    def _crop(canvas: torch.Tensor, output_shape, layout: TileLayout) -> np.ndarray:
        if output_shape is not None:
            canvas = canvas[: output_shape[0], : output_shape[1]]
        else:
            canvas = canvas[: layout.image_h, : layout.image_w]
        return canvas.cpu().numpy()

    # -- fusion -------------------------------------------------------------
    def laplacian_fusion(
        self,
        tiles: Sequence[Union[np.ndarray, TileInfo]],
        overlap_map: Optional[List[OverlapRegion]] = None,
        output_shape: Optional[Tuple[int, int]] = None,
        weight_type: WeightType = WeightType.COSINE,
    ) -> np.ndarray:
        """Burt-Adelson fusion with dense distance weights (their pyramid
        is K1 at C = 1): a float32 [0, 255] canvas cropped to
        ``output_shape``, else to the layout's image."""
        layout, batch, positions, weights = self._prep(tiles, weight_type)
        canvas = B.laplacian_fusion_tiles(batch, layout, levels=self.num_levels,
                                          weights=weights, positions=positions)
        return self._crop(canvas, output_shape, layout)

    def multi_band_fusion(self, tiles, output_shape=None) -> np.ndarray:
        """Laplacian fusion with sigmoid weights."""
        return self.laplacian_fusion(tiles, None, output_shape, WeightType.SIGMOID)

    def weighted_average_fusion(self, tiles, output_shape=None,
                                weight_type: WeightType = WeightType.LINEAR) -> np.ndarray:
        layout, batch, positions, weights = self._prep(tiles, weight_type)
        canvas = B.weighted_fusion_tiles(batch, weights, layout, clip_range=(0, 255),
                                         positions=positions)
        return self._crop(canvas, output_shape, layout)

    def feather_blend(self, tiles, output_shape=None) -> np.ndarray:
        """Weighted averaging with the cosine distance profile (for
        rectangular tiles the distance transform is the distance to the
        edge)."""
        return self.weighted_average_fusion(tiles, output_shape, WeightType.COSINE)

    def gradient_domain_fusion(self, tiles, output_shape=None) -> np.ndarray:
        """The tiles' gradients merged and integrated by the spectral
        Poisson solve."""
        layout, batch, positions, weights = self._prep(tiles, WeightType.COSINE)
        canvas = B.gradient_domain_fusion_tiles(batch, weights, layout, positions=positions)
        return self._crop(canvas, output_shape, layout)

    def poisson_fusion(
        self,
        base,
        overlay,
        mask,
        mode: PoissonMode = PoissonMode.NORMAL,
        solver: str = "multigrid",
    ) -> np.ndarray:
        """Seamless clone of ``overlay`` into ``base`` under ``mask``:
        ``solver="multigrid"`` (V-cycles; K1 restricts, K2 prolongs)
        converges at print scale; ``"jacobi"`` is the cheap relaxation for
        small patches. Clipped to [0, 255]."""
        m = mode.value if isinstance(mode, PoissonMode) else mode
        fn = B.seamless_clone_multigrid if solver == "multigrid" else B.seamless_clone
        out = fn(_as_tensor(base, self.device), _as_tensor(overlay, self.device),
                 _as_tensor(mask, self.device), mode=m)
        return np.clip(out.cpu().numpy(), 0, 255)

    # -- seams --------------------------------------------------------------
    def detect_seams(self, result, tiles: Sequence[Union[np.ndarray, TileInfo]],
                     window_size: int = 16, stride: int = 8) -> List[Seam]:
        """Windows where the fused ``result``, cut back into the tiles,
        falls under the SSIM threshold against them."""
        layout, batch, positions, _ = self._prep(tiles, WeightType.COSINE)
        res = _as_tensor(result, self.device)
        canvas = torch.zeros((layout.padded_h, layout.padded_w, batch.shape[-1]),
                             dtype=torch.float32, device=self.device)
        part = res[: layout.padded_h, : layout.padded_w]
        canvas[: part.shape[0], : part.shape[1]] = part
        result_tiles = extract_tiles(canvas, layout, positions)
        return _detect_seams_tiles(result_tiles, batch, layout, window_size, stride,
                                   self.ssim_threshold)

    def repair_seams(self, result, seams: Sequence[Seam],
                     tiles: Optional[Sequence[Union[np.ndarray, TileInfo]]] = None) -> np.ndarray:
        """Blur medium seams; clone high ones from the nearest tile when
        ``tiles`` are given. Clipped to [0, 255]."""
        src_tiles = layout = None
        if tiles is not None:
            layout, src_tiles, _, _ = self._prep(tiles, WeightType.COSINE)
        out = _repair(_as_tensor(result, self.device), seams, src_tiles, layout)
        return np.clip(out.cpu().numpy(), 0, 255)

    # -- colour -------------------------------------------------------------
    def color_correction(self, image, reference_tile, method: str = "histogram",
                         local_filter: bool = True) -> np.ndarray:
        """Match ``image``'s colours to ``reference_tile``: float32 [0, 255]."""
        return _color_correction(_as_tensor(image, self.device),
                                 _as_tensor(reference_tile, self.device),
                                 method, local_filter).cpu().numpy()

    def visualize_seams(self, image: np.ndarray, seams: Sequence[Seam],
                        thickness: int = 2) -> np.ndarray:
        """The seams' rectangles drawn on a copy of ``image``, coloured by
        severity (host numpy)."""
        out = np.array(image, copy=True)
        colors = {"high": (255, 0, 0), "medium": (255, 255, 0), "low": (0, 255, 0)}
        for s in seams:
            c = colors[s.severity]
            y0, y1 = max(0, s.y), min(out.shape[0], s.y + s.height)
            x0, x1 = max(0, s.x), min(out.shape[1], s.x + s.width)
            t = thickness
            out[y0 : y0 + t, x0:x1] = c
            out[max(0, y1 - t) : y1, x0:x1] = c
            out[y0:y1, x0 : x0 + t] = c
            out[y0:y1, max(0, x1 - t) : x1] = c
        return out


def create_tile_grid(images: List[np.ndarray], grid_shape: Tuple[int, int],
                     overlap: int = 100) -> Tuple[List[TileInfo], List[OverlapRegion]]:
    """``TileInfo``s of ``images`` on a ``grid_shape`` (rows, cols) grid
    that overlaps by ``overlap`` px, and the overlap of each pair of
    4-neighbours."""
    rows, cols = grid_shape
    tile_h, tile_w = images[0].shape[:2]
    infos = [
        TileInfo(img, (i % cols) * (tile_w - overlap), (i // cols) * (tile_h - overlap),
                 i // cols, i % cols)
        for i, img in enumerate(images)
    ]
    regions: List[OverlapRegion] = []
    for i, t1 in enumerate(infos):
        for j in range(i + 1, len(infos)):
            t2 = infos[j]
            if abs(t1.row - t2.row) + abs(t1.col - t2.col) != 1:
                continue
            x_min, y_min = max(t1.x, t2.x), max(t1.y, t2.y)
            x_max = min(t1.x + t1.image.shape[1], t2.x + t2.image.shape[1])
            y_max = min(t1.y + t1.image.shape[0], t2.y + t2.image.shape[0])
            if x_max > x_min and y_max > y_min:
                regions.append(OverlapRegion(
                    i, j, x_min - t1.x, y_min - t1.y, x_min - t2.x, y_min - t2.y,
                    x_max - x_min, y_max - y_min,
                    "horizontal" if t1.row == t2.row else "vertical"))
    return infos, regions


def compute_blend_quality(result, tiles: Sequence[np.ndarray],
                          positions: Sequence[Tuple[int, int]],
                          device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Per-tile global SSIM of the result against each tile at its (y, x)
    (mean, min and population std) and the mean and std of the result's
    Sobel gradient magnitude."""
    dev = resolve_device(device)
    res = _as_tensor(result, dev)
    scores = []
    for tile, (y, x) in zip(tiles, positions):
        h, w = tile.shape[:2]
        roi = res[y : y + h, x : x + w]
        t = _as_tensor(tile, dev)[: roi.shape[0], : roi.shape[1]]
        scores.append(ssim_global(roi, t))
    scores = torch.stack(scores).cpu().numpy().astype(np.float64)
    gray = res if res.dim() == 2 else torch.movedim(res, -1, 0)
    gx, gy = sobel(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    grad = torch.stack([mag.mean(), torch.std(mag, correction=0)]).cpu().numpy()
    return {
        "mean_ssim": float(np.mean(scores)),
        "min_ssim": float(np.min(scores)),
        "std_ssim": float(np.std(scores)),
        "mean_gradient": float(grad[0]),
        "gradient_discontinuity": float(grad[1]),
    }
