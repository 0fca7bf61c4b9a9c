"""SuperResolutionPipeline — the quality path (port of ``srs_tpu/pipeline.py``).

Stages, as the reference runs them for provider ``quality`` with routing,
per-scale selection and QA off:

1. tiling: mirror-pad the image and cut one [N, B, B, 3] batch;
2. super-resolution: the net ladder (e.g. [3, 3] for 720p -> 100MP) over
   the batch, in chunks sized for the card's memory;
3. blending: canvas-pyramid Laplacian blend with ramp profiles, level-0
   collapse deferred;
4. save: banded finalize (level-0 collapse, exact-size bicubic, quantize)
   streamed into the native TIFF writer.

Entry points run on ``PipelineConfig.device`` ("cuda" by default, which
raises without a card). Like the reference, ``process()`` never raises: a
failure returns ``PipelineResult(success=False, error_message=...)``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .config import RESOLUTION_PRESETS, ModelConfig
from .io.image import load_image
from .models.sr_module import SuperResolutionModule, scale_ladder
from .ops.blend import blend_finalize_banded, laplacian_fusion_tiles
from .ops.weights import layout_weight_profiles
from .tiling.tiling import TilingModule
from .utils.device import resolve_device

logger = logging.getLogger("srs_tpu_torch.pipeline")

__all__ = ["PipelineConfig", "PipelineResult", "SuperResolutionPipeline"]

# Bytes the SR ladder may hold per chunk. The reference caps a chunk at
# 7e9 bytes for a 16 GB TPU; an 80 GB card takes the 100MP preset's six
# 4608-px tiles in one chunk.
_CHUNK_BYTES = 40e9

# Features of the reference that this slice does not port, with the value
# that keeps them off.
_NOT_PORTED = {
    "enable_qa": False,
    "auto_route": False,
    "per_scale_selection": False,
    "provider": "quality",
    "blend_method": "laplacian",
}


@dataclass
class PipelineConfig:
    """Pipeline knobs (reference: ``srs_tpu.pipeline.PipelineConfig``).

    The fields the reference has but this slice does not port must keep
    their "off" values (``_NOT_PORTED``); routing, per-scale selection and
    QA default to off here, where the reference defaults them on.
    """

    block_size: int = 512
    overlap_ratio: float = 0.2
    padding_mode: str = "mirror"
    target_resolution: str = "100MP"
    blend_method: str = "laplacian"
    num_pyramid_levels: int = 6
    enable_qa: bool = False
    provider: str = "quality"
    quality_model: str = "edsr_xl"
    auto_route: bool = False
    per_scale_selection: bool = False
    ibp_steps: int = 8  # back-projection steps; only untrained nets use them
    bit_depth: int = 8  # 8 or 16
    compute_dtype: str = "bfloat16"
    params_dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self) -> None:
        for name, off in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"(ROADMAP Queue 1); use {off!r}"
                )
        if self.bit_depth not in (8, 16):
            raise ValueError(f"bit_depth must be 8 or 16, got {self.bit_depth}")


@dataclass
class PipelineResult:
    """(reference: ``srs_tpu.pipeline.PipelineResult``)."""

    success: bool
    output_path: Optional[str]
    processing_time: float
    total_blocks: int
    successful_blocks: int
    failed_blocks: int
    quality_score: Optional[float]
    quality_report: Optional[Dict[str, Any]]
    error_message: Optional[str]
    stage_times: Dict[str, float] = field(default_factory=dict)


def _timed(it, split: Dict[str, float], key: str):
    """Yield from ``it``, adding the seconds spent in ``next`` to ``split[key]``."""
    it = iter(it)
    while True:
        ts = time.time()
        item = next(it, None)
        split[key] += time.time() - ts
        if item is None:
            return
        yield item


class SuperResolutionPipeline:
    """tile -> SR -> blend -> save.

    ``weights`` maps ``(net name, scale)`` to a state dict
    (``models.registry.convert_flax_params`` or ``seeded_params``); nets
    with weights count as trained.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(self.config.device)
        self.tiling_module = TilingModule(
            block_size=self.config.block_size,
            overlap_ratio=self.config.overlap_ratio,
            padding_mode=self.config.padding_mode,
        )
        self.sr_module = SuperResolutionModule(
            ModelConfig(
                quality_model=self.config.quality_model,
                compute_dtype=self.config.compute_dtype,
                params_dtype=self.config.params_dtype,
            ),
            weights,
            self.device,
        )
        self.last_run_info: Dict[str, Any] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _calculate_target_size(
        self, original_size: Tuple[int, int], target_resolution: str
    ) -> Tuple[int, int]:
        """(width, height) of the output (reference pipeline.py:263-285)."""
        width, height = original_size
        aspect = width / height
        if target_resolution not in RESOLUTION_PRESETS:
            try:
                w, h = map(int, target_resolution.lower().split("x"))
                return (w, h)
            except ValueError:
                logger.warning("unparseable target resolution %r; using 100MP",
                               target_resolution)
                target_resolution = "100MP"
        tw, th = RESOLUTION_PRESETS[target_resolution]
        if aspect > tw / th:
            th = int(tw / aspect)
        else:
            tw = int(th * aspect)
        return (tw, th)

    def _upscale_batch(self, tiles: torch.Tensor, ladder: List[int]) -> torch.Tensor:
        """The net ladder over the tile batch, chunked to bound memory."""
        n = int(tiles.shape[0])
        final_block = int(tiles.shape[1]) * int(np.prod(ladder)) if ladder else int(tiles.shape[1])
        # ~160 B per output pixel: feature maps at the last step's input
        # resolution plus the float32 output (the reference's estimate).
        chunk = max(1, min(n, int(_CHUNK_BYTES // (final_block * final_block * 160))))
        outs = []
        for i in range(0, n, chunk):
            cur = tiles[i : i + chunk]
            for si, s in enumerate(ladder):
                last = si == len(ladder) - 1
                cur = self.sr_module.upscale_tiles(
                    cur, s, steps=self.config.ibp_steps if last else 0
                )
            outs.append(cur)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _blend(self, up_tiles: torch.Tensor, out_layout):
        """Laplacian canvas blend; returns (lap0, coarse) for the banded
        finalize, or the finished canvas when there is one level."""
        return laplacian_fusion_tiles(
            up_tiles, out_layout, layout_weight_profiles(out_layout),
            levels=self.config.num_pyramid_levels,
            clip_range=None,  # the banded save clips and quantizes
            collapse_last=False,
        )

    def process(
        self,
        input_path: Union[str, np.ndarray],
        output_path: str,
    ) -> PipelineResult:
        """Super-resolve one image (a path or an (H, W, 3) array in
        [0, 255]) to ``target_resolution`` and write ``output_path``
        (.tif/.tiff)."""
        start = time.time()
        stage_times: Dict[str, float] = {}
        try:
            with torch.inference_mode():
                return self._process(input_path, output_path, start, stage_times)
        except Exception as e:  # noqa: BLE001 - parity: never raise
            logger.exception("pipeline failed")
            return PipelineResult(
                success=False, output_path=None,
                processing_time=time.time() - start, total_blocks=0,
                successful_blocks=0, failed_blocks=0, quality_score=None,
                quality_report=None, error_message=f"{type(e).__name__}: {e}",
                stage_times=stage_times,
            )

    @contextlib.contextmanager
    def _stage(self, name: str, stage_times: Dict[str, float]):
        """Time one stage up to the end of its device work, under a
        ``stage:<name>`` profiler range."""
        t0 = time.time()
        with torch.profiler.record_function(f"stage:{name}"):
            yield
            self._sync()
        stage_times[name] = time.time() - t0

    def _process(self, input_path, output_path, start, stage_times) -> PipelineResult:
        if not output_path.lower().endswith((".tiff", ".tif")):
            raise NotImplementedError("only TIFF output is ported (streamed native writer)")
        with self._stage("tiling", stage_times):
            image = (
                load_image(input_path) if isinstance(input_path, str)
                else np.asarray(input_path, np.float32)
            )
            h, w = image.shape[:2]
            tw, th = self._calculate_target_size((w, h), self.config.target_resolution)
            ladder = scale_ladder(max(tw / w, th / h), trained=self.sr_module.trained_scales())
            layout, tiles = self.tiling_module.split_to_batch(image, self.device)

        with self._stage("super_resolution", stage_times):
            up_tiles = self._upscale_batch(tiles, ladder)
            del tiles
        net_scale = int(np.prod(ladder)) if ladder else 1
        self.last_run_info = {"ladder": list(ladder), "num_tiles": int(layout.num_tiles)}

        with self._stage("blending", stage_times):
            out_layout = layout.scaled(net_scale)
            canvas = self._blend(up_tiles, out_layout)
            del up_tiles

        split = {"fetch": 0.0, "write": 0.0}
        with self._stage("save", stage_times):
            t0 = time.time()
            lap0, coarse = canvas if isinstance(canvas, tuple) else (canvas, None)
            bands = blend_finalize_banded(
                lap0, coarse, th, tw, bands=8,
                crop_h=min(out_layout.padded_h, layout.image_h * net_scale),
                crop_w=min(out_layout.padded_w, layout.image_w * net_scale),
                to_uint8="uint16" if self.config.bit_depth == 16 else True,
                as_iterator=True,
            )
            self._sync()
            split["finalize"] = time.time() - t0
            from .io.native import TiffStreamWriter

            # Deflate is pure loss on a single-core host.
            writer = TiffStreamWriter(output_path, th, tw, bit_depth=self.config.bit_depth,
                                      compress=(os.cpu_count() or 1) > 1)
            try:
                for band in _timed(bands, split, "fetch"):
                    ts = time.time()
                    writer.write(band)
                    split["write"] += time.time() - ts
            finally:
                ts = time.time()
                writer.close()  # joins the deflate threads and writes the file
                split["close"] = time.time() - ts
        self.last_run_info["save_breakdown"] = split

        return PipelineResult(
            success=True,
            output_path=output_path,
            processing_time=time.time() - start,
            total_blocks=layout.num_tiles,
            successful_blocks=layout.num_tiles,
            failed_blocks=0,
            quality_score=None,
            quality_report=None,
            error_message=None,
            stage_times=stage_times,
        )
