"""SuperResolutionPipeline (port of ``srs_tpu/pipeline.py``).

Stages, as the reference runs them (pipeline.py:896-1392), for the
providers ``quality``, ``fast``, ``hybrid``, ``fusion`` and ``bicubic``:

1. tiling: load the image and upload it once; for ``quality``,
   ``hybrid`` and ``fusion``, route it (degradation estimate, then the
   SR-gain probe, which may send the job to the ``shrink`` or ``bicubic``
   ladder with a per-job alpha); choose the ladder from the nets the
   provider serves; mirror-pad and cut one [N, B, B, 3] batch;
2. super-resolution: the ladder (e.g. [3, 3] for 720p -> 100MP) over the
   batch, in chunks sized for the card's memory: per step the provider's
   nets (``models/sr_module.upscale_tiles``: the fusion members' weighted
   sum, the dihedral self-ensemble, the hybrid polish, IBP for untrained
   nets), and on the last step the prompt-conditioned polish when the
   job names a template category;
3. blending: by ``blend_method``: the canvas-pyramid Laplacian blend with
   ramp profiles (level-0 collapse deferred unless a post-pass needs the
   canvas), the same with dense distance weights (``multi_band``),
   weighted or feather averaging, or gradient-domain fusion; seams may
   follow the content (``content_aware``); then the optional seam repair
   and colour correction on the collapsed canvas;
4. quality assessment (``enable_qa``): the save bands are computed first,
   then an input-size proxy of the output is finalized on the device and
   scored against the input (PSNR, SSIM, MS-SSIM, LPIPS, downsample
   comparison) and on its own (NIQE, BRISQUE, ...);
5. save: TIFF bands stream into the native writer (with QA off the
   banded finalize runs here); other formats go through ``save_image``
   (PNG, or JPEG where PIL is installed); with QA on, crops of the output
   get a full-resolution no-reference panel and the report is written
   beside the output as ``<out>_qa_report.json``.

Routing and the probe are best-effort, as in the reference: an exception
there keeps the configured net and provider, and its text is recorded in
``last_run_info["routing"]["errors"]``.

Entry points run on ``PipelineConfig.device`` ("cuda" by default, which
raises without a card). Like the reference, ``process()`` never raises: a
failure returns ``PipelineResult(success=False, error_message=...)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .config import RESOLUTION_PRESETS, ModelConfig, QualityAssessmentConfig
from .io.image import load_image, save_image
from .models import routing
from .models.lpips import LPIPSMetric
from .models.prompts import PromptTemplateManager
from .models.sr_module import SuperResolutionModule, scale_ladder
from .ops.blend import (
    blend_finalize_banded,
    gradient_domain_fusion_tiles,
    laplacian_fusion_tiles,
    weighted_fusion_tiles,
)
from .ops.color import color_correction
from .ops.seam import detect_seams, repair_seams
from .ops.tiles import extract_tiles
from .ops.weights import layout_weight_profiles, layout_weights
from .qa import noref
from .qa.module import QualityAssessmentModule
from .qa.niqe import brisque_scores, niqe_scores
from .tiling.content import ContentAnalyzer
from .tiling.content_layout import content_aware_weight_profiles, content_aware_weights
from .tiling.tiling import TilingModule
from .utils.device import resolve_device

logger = logging.getLogger("srs_tpu_torch.pipeline")

__all__ = ["PipelineConfig", "PipelineResult", "SuperResolutionPipeline"]

# Bytes the SR ladder may hold per chunk. The reference caps a chunk at
# 7e9 bytes for a 16 GB TPU; an 80 GB card takes the 100MP preset's six
# 4608-px tiles in one chunk on the quality path.
_CHUNK_BYTES = 40e9
# Bytes per output pixel of a chunk: feature maps at the last step's input
# resolution plus the float32 output (the reference's estimate, 160);
# the shrink provider's bicubic arm; a float32 accumulator and member
# output for the fusion sum and the self-ensemble; the hybrid polish's
# 64- and 32-channel bfloat16 maps at output resolution; and three live
# 48-channel bfloat16 maps of the conditioned polish there.
_PX_BYTES, _SHRINK_PX_BYTES, _MULTIPASS_PX_BYTES = 160, 40, 24
_POLISH_PX_BYTES, _COND_PX_BYTES = 192, 3 * 96

# Providers whose jobs are routed (degradation estimate and SR-gain
# probe), as in the reference (pipeline.py:932,954-956).
_ROUTED_PROVIDERS = ("quality", "hybrid", "fusion")

# Options of the reference that this port does not serve yet, with the
# values it does serve.
_NOT_PORTED = {
    "provider": ("quality", "fast", "hybrid", "bicubic", "fusion"),
    "blend_method": ("laplacian", "multi_band", "weighted", "weighted_average", "feather",
                     "gradient", "gradient_domain", "poisson"),
    "sr_gain_route": ("shrink", "bicubic"),
}
# zssr fine-tunes the net on each input: it comes with the training slice.
_TRAINING_SLICE = "zssr trains the net per image (ROADMAP Queue 1: the training slice)"


@dataclass
class PipelineConfig:
    """Pipeline knobs (reference: ``srs_tpu.pipeline.PipelineConfig``),
    with the reference's defaults. Options outside ``_NOT_PORTED``'s
    values raise ``NotImplementedError``."""

    block_size: int = 512
    overlap_ratio: float = 0.2
    padding_mode: str = "mirror"
    target_resolution: str = "100MP"
    blend_method: str = "laplacian"
    num_pyramid_levels: int = 6
    enable_qa: bool = True
    provider: str = "quality"  # quality | fast | hybrid | bicubic | fusion
    quality_model: str = "edsr_xl"
    fast_model: str = "espcn"  # the fast net (provider fast)
    # Probe each input's noise and blur (damaged inputs serve the robust
    # net when it is trained) and its SR gain over bicubic.
    auto_route: bool = True
    robust_model: str = "edsr_l_robust"
    # Below this probe gain (dB over bicubic) the job serves sr_gain_route:
    # "shrink" (bicubic + alpha * (net - bicubic), alpha fitted on the
    # probe's crops) or "bicubic".
    sr_gain_floor: float = 0.0
    sr_gain_route: str = "shrink"
    # Texture-tier nets the shrink route may serve instead of the
    # configured one when the probe predicts them better.
    texture_models: Tuple[str, ...] = ()
    # Each ladder step serves the panel-best trained net at its scale.
    per_scale_selection: bool = True
    # Average every net pass over the 8 dihedral tile transforms (EDSR's
    # "+" mode; 8x the SR compute).
    self_ensemble: bool = False
    # A prompt template category (models/prompts.py) for the conditioned
    # polish after the ladder; None leaves the output unconditioned.
    prompt_category: Optional[str] = None
    # Directory whose EVAL.json selection reads before the packaged one.
    checkpoint_dir: Optional[str] = None
    ibp_steps: int = 8  # back-projection steps; only untrained nets use them
    content_aware: bool = False  # seams avoid faces, text and salient regions
    bit_depth: int = 8  # 8 or 16 (16-bit needs a TIFF output)
    enable_seam_repair: bool = False  # post-blend seam detection and repair
    enable_color_correction: bool = False  # histogram-match the output to the input
    seam_threshold: float = 0.95
    compute_dtype: str = "bfloat16"
    params_dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self) -> None:
        for name, served in _NOT_PORTED.items():
            value = getattr(self, name)
            if value not in served:
                why = _TRAINING_SLICE if value == "zssr" else "ROADMAP Queue 1"
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet ({why}); use one of {served!r}")
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
    """tile -> SR -> blend -> assess -> save.

    ``weights`` maps ``(net name, scale)`` to a state dict
    (``models.registry.convert_flax_params`` or ``seeded_params``); nets
    with weights count as trained. ``lpips_params`` maps ``"vgg"`` /
    ``"alex"`` to LPIPS feature state dicts
    (``models.lpips.convert_lpips_params``); a net without one gets
    seeded features.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
        lpips_params: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
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
                fast_model=self.config.fast_model,
                auto_route=self.config.auto_route,
                robust_model=self.config.robust_model,
                per_scale_selection=self.config.per_scale_selection,
                self_ensemble=self.config.self_ensemble,
                compute_dtype=self.config.compute_dtype,
                params_dtype=self.config.params_dtype,
                checkpoint_dir=self.config.checkpoint_dir,
            ),
            weights,
            self.device,
        )
        self.quality_module: Optional[QualityAssessmentModule] = None
        if self.config.enable_qa:
            self.quality_module = QualityAssessmentModule(
                QualityAssessmentConfig(), self.device, LPIPSMetric(lpips_params, self.device))
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

    def _trained_scales(self, model: Optional[str] = None) -> Optional[set]:
        """Scales whose net the configured provider serves trained; None (no
        preference) for ``bicubic`` (reference pipeline.py:288-299)."""
        if self.config.provider == "bicubic":
            return None
        return self.sr_module.trained_scales(self.config.provider, model=model)

    def _route(self, image: torch.Tensor, scale_total: float):
        """Degradation routing, the ladder, and the SR-gain probe
        (reference pipeline.py:924-1022); routing and the probe run for the
        providers in ``_ROUTED_PROVIDERS`` only. Returns (ladder, routed
        model, routed provider, alpha, record); the record also goes to
        ``last_run_info["routing"]``."""
        cfg, sr = self.config, self.sr_module
        info: Dict[str, Any] = {"degradation": None, "sr_gain": None, "alpha": None,
                                "errors": []}
        routed = cfg.provider in _ROUTED_PROVIDERS
        routed_model: Optional[str] = None
        if routed:
            try:
                routed_model, est = sr.route_for(image)
                if est is not None:
                    info["degradation"] = dataclasses.asdict(est)
            except Exception as e:  # noqa: BLE001 - routing is best-effort
                routed_model = None
                info["errors"].append(f"routing: {type(e).__name__}: {e}")
                logger.warning("degradation routing failed: %s", e)
        ladder = scale_ladder(scale_total, trained=self._trained_scales(routed_model))
        routed_provider: Optional[str] = None
        alpha: Optional[float] = None
        if cfg.auto_route and routed and routed_model is None and ladder:
            try:
                probe_model = sr.resolve_ladder_models([int(ladder[0])], cfg.provider)[0]
                args = dict(weights=sr.weights, device=self.device, nets=sr.probe_nets)
                sr_gain, shrink_alpha = None, None
                if cfg.sr_gain_route == "shrink":
                    res = routing.probe_sr_alpha(image, probe_model, int(ladder[0]), **args)
                    if res is not None:
                        sr_gain, shrink_alpha = res
                else:
                    sr_gain = routing.probe_sr_gain(image, probe_model, int(ladder[0]), **args)
                info["sr_gain"], info["alpha"] = sr_gain, shrink_alpha
                if sr_gain is not None and sr_gain < cfg.sr_gain_floor:
                    routed_provider = cfg.sr_gain_route
                    if routed_provider == "shrink":
                        alpha = round(float(shrink_alpha if shrink_alpha is not None else 0.0), 3)
                        # a candidate must be trained at every ladder scale
                        cands = tuple(c for c in cfg.texture_models
                                      if all(sr.is_trained(c, int(s)) for s in set(ladder)))
                        if cands:
                            best = routing.best_shrink_candidate(
                                image, (probe_model,) + cands, int(ladder[0]), **args)
                            if best is not None and best[0] != probe_model:
                                routed_model, alpha = best[0], round(best[2], 3)
                    logger.info("SR-gain probe: %s x%d measures %+.2f dB vs bicubic -> %s%s",
                                probe_model, int(ladder[0]), sr_gain, routed_provider,
                                f" (alpha {alpha:.3f})" if alpha is not None else "")
            except Exception as e:  # noqa: BLE001 - the probe is best-effort
                routed_provider, alpha = None, None
                info["errors"].append(f"probe: {type(e).__name__}: {e}")
                logger.warning("SR-gain probe failed: %s", e)
        return ladder, routed_model, routed_provider, alpha, info

    def _upscale_batch(self, tiles: torch.Tensor, ladder: List[int],
                       provider: Optional[str] = None, model: Optional[str] = None,
                       alpha: Optional[float] = None,
                       category: Optional[str] = None) -> torch.Tensor:
        """The ladder over the tile batch, chunked to bound memory: each
        step through ``upscale_tiles``, with ``category``'s conditioned
        polish on the last step (on the tiles when the ladder is empty).
        ``alpha`` is this job's shrinkage (the shrink provider only).

        The reference runs its multi-pass providers (fusion, the
        self-ensemble) through a staged program when every step is trained
        (pipeline.py:471-540), a workaround for the TPU compiler; its
        result is ``upscale_tiles``' step by step, which the port runs."""
        provider = provider or self.config.provider
        sr = self.sr_module
        sr.build_nets(ladder, provider, model, category)  # before the first chunk
        conditioned = sr.conditions(category)
        n = int(tiles.shape[0])
        final_block = int(tiles.shape[1]) * int(np.prod(ladder)) if ladder else int(tiles.shape[1])
        multipass = self.config.self_ensemble or provider == "fusion"
        polished = provider == "hybrid" and sr.is_trained("espcn_polish", 1)
        per_px = (_PX_BYTES + _SHRINK_PX_BYTES * (provider == "shrink")
                  + _MULTIPASS_PX_BYTES * multipass + _POLISH_PX_BYTES * polished
                  + _COND_PX_BYTES * conditioned)
        chunk = max(1, min(n, int(_CHUNK_BYTES // (final_block * final_block * per_px))))
        outs = []
        for i in range(0, n, chunk):
            cur = tiles[i : i + chunk]
            for si, s in enumerate(ladder):
                last = si == len(ladder) - 1
                cur = sr.upscale_tiles(
                    cur, s, provider=provider,
                    steps=self.config.ibp_steps if last else 0, model=model,
                    category=category if last else None,
                    alpha=1.0 if alpha is None else alpha,
                )
            if not ladder:
                cur = sr._conditioned(cur, category)
            outs.append(cur)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _run_info(self, ladder, layout, routed_provider, routed_model, alpha, route_info,
                  category) -> Dict[str, Any]:
        """What the SR stage served (reference pipeline.py:1108-1176): the
        provider (``fusion`` only where a step fused its members; a fusion
        that resolved no members at any step served ``quality`` and says
        so), the net of each step, and per step the [net, passes] it ran
        (8 passes for a dihedral "+" pass; the hybrid polish as
        ``espcn_polish``)."""
        cfg, sr = self.config, self.sr_module
        asked = routed_provider or cfg.provider
        served = asked
        step_models = step_members = None
        model_used = routed_model
        if asked != "bicubic":
            if asked == "fusion" and (routed_model is not None
                                      or not any(sr._fusion_for(int(s)) for s in ladder)):
                served = "quality"
            step_models = sr.resolve_ladder_models(ladder, served, routed_model)
            step_members = [[list(m) for m in sr.step_members(int(s), served, routed_model)]
                            for s in ladder]
            model_used = routed_model or (step_models[0] if step_models else
                                          cfg.fast_model if served == "fast"
                                          else cfg.quality_model)
        route_info.update(provider=served, model=routed_model, ladder_models=step_models)
        return {
            "ladder": list(ladder),
            "num_tiles": int(layout.num_tiles),
            "block": int(layout.block),
            "provider": served,
            "requested_provider": asked,
            "model": model_used,
            "models": step_models,
            "step_members": step_members,
            "self_ensemble": cfg.self_ensemble,
            "prompt_category": category,
            "conditioned": sr.conditions(category),
            "sr_gain_probe": route_info["sr_gain"],
            "sr_gain_alpha": alpha if served == "shrink" else None,
            "routing": route_info,
        }

    def _zone(self, image: np.ndarray, out_layout, net_scale: int) -> np.ndarray:
        """The input's forbidden zone, repeated to the output scale and cut
        or zero-padded to the output canvas (reference pipeline.py:635-640)."""
        zone, boxes = ContentAnalyzer(device=self.device).forbidden_zone_map(image)
        self.last_run_info["content"] = {**boxes, "forbidden_share": float(zone.mean())}
        zone_up = np.repeat(np.repeat(zone, net_scale, axis=0), net_scale, axis=1)
        pad_h = out_layout.padded_h - zone_up.shape[0]
        pad_w = out_layout.padded_w - zone_up.shape[1]
        zone_up = np.pad(zone_up, ((0, max(0, pad_h)), (0, max(0, pad_w))))
        return zone_up[: out_layout.padded_h, : out_layout.padded_w]

    def _content_aware(self, build, out_layout, image, net_scale, fallback: str):
        """``build(layout, zone)`` when content-aware seams are on; None when
        they are off or the analysis fails (best-effort, as in the
        reference: the error text goes to ``last_run_info["content"]``)."""
        if not self.config.content_aware or image is None:
            return None
        try:
            return build(out_layout, self._zone(image, out_layout, net_scale))
        except Exception as e:  # noqa: BLE001 - the reference falls back
            logger.warning("content-aware weighting failed; using %s: %s", fallback, e)
            self.last_run_info.setdefault("content", {})["error"] = f"{type(e).__name__}: {e}"
            return None

    def _weight_profiles(self, out_layout, image: Optional[np.ndarray], net_scale: int):
        """Separable (wy, wx) blend profiles: content-aware when enabled,
        ramp otherwise (reference pipeline.py:625-644)."""
        profiles = self._content_aware(content_aware_weight_profiles, out_layout, image,
                                       net_scale, "ramp")
        return profiles if profiles is not None else layout_weight_profiles(out_layout)

    def _blend_weights(self, out_layout, kind: str, image: Optional[np.ndarray],
                       net_scale: int, weight_type: str = "cosine") -> np.ndarray:
        """Dense [N, B, B] weights: content-aware when enabled, else
        ``kind`` (reference pipeline.py:646-664)."""
        weights = self._content_aware(content_aware_weights, out_layout, image, net_scale,
                                      kind)
        if weights is not None:
            return weights
        if kind == "distance":
            return layout_weights(out_layout, kind="distance", weight_type=weight_type)
        return layout_weights(out_layout, kind="ramp")

    def _blend(self, up_tiles: torch.Tensor, out_layout,
               image: Optional[np.ndarray] = None, net_scale: int = 1):
        """The configured blend (reference pipeline.py:666-717). The
        Laplacian blend returns (lap0, coarse) for the banded finalize
        unless a post-pass needs the collapsed canvas; every other path
        returns the canvas."""
        cfg = self.config
        method = cfg.blend_method
        if method == "laplacian":
            defer = not (cfg.enable_seam_repair or cfg.enable_color_correction)
            return laplacian_fusion_tiles(
                up_tiles, out_layout, self._weight_profiles(out_layout, image, net_scale),
                levels=cfg.num_pyramid_levels,
                clip_range=None,  # the banded save clips and quantizes
                collapse_last=not defer,
            )
        if method == "multi_band":
            weights = self._blend_weights(out_layout, "distance", image, net_scale, "sigmoid")
            return laplacian_fusion_tiles(up_tiles, out_layout, weights=weights,
                                          levels=cfg.num_pyramid_levels)
        if method in ("weighted", "weighted_average", "feather"):
            kind = "ramp" if method != "feather" else "distance"
            return weighted_fusion_tiles(
                up_tiles, self._blend_weights(out_layout, kind, image, net_scale), out_layout)
        return gradient_domain_fusion_tiles(
            up_tiles, self._blend_weights(out_layout, "ramp", image, net_scale), out_layout)

    def _repair(self, canvas: torch.Tensor, up_tiles: torch.Tensor, out_layout) -> torch.Tensor:
        """Seam detection on the canvas cut back into tiles against the
        upscaled tiles, and repair of the medium and high ones (reference
        pipeline.py:1189-1205). Counts and seconds go to
        ``last_run_info["seam_repair"]``."""
        stats: Dict[str, Any] = {}
        seams = detect_seams(extract_tiles(canvas, out_layout), up_tiles, out_layout,
                             threshold=self.config.seam_threshold, stats=stats)
        severity = [s.severity for s in seams]
        stats.update(seams=len(seams), **{k: severity.count(k) for k in ("high", "medium", "low")})
        bad = [s for s in seams if s.severity != "low"]
        if bad:
            logger.info("repairing %d seams", len(bad))
            canvas = repair_seams(canvas, bad, up_tiles, out_layout, stats=stats)
        self.last_run_info["seam_repair"] = stats
        return canvas

    @staticmethod
    def _sample_fullres_crops(band: np.ndarray, row0: int, total_h: int,
                              crops: List[np.ndarray], max_crops: int = 6,
                              crop: int = 256) -> None:
        """Collect output crops from the save bands as they stream
        (reference pipeline.py:784-802)."""
        if len(crops) >= max_crops:
            return
        bh, bw = band.shape[:2]
        cs = min(crop, bh, bw)
        if cs < 16:
            return
        for frac in (0.2, 0.5, 0.8):
            r = int(total_h * frac)
            if row0 <= r < row0 + bh and len(crops) < max_crops:
                y = max(0, min(r - row0, bh - cs))
                for xf in (0.25, 0.7):
                    x = max(0, min(int(bw * xf), bw - cs))
                    crops.append(np.array(band[y : y + cs, x : x + cs]))

    def _fullres_noref(self, crops: List[np.ndarray]) -> Dict[str, Any]:
        """NIQE, BRISQUE, sharpness and contrast averaged over full-resolution
        output crops, each shape group scored in one batch on the device
        (reference pipeline.py:804-846)."""
        acc: Dict[str, List[float]] = {}
        by_shape: Dict[Tuple[int, ...], List[np.ndarray]] = {}
        for c in crops:
            arr = c.astype(np.float32)
            if c.dtype == np.uint16:
                arr = arr / 257.0
            by_shape.setdefault(arr.shape, []).append(arr)
        for group in by_shape.values():
            batch = torch.from_numpy(np.stack(group)).to(self.device)
            raw = noref.no_reference_metrics(batch)
            host = {k: v.cpu().numpy().astype(np.float64) for k, v in raw.items()}
            nq, bq = niqe_scores(batch), brisque_scores(batch)
            for i in range(len(group)):
                acc.setdefault("niqe", []).append(
                    float(nq[i]) if nq[i] is not None else float(host["niqe"][i]))
                acc.setdefault("brisque", []).append(
                    float(bq[i]) if bq[i] is not None else float(host["brisque"][i]))
                acc.setdefault("sharpness", []).append(float(host["sharpness"][i]))
                acc.setdefault("contrast", []).append(float(host["contrast"][i]))
        out: Dict[str, Any] = {f"fullres_{k}": float(np.mean(v)) for k, v in acc.items()}
        out["fullres_crops"] = len(crops)
        return out

    def process(
        self,
        input_path: Union[str, np.ndarray],
        output_path: str,
        prompt: Optional[str] = None,
    ) -> PipelineResult:
        """Super-resolve one image (a path or an (H, W, 3) array in
        [0, 255]) to ``target_resolution`` and write ``output_path`` (TIFF,
        PNG, or JPEG where PIL is installed), plus ``<out>_qa_report.json``
        with QA on. A ``prompt`` that names a template category
        (``models/prompts.py``) steers this job's conditioned polish in
        place of ``prompt_category``; other prompts change nothing
        (reference pipeline.py:896-912)."""
        start = time.time()
        stage_times: Dict[str, float] = {}
        category = (prompt if prompt in PromptTemplateManager.TEMPLATES
                    else self.config.prompt_category)
        try:
            with torch.inference_mode():
                return self._process(input_path, output_path, start, stage_times, category)
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

    def _write_tiff(self, path: str, bands, th: int, tw: int, split: Dict[str, float],
                    crops: Optional[List[np.ndarray]]) -> None:
        """Stream the bands into the native TIFF writer; ``crops``, when
        given, collects the QA panel's crops on the way."""
        from .io.native import TiffStreamWriter

        # Deflate is pure loss on a single-core host.
        writer = TiffStreamWriter(path, th, tw, bit_depth=self.config.bit_depth,
                                  compress=(os.cpu_count() or 1) > 1)
        try:
            row0 = 0
            for band in _timed(bands, split, "fetch"):
                ts = time.time()
                writer.write(band)
                split["write"] += time.time() - ts
                if crops is not None:
                    self._sample_fullres_crops(band, row0, th, crops)
                row0 += band.shape[0]
        finally:
            ts = time.time()
            writer.close()  # joins the deflate threads and writes the file
            split["close"] = time.time() - ts

    def _process(self, input_path, output_path, start, stage_times,
                 category: Optional[str]) -> PipelineResult:
        cfg = self.config
        with self._stage("tiling", stage_times):
            image = (
                load_image(input_path) if isinstance(input_path, str)
                else np.asarray(input_path, np.float32)
            )
            h, w = image.shape[:2]
            tw, th = self._calculate_target_size((w, h), self.config.target_resolution)
            # One upload: routing, tiling and QA read this copy.
            image_dev = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device)
            ladder, routed_model, routed_provider, alpha, route_info = self._route(
                image_dev, max(tw / w, th / h))
            layout, tiles = self.tiling_module.split_to_batch(image_dev, self.device)

        with self._stage("super_resolution", stage_times):
            up_tiles = self._upscale_batch(tiles, ladder, routed_provider, routed_model, alpha,
                                           category)
            del tiles
        net_scale = int(np.prod(ladder)) if ladder else 1
        self.last_run_info = self._run_info(ladder, layout, routed_provider, routed_model,
                                            alpha, route_info, category)

        with self._stage("blending", stage_times):
            out_layout = layout.scaled(net_scale)
            # The blend leaves up_tiles as they are: seam repair reads them after.
            canvas = self._blend(up_tiles, out_layout, image, net_scale)
            if cfg.enable_seam_repair:
                canvas = self._repair(canvas, up_tiles, out_layout)
            del up_tiles
            if cfg.enable_color_correction:
                canvas = color_correction(canvas, image_dev, method="histogram",
                                          local_filter=False)
        lap0, coarse = canvas if isinstance(canvas, tuple) else (canvas, None)
        crop = dict(crop_h=min(out_layout.padded_h, layout.image_h * net_scale),
                    crop_w=min(out_layout.padded_w, layout.image_w * net_scale))
        quant = "uint16" if self.config.bit_depth == 16 else True

        split: Dict[str, float] = {"fetch": 0.0, "write": 0.0}

        def save_bands():
            t0 = time.time()
            bands = blend_finalize_banded(lap0, coarse, th, tw, bands=8, to_uint8=quant,
                                          as_iterator=True, **crop)
            self._sync()
            split["finalize"] = time.time() - t0
            return bands

        quality_report: Optional[Dict[str, Any]] = None
        bands = None
        if self.quality_module is not None:
            with self._stage("quality_assessment", stage_times):
                bands = save_bands()  # first, as the reference dispatches them
                # The input-size proxy never leaves the device.
                small = blend_finalize_banded(lap0, coarse, h, w, bands=2, to_uint8=False,
                                              as_device=True, **crop).clamp_(0, 255)
                fr = self.quality_module.evaluate_full_reference(image_dev, small)
                nr = self.quality_module.evaluate_no_reference(small)
                quality_report = {**fr, **nr}

        with self._stage("save", stage_times):
            if bands is None:
                bands = save_bands()
            crops: List[np.ndarray] = []
            if output_path.lower().endswith((".tiff", ".tif")):
                self._write_tiff(output_path, bands, th, tw, split,
                                 crops if quality_report is not None else None)
            else:
                # reference pipeline.py:1340-1354: one array through save_image
                out = np.concatenate(list(_timed(bands, split, "fetch")), axis=0)
                if quality_report is not None:
                    self._sample_fullres_crops(out, 0, th, crops)
                if out.dtype == np.uint16:  # PNG and JPEG are 8-bit here
                    out = (out // 257).astype(np.uint8)
                ts = time.time()
                save_image(output_path, out)
                split["write"] = time.time() - ts
            if quality_report is not None:
                ts = time.time()
                if crops:
                    quality_report.update(self._fullres_noref(crops))
                report_path = output_path.rsplit(".", 1)[0] + "_qa_report.json"
                with open(report_path, "w", encoding="utf-8") as f:
                    json.dump(quality_report, f, indent=2, ensure_ascii=False)
                split["fullres_qa"] = time.time() - ts
        self.last_run_info["save_breakdown"] = split

        return PipelineResult(
            success=True,
            output_path=output_path,
            processing_time=time.time() - start,
            total_blocks=layout.num_tiles,
            successful_blocks=layout.num_tiles,
            failed_blocks=0,
            quality_score=quality_report.get("overall_score") if quality_report else None,
            quality_report=quality_report,
            error_message=None,
            stage_times=stage_times,
        )
