"""SuperResolutionPipeline (port of ``srs_tpu/pipeline.py``).

Stages, as the reference runs them (pipeline.py:896-1392), for the
providers ``quality``, ``fast``, ``hybrid``, ``fusion``, ``bicubic`` and
``zssr``, and the reference's remote provider names ``seedream`` (served
as ``quality``: the quality nets, routed) and ``veimagex`` (served as
``fast``):

1. tiling: load the image and upload it once; for ``quality``,
   ``seedream``, ``hybrid`` and ``fusion``, route it (degradation estimate, then the
   SR-gain probe, which may send the job to the ``shrink`` or ``bicubic``
   ladder with a per-job alpha); choose the ladder from the nets the
   provider serves; mirror-pad and cut one [N, B, B, 3] batch;
2. super-resolution: for ``zssr`` (asked for, or the SR-gain probe's
   route with ``sr_gain_route="zssr"``) a copy of the base net is first
   tuned on the input itself for ``zssr_steps`` steps
   (``SuperResolutionModule.zssr_prepare``), outside the retry ladder, as
   the reference does; then the tiles are booked as scheduler tasks
   (``scheduler/scheduler.py``); with ``enable_checkpoint`` the tile
   store is probed first and a full hit skips the nets, a partial hit
   upscales only the missing tiles. Otherwise the ladder (e.g. [3, 3] for
   720p -> 100MP) runs over the batch, in chunks sized for the card's
   memory: per step the provider's nets (``models/sr_module.upscale_tiles``:
   the fusion members' weighted sum, the dihedral self-ensemble, the
   hybrid polish, IBP for untrained nets), and on the last step the
   prompt-conditioned polish when the job names a template category. A
   failure (a CUDA OOM, say) goes through the scheduler's ladder
   (``_run_stage2``): retries, then degradation (tile 256 / overlap 16
   re-cut on the card, the fallback provider, the net scale x0.7);
   after a recompute the upscaled tiles are written to the store;
3. blending: by ``blend_method``: the canvas-pyramid Laplacian blend with
   ramp profiles (level-0 collapse deferred unless a post-pass needs the
   canvas), the same with dense distance weights (``multi_band``),
   weighted or feather averaging, or gradient-domain fusion; seams may
   follow the content (``content_aware``); then the optional seam repair
   and colour correction on the collapsed canvas;
4. quality assessment (``enable_qa``): the save bands are computed first,
   then an input-size proxy of the output is finalized on the device and
   scored against the input (PSNR, SSIM, MS-SSIM, LPIPS, downsample
   comparison) and on its own (NIQE, BRISQUE, ...); a job with
   ``roi_regions`` adds the commercial metrics of the proxy and of each
   region of interest (boxes in input coordinates);
5. save: TIFF bands stream into the native writer (with QA off the
   banded finalize runs here); other formats go through ``save_image``
   (PNG, or JPEG where PIL is installed); with QA on, crops of the output
   get a full-resolution no-reference panel and the report is written
   beside the output as ``<out>_qa_report.json``.

``cancel()`` stops a job at the next stage boundary (before SR, blending,
QA and save). ``process_batch`` runs jobs in the scheduler's priority
order; with ``max_concurrent > 1`` on a thread pool whose device stages
(SR to QA) one semaphore serializes, so one job's save overlaps the next
job's SR and blend. Every job shares the card's default stream.

With ``mesh_shape`` (or a ``MeshTileDispatcher`` set on
``pipe.dispatcher``: a virtual mesh of one card) the SR stage splits the
tile batch over the mesh's ``data`` axis, each shard on its device, and
the Laplacian blend without post-passes keeps the canvas row-sharded over
``space`` (``parallel/halo.py``) through a sharded banded finalize of the
save bands and the QA proxy (``parallel/finalize.py``);
``last_run_info["mesh"]`` records the shape, the distinct devices,
whether the sharded blend ran, the halo copies' bytes and whether a
finalize gathered the canvas (reference pipeline.py:245-250, 363-386,
666-689, 1227-1272).

Routing and the probe are best-effort, as in the reference: an exception
there keeps the configured net and provider, and its text is recorded in
``last_run_info["routing"]["errors"]``.

Entry points run on ``PipelineConfig.device`` ("cuda" by default, which
raises without a card). Like the reference, ``process()`` never raises: a
failure returns ``PipelineResult(success=False, error_message=...)``.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .blending import BlendingModule
from .config import RESOLUTION_PRESETS, ModelConfig, SystemConfig
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
from .ops.tiles import extract_tiles, pad_image
from .ops.weights import layout_weight_profiles, layout_weights
from .parallel.dispatch import MeshTileDispatcher
from .parallel.finalize import ShardedCanvas, sharded_finalize_banded
from .parallel.mesh import make_mesh
from .qa import noref
from .qa.module import QualityAssessmentModule
from .qa.niqe import brisque_scores, niqe_scores
from .scheduler.scheduler import AgentScheduler, Task, TaskStatus, VIPLevel
from .tiling.content import ContentAnalyzer
from .tiling.content_layout import content_aware_weight_profiles, content_aware_weights
from .tiling.geometry import compute_layout
from .tiling.tiling import TilingModule
from .utils.device import resolve_device

logger = logging.getLogger("srs_tpu_torch.pipeline")

__all__ = ["PipelineCancelled", "PipelineConfig", "PipelineResult", "SuperResolutionPipeline"]

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
_ROUTED_PROVIDERS = ("quality", "seedream", "hybrid", "fusion")

# Options of the reference that this port does not serve yet, with the
# values it does serve.
_NOT_PORTED = {
    "provider": ("quality", "fast", "hybrid", "bicubic", "fusion", "zssr", "seedream",
                 "veimagex"),
    "blend_method": ("laplacian", "multi_band", "weighted", "weighted_average", "feather",
                     "gradient", "gradient_domain", "poisson"),
    "sr_gain_route": ("shrink", "bicubic", "zssr"),
}


# ``qa_device`` names: the accelerator's (the reference's default "tpu")
# mean the pipeline's device; "cpu" runs QA on the CPU.
_QA_DEVICES = ("tpu", "gpu", "cuda", "cpu")


class PipelineCancelled(RuntimeError):
    """Raised at a stage boundary after ``SuperResolutionPipeline.cancel()``."""


@dataclass
class PipelineConfig:
    """Pipeline knobs (reference: ``srs_tpu.pipeline.PipelineConfig``),
    with the reference's defaults. Options outside ``_NOT_PORTED``'s
    values raise ``NotImplementedError``. The ``volc_*`` credentials are
    accepted and ignored, as in the reference (no remote engine), and so
    are ``seedream_strength`` and ``seedream_steps`` (the latter keys the
    tile store, as in the reference)."""

    block_size: int = 512
    overlap_ratio: float = 0.2
    padding_mode: str = "mirror"
    target_resolution: str = "100MP"
    seedream_strength: float = 0.5
    seedream_steps: int = 50
    blend_method: str = "laplacian"
    num_pyramid_levels: int = 6
    enable_qa: bool = True
    # Where QA runs: "tpu", "gpu" or "cuda" (the accelerator) mean the
    # pipeline's device, "cpu" the CPU; another name raises.
    qa_device: str = "tpu"
    # quality | fast | hybrid | bicubic | fusion | zssr | seedream (quality)
    # | veimagex (fast)
    provider: str = "quality"
    quality_model: str = "edsr_xl"
    fast_model: str = "espcn"  # the fast net (provider fast)
    # Probe each input's noise and blur (damaged inputs serve the robust
    # net when it is trained) and its SR gain over bicubic.
    auto_route: bool = True
    robust_model: str = "edsr_l_robust"
    # Below this probe gain (dB over bicubic) the job serves sr_gain_route:
    # "shrink" (bicubic + alpha * (net - bicubic), alpha fitted on the
    # probe's crops), "bicubic", or "zssr" (the net tuned on the input
    # first, zssr_steps steps).
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
    # Directory whose EVAL.json selection reads before the packaged one,
    # and whose trained nets ({name}_x{scale}.pt, models/train.py) count
    # as trained.
    checkpoint_dir: Optional[str] = None
    zssr_steps: int = 150  # steps zssr tunes the net on each input
    ibp_steps: int = 8  # back-projection steps; only untrained nets use them
    content_aware: bool = False  # seams avoid faces, text and salient regions
    bit_depth: int = 8  # 8 or 16 (16-bit needs a TIFF output)
    # The scheduler's agent pool and its dispatch limit.
    max_agents: int = 60
    max_concurrent: int = 30
    # Keep the SR stage's upscaled tiles (uint8) in the tile store and
    # resume from them on a re-run; the key holds every knob that changes
    # them.
    enable_checkpoint: bool = False
    enable_seam_repair: bool = False  # post-blend seam detection and repair
    enable_color_correction: bool = False  # histogram-match the output to the input
    seam_threshold: float = 0.95
    compute_dtype: str = "bfloat16"
    params_dtype: str = "float32"
    device: str = "cuda"
    # Device mesh, e.g. {"data": 4, "space": 2}; None = one device. On
    # "cuda" it spans the cards torch sees (a mesh larger than that
    # raises); on "cpu" the CPU repeated to the mesh's size (a -1 axis
    # takes 1).
    mesh_shape: Optional[Dict[str, int]] = None
    volc_ak: str = ""
    volc_sk: str = ""
    volc_region: str = ""

    def __post_init__(self) -> None:
        for name, served in _NOT_PORTED.items():
            value = getattr(self, name)
            if value not in served:
                raise NotImplementedError(f"{name}={value!r} is not ported yet (ROADMAP "
                                          f"Queue 1); use one of {served!r}")
        if self.bit_depth not in (8, 16):
            raise ValueError(f"bit_depth must be 8 or 16, got {self.bit_depth}")
        if self.qa_device not in _QA_DEVICES:
            raise ValueError(f"qa_device must be one of {_QA_DEVICES}, got {self.qa_device!r}")


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


def _canonical(device: torch.device) -> torch.device:
    """``device`` with the current card's index where "cuda" names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
    (``models.lpips.convert_lpips_params``); a net without one gets the
    store's trained features.

    The stage modules are built from ``SystemConfig.from_env()``, as the
    reference does: the environment's ``BLOCK_SIZE`` and ``OVERLAP_RATIO``
    apply where the pipeline's block size and overlap are at the tiling
    module's defaults (2048 and 0.2), and the blending and QA modules take
    the tree's sections.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
        lpips_params: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(self.config.device)
        sys_cfg = SystemConfig.from_env()
        self.tiling_module = TilingModule(
            block_size=self.config.block_size,
            overlap_ratio=self.config.overlap_ratio,
            padding_mode=self.config.padding_mode,
            config=sys_cfg.tiling,
            device=self.device,
        )
        self.blending_module = BlendingModule(
            config=sys_cfg.blending, num_levels=self.config.num_pyramid_levels,
            device=self.device)
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
            qa_device = (torch.device("cpu") if self.config.qa_device == "cpu"
                         else self.device)
            lpips = (LPIPSMetric(lpips_params, qa_device) if sys_cfg.quality.enable_lpips
                     else None)
            self.quality_module = QualityAssessmentModule(sys_cfg.quality, qa_device, lpips)
        # The scheduler books each job's tiles as tasks and drives the SR
        # stage's retry and degradation ladder; its agents are the CUDA
        # devices (on the CPU, the one device the pipeline runs on).
        self.scheduler = AgentScheduler(max_agents=self.config.max_agents,
                                        max_concurrent=self.config.max_concurrent,
                                        initial_agents=0)
        self.scheduler.attach_mesh_devices(None if self.device.type == "cuda" else [self.device])
        # The mesh: built from mesh_shape unless one was set on the
        # instance (a virtual mesh on one card is handed in so, after
        # construction: pipe.dispatcher = MeshTileDispatcher(...)).
        if getattr(self, "dispatcher", None) is None:
            self.dispatcher: Optional[MeshTileDispatcher] = None
            if self.config.mesh_shape:
                devices = None
                if self.device.type != "cuda":
                    n = int(np.prod([v for v in self.config.mesh_shape.values() if v > 0]))
                    devices = [self.device] * n
                self.dispatcher = MeshTileDispatcher(make_mesh(self.config.mesh_shape, devices))
        # (device, net key) -> (source net, its copy there): the nets a
        # mesh shard on another device serves, copied once per device
        self._net_copies: Dict[Tuple[str, Any], Tuple[torch.nn.Module, torch.nn.Module]] = {}
        self._sched_tlock = threading.Lock()
        # Checked at every stage boundary; process_batch shares it between
        # its workers.
        self._cancel_event = threading.Event()
        # process_batch: serializes the device stages (SR to QA) of its jobs.
        self._stage_sem: Optional[threading.Semaphore] = None
        self.last_run_info: Dict[str, Any] = {}

    def cancel(self) -> None:
        """Ask the running job(s) to stop: ``process()`` returns a failed
        result at the next stage boundary."""
        self._cancel_event.set()

    def _check_cancel(self, stage: str) -> None:
        if self._cancel_event.is_set():
            raise PipelineCancelled(f"cancelled before {stage}")

    def __enter__(self) -> "SuperResolutionPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    async def __aenter__(self) -> "SuperResolutionPipeline":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.scheduler.stop()

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

    def _trained_scales(self, provider: Optional[str] = None,
                        model: Optional[str] = None) -> Optional[set]:
        """Scales whose net ``provider`` (the configured one by default)
        serves trained; None (no preference) for ``bicubic`` (reference
        pipeline.py:288-299)."""
        provider = provider or self.config.provider
        if provider == "bicubic":
            return None
        return self.sr_module.trained_scales(provider, model=model)

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
        ladder = scale_ladder(scale_total, trained=self._trained_scales(model=routed_model))
        routed_provider: Optional[str] = None
        alpha: Optional[float] = None
        if cfg.auto_route and routed and routed_model is None and ladder:
            try:
                probe_model = self._ladder_models([int(ladder[0])])[0]
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
        step through ``upscale_tiles`` with the provider
        ``_serving_provider`` gives, with ``category``'s conditioned polish
        on the last step (on the tiles when the ladder is empty).
        ``alpha`` is this job's shrinkage (the shrink provider only).

        With a mesh, every provider but ``bicubic`` runs the ladder through
        ``dispatcher.run_tiled`` (reference pipeline.py:363-386): each data
        shard on its device, chunked the same way (the shards of a virtual
        mesh share one card's memory)."""
        sr = self.sr_module
        # The provider's own nets are built before the staged rule reads
        # them, as in the reference (pipeline.py:337-354), and the serving
        # provider's before the first chunk.
        provider = provider or self.config.provider
        sr.build_nets(ladder, provider, model, category)
        provider = self._serving_provider(ladder, provider, model,
                                          square=tiles.shape[1] == tiles.shape[2])
        sr.build_nets(ladder, provider, model, category)
        conditioned = sr.conditions(category)
        final_block = int(tiles.shape[1]) * int(np.prod(ladder)) if ladder else int(tiles.shape[1])
        multipass = self.config.self_ensemble or provider == "fusion"
        polished = provider == "hybrid" and sr.is_trained("espcn_polish", 1)
        per_px = (_PX_BYTES + _SHRINK_PX_BYTES * (provider == "shrink")
                  + _MULTIPASS_PX_BYTES * multipass + _POLISH_PX_BYTES * polished
                  + _COND_PX_BYTES * conditioned)
        chunk = max(1, int(_CHUNK_BYTES // (final_block * final_block * per_px)))

        def run_ladder(batch: torch.Tensor) -> torch.Tensor:
            mod = self._sr_for(batch.device)
            outs = []
            for i in range(0, int(batch.shape[0]), chunk):
                cur = batch[i : i + chunk]
                for si, s in enumerate(ladder):
                    last = si == len(ladder) - 1
                    cur = mod.upscale_tiles(
                        cur, s, provider=provider,
                        steps=self.config.ibp_steps if last else 0, model=model,
                        category=category if last else None,
                        alpha=1.0 if alpha is None else alpha,
                    )
                if not ladder:
                    cur = mod._conditioned(cur, category)
                outs.append(cur)
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

        if self.dispatcher is not None and provider != "bicubic":
            return self.dispatcher.run_tiled(run_ladder, tiles)
        return run_ladder(tiles)

    def _sr_for(self, device: torch.device) -> SuperResolutionModule:
        """The SR module that serves tiles on ``device``: the pipeline's on
        its own device; on another, a view of it whose built nets (the
        zssr-tuned ones too) are copies there, each made once per device
        and source net (``_net_copies``)."""
        sr = self.sr_module
        device = _canonical(device)
        if device == _canonical(self.device):
            return sr
        view = copy.copy(sr)
        view.device = device

        def copied(key, net):
            hit = self._net_copies.get((str(device), key))
            if hit is None or hit[0] is not net:
                hit = (net, copy.deepcopy(net).to(device))
                self._net_copies[(str(device), key)] = hit
            return hit[1]

        view._nets = {k: copied(k, net) for k, net in sr._nets.items()}
        view.zssr_nets = {s: copied(("zssr", s), net) for s, net in sr.zssr_nets.items()}
        return view

    def _step_trained(self, scale: int, provider: str, model: Optional[str]) -> bool:
        """What serves the step in the reference's staged program is
        trained: its resolved fusion members, or the resolved quality net
        (reference pipeline.py:399-406). The reference reads the quality
        net's state from its cache of built nets (sr_module.py:281-285), so
        a quality net counts once it has been built on this module: always
        for the quality-tier providers, whose nets are built first, and for
        ``fast`` only after a quality-tier attempt degraded to it."""
        sr = self.sr_module
        if provider == "fusion" and model is None and sr._fusion_for(int(scale)) is not None:
            return True
        key = sr._key("quality", int(scale), model)
        return key in sr._nets and sr.is_trained(*key)

    def _serving_provider(self, ladder: Sequence[int], provider: str, model: Optional[str],
                          square: bool = True) -> str:
        """The provider ``upscale_tiles`` runs for ``provider``. The
        reference sends square tiles to its staged multi-pass program when
        the ladder is not empty, the provider is not bicubic, zssr or
        shrink, the self-ensemble is on or the provider is fusion with no
        pinned model, and every step is trained (pipeline.py:395-415;
        ``_step_trained``). That program serves the fusion members, else
        ``model`` or the resolved quality net, each ensembled when the
        self-ensemble is on or its name ends in "+", then clips; the
        conditioned polish follows the ladder, with no IBP and no hybrid
        polish (pipeline.py:520-539): ``upscale_tiles`` with ``fusion`` (no
        pinned model) or ``quality`` serves the same. Its chunking and
        7e9-byte cap bend around the TPU compiler and are not ported.
        Otherwise ``provider`` itself, and always under a mesh: the
        reference's mesh branch returns before the staged rule
        (pipeline.py:363-386)."""
        if self.dispatcher is not None:
            return provider
        if (square and ladder and provider not in ("bicubic", "zssr", "shrink")
                and (self.config.self_ensemble or (provider == "fusion" and model is None))
                and all(self._step_trained(s, provider, model) for s in ladder)):
            return "fusion" if provider == "fusion" and model is None else "quality"
        return provider

    # -- stage 2 with failure recovery (reference pipeline.py:542-623) ------
    # Where a failed provider degrades to; any other to bicubic.
    _FALLBACK_PROVIDERS = {"quality": "fast", "hybrid": "fast", "zssr": "fast",
                           "seedream": "fast", "fusion": "fast",
                           "fast": "bicubic", "veimagex": "bicubic"}

    def _run_stage2(self, image_dev: torch.Tensor, tiles: torch.Tensor, ladder: List[int],
                    layout, tasks: List[Task], provider: str, model: Optional[str],
                    alpha: Optional[float], category: Optional[str], max_attempts: int = 10):
        """The SR batch under the scheduler's retry -> degradation ladder
        (reference pipeline.py:547-623). A failed attempt (a CUDA OOM, say)
        reports every task to ``handle_failure``: the first
        ``max_retries`` failures re-run unchanged; then
        ``_apply_degradation`` rewrites the tasks and the batch is re-cut
        on the card at the degraded tile size and overlap (256/16), served
        by the fallback provider without the routed model, on the ladder
        for the degraded scale (x0.7, floor 1.5; the banded finalize still
        reaches the target size). Returns (up_tiles, layout, ladder,
        provider, model, attempts, degradations).

        A failed attempt's tensors are held by its traceback only, so they
        are freed when the ``except`` block is left, before the failure is
        booked and the next attempt starts. The allocator has already
        returned its cached blocks to the card before it raised an OOM,
        so no ``empty_cache`` runs between attempts."""
        degradations = 0
        for attempt in range(max_attempts):
            try:
                up_tiles = self._upscale_batch(tiles, ladder, provider, model, alpha, category)
                self._sync()
                return up_tiles, layout, ladder, provider, model, attempt + 1, degradations
            except Exception as e:  # noqa: BLE001 - any device failure enters the ladder
                if attempt == max_attempts - 1:
                    raise
                error = f"{type(e).__name__}: {e}"
            logger.warning("SR batch failed (attempt %d): %s", attempt + 1, error)
            self._run_async(self._report_failure(tasks, error))
            degraded = [t for t in tasks if t.status == TaskStatus.DEGRADED]
            if degraded and degradations < len(self._FALLBACK_PROVIDERS):
                degradations += 1
                task_cfg = degraded[0].tile_config
                block = int(task_cfg.get("tile_size", 256))
                overlap_px = int(task_cfg.get("overlap", 16))
                if task_cfg.get("use_fallback_engine"):
                    provider = self._FALLBACK_PROVIDERS.get(provider, "bicubic")
                    model = None  # the routed net is a quality-tier pick
                ladder = scale_ladder(float(degraded[0].scale_factor),
                                      trained=self._trained_scales(provider))
                layout = compute_layout(int(image_dev.shape[1]), int(image_dev.shape[0]), block,
                                        overlap_px / max(block, 1),
                                        step_multiple=self.tiling_module.step_multiple)
                tiles = extract_tiles(
                    pad_image(image_dev, layout, self.tiling_module.padding_mode.value), layout)
                logger.warning("degraded: tile %d/%d, provider %s, ladder %s",
                               block, overlap_px, provider, ladder)
        raise AssertionError("unreachable")  # the last attempt re-raises

    async def _report_failure(self, tasks: List[Task], error: str) -> None:
        for t in tasks:
            await self.scheduler.handle_failure(t, error)

    # -- scheduler bookkeeping (reference pipeline.py:848-894) --------------
    def _book_tasks(self, n: int, output_path: str, scale: float) -> List[Task]:
        tasks = [Task(input_path=f"tile_{i}", output_path=output_path, scale_factor=scale,
                      has_edge_dependency=True) for i in range(n)]

        async def run():
            for t in tasks:
                await self.scheduler.submit_task(t)
            await self.scheduler._dispatch_tasks()

        self._run_async(run())
        return tasks

    def _book_done(self, tasks: List[Task]) -> None:
        async def run():
            for t in tasks:
                await self.scheduler.collect_result(
                    t.task_id, {"output_path": "", "width": 0, "height": 0, "color_mode": "RGB"})

        self._run_async(run())

    def _run_async(self, coro) -> None:
        """Run ``coro`` to its end, or schedule it when called inside a
        running event loop (as the reference does)."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # One loop at a time across process_batch's workers: each
            # asyncio.run makes a loop, and the scheduler's asyncio locks
            # must not be awaited from two loops at once.
            with self._sched_tlock:
                asyncio.run(coro)
            return
        asyncio.ensure_future(coro)

    # -- SR resume (reference pipeline.py:719-780) --------------------------
    def _ladder_models(self, ladder: Sequence[int], model: Optional[str] = None,
                       provider: Optional[str] = None) -> List[str]:
        """The net each ladder step serves for ``provider`` (the configured
        one by default), per-scale selection included."""
        return self.sr_module.resolve_ladder_models(ladder, provider or self.config.provider,
                                                    model)

    def _resume_key(self, image_hash: str, ladder: Sequence[int], layout, provider: str,
                    model: Optional[str], category: Optional[str],
                    alpha: Optional[float]) -> Optional[str]:
        """Content-addressed key of the job's upscaled tiles in the store;
        None with ``enable_checkpoint`` off. Every knob that changes the
        SR stage's output changes it: the input, the provider, ladder,
        layout and padding, IBP steps, dtypes, the category and the
        conditioned polish's weights, per step each net with its passes and
        weights (per-scale selection, routing, the fusion members and
        their weights, the self-ensemble, the hybrid polish; for zssr the
        base net's), ``zssr_steps`` on zssr, ``seedream_steps`` (as the
        reference keys it, though no net reads it), and this job's alpha
        on the shrink route. The reference keys on net names (its weights
        are its packaged checkpoints). A zssr key holds the base's weights and the
        steps, not the tuned weights: tuning on the card is not bitwise
        repeatable, and the same base and steps tune the same net."""
        if not self.config.enable_checkpoint:
            return None
        cfg, sr = self.config, self.sr_module
        serving = self._serving_provider(ladder, provider, model)
        steps = []
        for s in ladder:
            members = [[name, passes,
                        sr.weights_digest(name, 1 if name == "espcn_polish" else int(s))]
                       for name, passes in sr.step_members(int(s), serving, model)]
            fused = sr._fusion_for(int(s)) if serving == "fusion" and model is None else None
            steps.append([members, fused])
        sig = [image_hash, provider, [int(s) for s in ladder], cfg.ibp_steps, int(layout.block),
               int(layout.overlap), cfg.padding_mode, cfg.compute_dtype, cfg.params_dtype,
               category, sr.weights_digest("cond_polish", 1) if sr.conditions(category) else None,
               steps, float(alpha) if provider == "shrink" and alpha is not None else None,
               cfg.zssr_steps if provider == "zssr" else None, cfg.seedream_steps]
        return "sr-" + hashlib.md5(json.dumps(sig).encode()).hexdigest()

    @staticmethod
    def _each(fn: Callable[[int], Any], n: int) -> List[Any]:
        """``[fn(i) for i in range(n)]`` on a thread pool: the store's zlib
        work and file IO release the interpreter lock."""
        with ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1))) as pool:
            return list(pool.map(fn, range(n)))

    def _probe_resume(self, key: Optional[str], n: int) -> Optional[Dict[int, np.ndarray]]:
        """{tile index: uint8 upscaled tile} of the tiles the store holds
        under ``key``; None without a key."""
        if key is None:
            return None
        store = self.tiling_module.store
        found = self._each(lambda i: store.get(key, f"sr_{i}"), n)
        return {i: data for i, data in enumerate(found) if data is not None}

    def _checkpoint_sr(self, key: Optional[str], up_tiles: torch.Tensor) -> None:
        """Store the upscaled batch as uint8, ``clamp(round(x), 0, 255)``
        (round half to even, as the reference's ``rint``); the save
        quantizes to 8 or 16 bits anyway."""
        if key is None:
            return
        store = self.tiling_module.store
        up = torch.round(up_tiles).clamp_(0, 255).to(torch.uint8).cpu().numpy()
        self._each(lambda i: store.put(key, f"sr_{i}", up[i]), up.shape[0])

    def _super_resolve(self, image_dev: torch.Tensor, tiles: torch.Tensor, ladder: List[int],
                       layout, provider: str, model: Optional[str], alpha: Optional[float],
                       category: Optional[str], image_hash: Optional[str], tasks: List[Task]):
        """The SR stage's three resume branches (reference
        pipeline.py:1048-1105): every tile in the store (no net runs), some
        (only the missing tiles are upscaled), or none (``_run_stage2``);
        after a recompute the batch is written to the store. Returns
        (up_tiles, layout, ladder, provider, model, record) with the record
        of attempts, degradations and the store's work."""
        n = layout.num_tiles
        key = self._resume_key(image_hash, ladder, layout, provider, model, category, alpha)
        t0 = time.time()
        cached = self._probe_resume(key, n)
        record: Dict[str, Any] = {"sr_attempts": 1, "sr_degradations": 0, "resumed": False}
        if cached is not None:
            record["checkpoint"] = {"key": key, "tiles_read": len(cached),
                                    "read_s": time.time() - t0}
        if cached and len(cached) == n:
            up_tiles = torch.from_numpy(np.stack([cached[i] for i in range(n)])).to(
                self.device).float()
            record["resumed"] = True
            logger.info("resumed all %d upscaled tiles from the store", n)
            return up_tiles, layout, ladder, provider, model, record
        up_tiles = None
        if cached:
            missing = [i for i in range(n) if i not in cached]
            try:
                idx = torch.tensor(missing, device=tiles.device)
                up_missing = self._upscale_batch(tiles.index_select(0, idx), ladder, provider,
                                                 model, alpha, category)
                up_tiles = up_missing.new_empty((n,) + tuple(up_missing.shape[1:]))
                up_tiles[idx] = up_missing
                for i, data in cached.items():
                    up_tiles[i] = torch.from_numpy(data).to(self.device)
                record["checkpoint"]["tiles_upscaled"] = len(missing)
                logger.info("resumed %d/%d tiles; upscaled %d", len(cached), n, len(missing))
            except Exception:  # noqa: BLE001 - partial resume is best-effort
                logger.warning("partial resume failed; recomputing the batch", exc_info=True)
                up_tiles = None
        if up_tiles is None:
            up_tiles, layout, ladder, provider, model, attempts, degradations = \
                self._run_stage2(image_dev, tiles, ladder, layout, tasks, provider, model,
                                 alpha, category)
            record.update(sr_attempts=attempts, sr_degradations=degradations)
        if key is not None:
            t0 = time.time()
            key = self._resume_key(image_hash, ladder, layout, provider, model, category, alpha)
            self._checkpoint_sr(key, up_tiles)
            record["checkpoint"].update(written_key=key, write_s=time.time() - t0)
        return up_tiles, layout, ladder, provider, model, record

    def _run_info(self, ladder, layout, provider, asked, model, alpha, route_info,
                  category) -> Dict[str, Any]:
        """What the SR stage served (reference pipeline.py:1108-1176):
        ``provider`` is the one that ran it (after routing and any
        degradation; ``asked`` the one routing chose; ``fusion`` only where
        a step fused its members: a fusion that resolved no members at any
        step served ``quality`` and says so), the net of each step, and per
        step the [net, passes] it ran (8 passes for a dihedral "+" pass; the
        hybrid polish as ``espcn_polish``), the nets of the staged rule's
        provider where it applies (``_serving_provider``)."""
        cfg, sr = self.config, self.sr_module
        served = provider
        step_models = step_members = None
        model_used = model
        if provider != "bicubic":
            if provider == "fusion" and (model is not None
                                         or not any(sr._fusion_for(int(s)) for s in ladder)):
                served = "quality"
            serving = self._serving_provider(ladder, served, model)
            step_models = self._ladder_models(ladder, model, serving)
            step_members = [[list(m) for m in sr.step_members(int(s), serving, model)]
                            for s in ladder]
            model_used = model or (step_models[0] if step_models else
                                   cfg.fast_model if served in ("fast", "veimagex")
                                   else cfg.quality_model)
        route_info.update(provider=served, model=model, ladder_models=step_models)
        return {
            "ladder": list(ladder),
            "num_tiles": int(layout.num_tiles),
            "block": int(layout.block),
            "overlap": int(layout.overlap),
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
            "zssr": (sr.zssr_info.get(int(ladder[0])) if served == "zssr" and ladder
                     else None),
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
        unless a post-pass needs the collapsed canvas, or under a mesh
        whose ``space`` axis divides the tile rows a ``ShardedCanvas``
        when no post-pass is on; every other path returns the canvas."""
        cfg = self.config
        method = cfg.blend_method
        if method == "laplacian":
            defer = not (cfg.enable_seam_repair or cfg.enable_color_correction)
            profiles = self._weight_profiles(out_layout, image, net_scale)
            if defer and self.dispatcher is not None and self.dispatcher._space_ok(out_layout):
                # the canvas stays row-sharded over the mesh's space axis:
                # a ShardedCanvas for the sharded banded save (reference
                # pipeline.py:666-689)
                mesh = self.last_run_info.setdefault("mesh", {})
                mesh["sharded_blend"] = True
                return self.dispatcher.laplacian_blend(
                    up_tiles, profiles, out_layout, levels=cfg.num_pyramid_levels,
                    collapse_last=False, stats=mesh)
            return laplacian_fusion_tiles(
                up_tiles, out_layout, profiles,
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
        output crops, each shape group scored in one batch on QA's device
        (reference pipeline.py:804-846)."""
        acc: Dict[str, List[float]] = {}
        by_shape: Dict[Tuple[int, ...], List[np.ndarray]] = {}
        for c in crops:
            arr = c.astype(np.float32)
            if c.dtype == np.uint16:
                arr = arr / 257.0
            by_shape.setdefault(arr.shape, []).append(arr)
        for group in by_shape.values():
            batch = torch.from_numpy(np.stack(group)).to(self.quality_module.device)
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
        roi_regions: Optional[List[Dict[str, Any]]] = None,
    ) -> PipelineResult:
        """Super-resolve one image (a path or an (H, W, 3) array in
        [0, 255]) to ``target_resolution`` and write ``output_path`` (TIFF,
        PNG, or JPEG where PIL is installed), plus ``<out>_qa_report.json``
        with QA on. A ``prompt`` that names a template category
        (``models/prompts.py``) steers this job's conditioned polish in
        place of ``prompt_category``; other prompts change nothing
        (reference pipeline.py:896-912). ``roi_regions`` (``{"type": "text"
        | "product" | "face" | "brand", "bbox": [x, y, w, h]}`` in input
        coordinates, a brand with ``"reference_color"``) add the
        commercial metrics to the QA report; with QA off they are
        ignored, as in the reference."""
        start = time.time()
        stage_times: Dict[str, float] = {}
        category = (prompt if prompt in PromptTemplateManager.TEMPLATES
                    else self.config.prompt_category)
        if self._stage_sem is None:
            # Inside a batch the workers share the event: process_batch
            # clears it once, so a cancel() during the batch stops every job.
            self._cancel_event.clear()
        try:
            # inference_mode is per thread: each batch worker enters its own.
            with torch.inference_mode(), contextlib.ExitStack() as device_stages:
                return self._process(input_path, output_path, start, stage_times, category,
                                     roi_regions, device_stages)
        except Exception as e:  # noqa: BLE001 - parity: never raise
            logger.exception("pipeline failed")
            return PipelineResult(
                success=False, output_path=None,
                processing_time=time.time() - start, total_blocks=0,
                successful_blocks=0, failed_blocks=0, quality_score=None,
                quality_report=None, error_message=f"{type(e).__name__}: {e}",
                stage_times=stage_times,
            )

    def process_batch(self, jobs: List[Dict[str, Any]],
                      max_concurrent: int = 2) -> List[PipelineResult]:
        """Process several images in the scheduler's priority order
        (reference pipeline.py:1394-1454); results in the jobs' order.

        Each job: ``{"input": path or array, "output": path}``, optionally
        ``"vip_level"`` (``VIPLevel`` or its int), ``"prompt"`` and
        ``"roi_regions"`` (as in :meth:`process`). Jobs are ordered by
        ``Task.calculate_priority`` (VIP level, regions of interest, then
        the order given: one submit time for the whole batch). With
        ``max_concurrent > 1`` they run on that many worker threads, and a
        semaphore lets one job at a time through the device stages (SR to
        QA), so one job's save overlaps the next one's SR and blend. With
        ``provider="zssr"`` the jobs run one after another, as in the
        reference: each tunes the net the SR module holds."""
        submitted = time.time()

        def priority(job: Dict[str, Any]) -> float:
            vip = job.get("vip_level", VIPLevel.NORMAL)
            vip = VIPLevel(vip) if isinstance(vip, int) else vip
            return Task.calculate_priority(vip, bool(job.get("roi_regions")), False, submitted)

        ordered = sorted(enumerate(jobs), key=lambda it: priority(it[1]))
        results: List[Optional[PipelineResult]] = [None] * len(jobs)
        if self.config.provider == "zssr":
            # each job tunes the net the module holds: no two may interleave
            max_concurrent = 1
        if max_concurrent <= 1 or len(jobs) < 2:
            for idx, job in ordered:
                results[idx] = self.process(job["input"], job["output"], prompt=job.get("prompt"),
                                            roi_regions=job.get("roi_regions"))
            return results  # type: ignore[return-value]
        self._cancel_event.clear()  # once per batch, not per job
        self._stage_sem = threading.Semaphore(1)
        try:
            with ThreadPoolExecutor(max_workers=max_concurrent) as pool:
                futures = [(idx, pool.submit(self.process, job["input"], job["output"],
                                             prompt=job.get("prompt"),
                                             roi_regions=job.get("roi_regions")))
                           for idx, job in ordered]
                for idx, fut in futures:
                    results[idx] = fut.result()
        finally:
            self._stage_sem = None
        return results  # type: ignore[return-value]

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

    def _process(self, input_path, output_path, start, stage_times, category: Optional[str],
                 roi_regions: Optional[List[Dict[str, Any]]],
                 device_stages: contextlib.ExitStack) -> PipelineResult:
        cfg = self.config
        with self._stage("tiling", stage_times):
            image = (
                load_image(input_path) if isinstance(input_path, str)
                else np.asarray(input_path, np.float32)
            )
            h, w = image.shape[:2]
            tw, th = self._calculate_target_size((w, h), self.config.target_resolution)
            scale_total = max(tw / w, th / h)
            # One upload: routing, tiling and QA read this copy.
            image_dev = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device)
            ladder, routed_model, routed_provider, alpha, route_info = self._route(
                image_dev, scale_total)
            layout, tiles = self.tiling_module.split_to_batch(image_dev, self.device)
            image_hash = None
            if cfg.enable_checkpoint:
                image_hash = self.tiling_module.compute_image_hash(
                    input_path if isinstance(input_path, str) else image)

        logger.info("Stage 1: %dx%d -> %dx%d grid (block %d, overlap %d), ladder %s",
                    w, h, layout.nx, layout.ny, layout.block, layout.overlap, ladder)
        self._check_cancel("super_resolution")
        if self._stage_sem is not None:
            sem = self._stage_sem
            sem.acquire()
            device_stages.callback(sem.release)
        asked = routed_provider or cfg.provider
        with self._stage("super_resolution", stage_times):
            if asked == "zssr" and ladder:
                # tune on the input itself first (reference pipeline.py:1036-1044)
                self.sr_module.zssr_prepare(image, scale=int(ladder[0]), steps=cfg.zssr_steps)
            tasks = self._book_tasks(layout.num_tiles, output_path, scale_total)
            up_tiles, layout, ladder, served, model, record = self._super_resolve(
                image_dev, tiles, ladder, layout, asked, routed_model, alpha, category,
                image_hash, tasks)
            del tiles
            self._book_done(tasks)
        net_scale = int(np.prod(ladder)) if ladder else 1
        info = self._run_info(ladder, layout, served, asked, model, alpha, route_info, category)
        info.update(record)
        if self.dispatcher is not None:
            mesh = self.dispatcher.mesh
            info["mesh"] = {"shape": mesh.shape, "devices": mesh.distinct_devices(),
                            "sharded_blend": False, "halo_bytes": 0, "gather_fallback": None}
        self.last_run_info = info

        self._check_cancel("blending")
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
        sharded = isinstance(canvas, ShardedCanvas)
        lap0, coarse = canvas if isinstance(canvas, tuple) else (canvas, None)
        crop = dict(crop_h=min(out_layout.padded_h, layout.image_h * net_scale),
                    crop_w=min(out_layout.padded_w, layout.image_w * net_scale))
        quant = "uint16" if self.config.bit_depth == 16 else True

        split: Dict[str, float] = {"fetch": 0.0, "write": 0.0}

        def banded(oh: int, ow: int, nbands: int, to_uint8, **kw):
            """Output bands: each shard's own (reference pipeline.py:1227-1272)
            or the single-device finalize's."""
            if sharded:
                return sharded_finalize_banded(canvas, oh, ow, bands=nbands, to_uint8=to_uint8,
                                               stats=info["mesh"], **crop, **kw)
            return blend_finalize_banded(lap0, coarse, oh, ow, bands=nbands, to_uint8=to_uint8,
                                         **crop, **kw)

        def save_bands():
            t0 = time.time()
            bands = banded(th, tw, 8, quant, as_iterator=True)
            self._sync()
            split["finalize"] = time.time() - t0
            return bands

        self._check_cancel("quality_assessment")
        quality_report: Optional[Dict[str, Any]] = None
        bands = None
        if self.quality_module is not None:
            with self._stage("quality_assessment", stage_times):
                bands = save_bands()  # first, as the reference dispatches them
                # The input-size proxy: on the device, or from the shards
                # through the host as the reference's sharded branch does.
                if sharded:
                    small = torch.from_numpy(banded(h, w, 2, False)).to(self.device)
                else:
                    small = banded(h, w, 2, False, as_device=True)
                small = small.clamp_(0, 255)
                fr = self.quality_module.evaluate_full_reference(image_dev, small)
                nr = self.quality_module.evaluate_no_reference(small)
                quality_report = {**fr, **nr}
                if roi_regions:
                    # input-size proxy, so the boxes apply as they are; the
                    # reference hands it over as a host array
                    quality_report.update(self.quality_module.evaluate_commercial(
                        small.cpu().numpy(), roi_regions))
        # The device stages are done: the next job of a batch may start its
        # SR. (With QA off this job's banded finalize runs in the save stage.)
        device_stages.close()

        self._check_cancel("save")
        with self._stage("save", stage_times):
            if bands is None:
                bands = save_bands()
            crops: List[np.ndarray] = []
            if output_path.lower().endswith((".tiff", ".tif")):
                self._write_tiff(output_path, bands, th, tw, split,
                                 crops if quality_report is not None else None)
                logger.info("save breakdown: fetch %.2fs, write %.2fs", split["fetch"],
                            split["write"])
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
        info["save_breakdown"] = split

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
