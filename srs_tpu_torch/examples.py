"""Usage examples of every public surface of the port (the counterpart of
``examples/example_usage.py``): prompts, the single-image SR module,
tiling and blending, quality assessment with its report, the scheduler
and the pipeline. Each prints one section headed ``== <name>``.

    python -m srs_tpu_torch.examples [--device cpu]

Runs on the card unless ``--device cpu`` is given. No weights are handed
in, so the store's trained nets and LPIPS features serve (a net the
store lacks is bicubic with back-projection); the pipeline's input PNG
is written by the port's encoder.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

__all__ = ["make_demo_image", "main"]

SECTIONS = ("prompts", "sr_module", "tiling_and_blending", "quality_assessment",
            "scheduler", "pipeline")


def make_demo_image(h: int = 240, w: int = 320) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [127 + 90 * np.sin(xx / 19), 127 + 90 * np.cos(yy / 13),
         127 + 90 * np.sin((xx + yy) / 23)], -1)
    return np.clip(img, 0, 255).astype(np.float32)


def example_prompts(device: torch.device) -> None:
    from .models.prompts import PromptTemplateManager

    print("categories:", PromptTemplateManager.list_categories())
    print("jewelry prompt:", PromptTemplateManager.build_prompt("jewelry")[:80], "...")


def example_sr_module(device: torch.device) -> None:
    from .models.sr_module import SuperResolutionModule, UpscaleConfig, UpscaleProvider

    sr = SuperResolutionModule(device=device)
    img = make_demo_image(120, 160)
    res = sr.upscale(img, UpscaleConfig(provider=UpscaleProvider.QUALITY, target_scale=2.0))
    print("sr:", res.original_size, "->", res.upscaled_size, f"{res.processing_time:.2f}s")
    hybrid = sr.hybrid_upscale(img, target_scale=4.0, category="food")
    print("hybrid stages:", [h["stage"] for h in hybrid.metadata["processing_history"]])


def example_tiling_and_blending(device: torch.device) -> None:
    from .blending import BlendingModule, TileInfo
    from .tiling.tiling import TilingModule

    img = make_demo_image(200, 300)
    tm = TilingModule(block_size=128, overlap_ratio=0.2, device=device)
    tiles = tm.split_image(img)
    print(f"tiling: {len(tiles)} tiles, first block_id {tiles[0].metadata.block_id[:8]}")
    merged = tm.merge_tiles(tiles, output_size=img.shape[:2], scale=1)
    print("merge max err:", float(np.abs(merged - img).max()))

    bm = BlendingModule(device=device)
    infos = [TileInfo(t.data, t.metadata.global_x, t.metadata.global_y,
                      t.metadata.row, t.metadata.col) for t in tiles]
    fused = bm.laplacian_fusion(infos, output_shape=img.shape[:2])
    print("laplacian fusion err:", float(np.abs(fused - img).max()))
    print("seams detected:", len(bm.detect_seams(fused, infos)))


def example_quality_assessment(device: torch.device) -> None:
    from .models.lpips import LPIPSMetric
    from .qa.module import QualityAssessmentModule

    qam = QualityAssessmentModule(device=device, lpips_model=LPIPSMetric(device=device))
    clean = make_demo_image()
    noisy = np.clip(clean + np.random.default_rng(0).normal(0, 8, clean.shape), 0, 255)
    metrics = qam.evaluate_full_reference(clean, noisy)
    print(qam.generate_report(metrics, "summary"))


def example_scheduler(device: torch.device) -> None:
    from .scheduler.scheduler import AgentScheduler, Task, VIPLevel

    async def go():
        s = AgentScheduler(initial_agents=3)
        s.attach_mesh_devices(None if device.type == "cuda" else [device])
        for vip in (VIPLevel.NORMAL, VIPLevel.ENTERPRISE):
            await s.submit_task(Task(vip_level=vip))
        await s._dispatch_tasks()
        print("scheduler:", s.get_statistics()["tasks"])

    asyncio.run(go())


def example_pipeline(device: torch.device) -> None:
    from .io.image import save_image
    from .pipeline import PipelineConfig, SuperResolutionPipeline

    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.png")
        save_image(inp, make_demo_image(120, 160).astype(np.uint8))
        pipe = SuperResolutionPipeline(PipelineConfig(
            block_size=64, target_resolution="320x240", provider="fast",
            num_pyramid_levels=3, device=str(device)))
        r = pipe.process(inp, os.path.join(d, "out.tiff"))
        print("pipeline:", r.success, f"{r.processing_time:.1f}s", "score", r.quality_score)
        if not r.success:
            raise RuntimeError(f"pipeline failed: {r.error_message}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m srs_tpu_torch.examples",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    for name in SECTIONS:
        print(f"== {name}", flush=True)
        globals()[f"example_{name}"](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
