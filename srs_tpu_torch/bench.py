"""Benchmark: 720p -> 100MP end to end on the card (port of the
repository's ``bench.py``).

    python -m srs_tpu_torch bench

Prints ONE JSON line with the reference's keys: ``metric``, ``value``
(output MP/s of one warm ``process()``), ``unit``, ``vs_baseline`` (over
the reference's 100 MP in 390 s), the stage times, the link rates, the
compute-bound figures, MFU (``utils/flops.py``), the full-resolution
panel and the input's NIQE/BRISQUE deltas. The input is the reference's:
``render_photo(7, 1280)[280:1000]`` through the port's corpus, or the
``photo_mosaic`` input under ``SRS_BENCH_INPUT=mosaic``, saved as PNG by
the port's encoder. The knobs are the reference's ``SRS_BENCH_*``
variables.

Without a card it exits with code 2, unless ``SRS_BENCH_CPU_OK=1`` asks
for the CPU. It writes its row into ``~/.cache/srs_tpu_torch/BENCH_LOCAL.md``
(``SRS_BENCH_NO_LOG=1`` turns that off), never into the repository's
``BENCH_LOCAL.md``, which holds the reference's rows.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

BASELINE_MP_PER_SEC = 100.0 / 390.0  # the reference's midpoint (README.md:166-170)
LOG_PATH = os.path.join("~", ".cache", "srs_tpu_torch", "BENCH_LOCAL.md")


def make_input(path: str) -> None:
    """The 720x1280 input as PNG: a ``render_photo`` scene crop, or with
    ``SRS_BENCH_INPUT=mosaic`` a mosaic of four bundled photographs (the
    scene when they are not installed)."""
    from .io.image import save_image

    if os.environ.get("SRS_BENCH_INPUT", "render") == "mosaic":
        from .models.photo_data import photo_mosaic

        tiles = [photo_mosaic(101 + i, 640) for i in range(4)]
        if all(t is not None for t in tiles):
            top = np.concatenate(tiles[:2], axis=1)  # 640x1280
            img = np.concatenate(
                [top[:360], np.concatenate(tiles[2:], axis=1)[:360]], axis=0)
            save_image(path, np.clip(img, 0, 255).astype(np.uint8))
            return
    from .models.corpus import render_photo

    img = render_photo(7, 1280)[280:1000]  # 720x1280 center crop
    save_image(path, np.clip(img, 0, 255).astype(np.uint8))


def bench_config(device: str):
    """The reference's ``PipelineConfig`` with the ``SRS_BENCH_*`` knobs."""
    from .pipeline import PipelineConfig

    env = os.environ.get
    return PipelineConfig(
        block_size=int(env("SRS_BENCH_BLOCK", "512")),
        overlap_ratio=0.2,
        target_resolution="100MP",
        provider=env("SRS_BENCH_PROVIDER", "quality"),
        quality_model=env("SRS_BENCH_QMODEL", "edsr_xl"),
        per_scale_selection=env("SRS_BENCH_PER_SCALE", "1") == "1",
        self_ensemble=env("SRS_BENCH_ENSEMBLE", "0") == "1",
        ibp_steps=int(env("SRS_BENCH_IBP", "4")),
        bit_depth=int(env("SRS_BENCH_BITDEPTH", "8")),
        enable_qa=env("SRS_BENCH_QA", "1") == "1",
        device=device,
    )


def bench_device() -> Optional[str]:
    """"cuda" when torch sees a card, "cpu" when there is none and
    ``SRS_BENCH_CPU_OK=1``, else None."""
    import torch

    if torch.cuda.is_available():
        return "cuda"
    return "cpu" if os.environ.get("SRS_BENCH_CPU_OK", "0") == "1" else None


def _link_mbps(device) -> float:
    """MB/s of a 2 MB device-to-host copy."""
    import torch

    probe = torch.zeros((8, 512, 512), dtype=torch.uint8, device=device)
    if probe.is_cuda:
        torch.cuda.synchronize(probe.device)
    t0 = time.time()
    probe.cpu()
    return 2.0 / max(time.time() - t0, 1e-6)


def measure(pipe, inp: str, out: str, workdir: str) -> Dict[str, Any]:
    """The timed run (``process()``, or ``process_batch`` of
    ``SRS_BENCH_BATCH`` jobs on two workers) after the link probe, and the
    result line. The pipeline must be warm."""
    import torch

    from .io.image import image_size, load_image

    cfg = pipe.config
    link_mbps = _link_mbps(pipe.device)
    nbatch = int(os.environ.get("SRS_BENCH_BATCH", "1"))
    t0 = time.time()
    if nbatch > 1:
        jobs = [{"input": inp, "output": os.path.join(workdir, f"out_b{i}.tiff")}
                for i in range(nbatch)]
        results = pipe.process_batch(jobs, max_concurrent=2)
        elapsed = time.time() - t0
        failed = [x.error_message for x in results if not x.success]
        if failed:
            raise RuntimeError(f"bench batch failed: {failed}")
        r = results[0]
        out = jobs[0]["output"]
    else:
        r = pipe.process(inp, out)
        elapsed = time.time() - t0
        if not r.success:
            raise RuntimeError(f"bench run failed: {r.error_message}")

    w, h = image_size(out)
    mp = w * h * nbatch / 1e6
    mp_per_sec = mp / elapsed
    result: Dict[str, Any] = {
        "metric": "720p_to_100MP_end_to_end",
        "value": round(mp_per_sec, 3),
        "unit": "MP/s/chip",
        "vs_baseline": round(mp_per_sec / BASELINE_MP_PER_SEC, 1),
        "elapsed_s": round(elapsed, 2),
        "output_mp": round(mp, 1),
        "stage_times": {k: round(v, 2) for k, v in r.stage_times.items()},
        "quality_score": r.quality_score,
        "provider": cfg.provider,
        "quality_model": cfg.quality_model,
        "batch": nbatch,
        "d2h_link_MBps": round(link_mbps, 1),
    }
    # The save stage's rate over the output bytes; the compute-bound
    # figures leave it out (reference bench.py:142-163).
    save_s = r.stage_times.get("save")
    if save_s:
        out_bytes = w * h * 3 * (cfg.bit_depth // 8)
        result["save_link_MBps"] = round(out_bytes / 1e6 / save_s, 1)
        if nbatch == 1:
            compute_s = elapsed - save_s
            result["compute_stages_s"] = round(compute_s, 2)
            result["value_compute_bound"] = round(mp / max(compute_s, 1e-6), 3)
            result["vs_baseline_compute_bound"] = round(
                mp / max(compute_s, 1e-6) / BASELINE_MP_PER_SEC, 1)
    # What actually ran: the provider served and any degradation.
    info = getattr(pipe, "last_run_info", None)
    if info:
        if info.get("provider") != cfg.provider:
            result["provider_used"] = info.get("provider")
        if info.get("sr_attempts", 1) > 1 or info.get("sr_degradations", 0):
            result["degraded"] = True
            result["sr_attempts"] = info.get("sr_attempts")
    # MFU: the convolution FLOP of the ladder that ran over the SR stage.
    if info and info.get("model") and info.get("ladder") and not info.get("resumed"):
        from .utils.flops import ladder_flops, mfu, multipass_ladder_flops

        if info.get("step_members"):
            flops = nbatch * multipass_ladder_flops(
                info["step_members"], info["ladder"], info["block"], info["num_tiles"])
        else:
            flops = nbatch * ladder_flops(info["model"], info["ladder"], info["block"],
                                          info["num_tiles"], models=info.get("models"))
        sr_s = r.stage_times.get("super_resolution", info.get("sr_seconds"))
        result.update(mfu(flops, sr_s * nbatch, pipe.device))
        result["routed_model"] = info["model"]
        if info.get("models"):
            result["step_models"] = info["models"]
    # The full-resolution no-reference panel.
    if r.quality_report:
        for k in ("fullres_niqe", "fullres_brisque", "fullres_sharpness",
                  "fullres_contrast", "fullres_crops"):
            if k in r.quality_report:
                v = r.quality_report[k]
                result[k] = round(v, 3) if isinstance(v, float) else v
    # Input-relative NIQE and BRISQUE: is the upscale adding unnaturalness?
    if "fullres_niqe" in result:
        from .qa.niqe import brisque_scores, niqe_scores

        inp_img = torch.from_numpy(load_image(inp)).to(pipe.device)
        nq = niqe_scores(inp_img[None])
        if nq and nq[0] is not None:
            result["input_niqe"] = round(float(nq[0]), 3)
            result["niqe_delta"] = round(result["fullres_niqe"] - float(nq[0]), 3)
        if "fullres_brisque" in result:
            bq = brisque_scores(inp_img[None])
            if bq and bq[0] is not None:
                result["input_brisque"] = round(float(bq[0]), 3)
                result["brisque_delta"] = round(result["fullres_brisque"] - float(bq[0]), 3)
    if os.environ.get("SRS_BENCH_INPUT"):
        result["bench_input"] = os.environ["SRS_BENCH_INPUT"]
    return result


def log_row(result: Dict[str, Any]) -> Optional[str]:
    """Append the row to the port's bench log (``LOG_PATH``) unless
    ``SRS_BENCH_NO_LOG=1``; returns the log's path, or None."""
    if os.environ.get("SRS_BENCH_NO_LOG", "0") == "1":
        return None
    path = os.path.expanduser(LOG_PATH)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    knobs = " ".join(f"{k}={os.environ[k]}" for k in sorted(os.environ)
                     if k.startswith("SRS_BENCH_") and k != "SRS_BENCH_NO_LOG")
    with open(path, "a") as f:
        f.write(f"\n- `{time.strftime('%Y-%m-%d %H:%M')}`"
                f"{' [' + knobs + ']' if knobs else ''} `{json.dumps(result)}`\n")
    return path


def main() -> int:
    device = bench_device()
    if device is None:
        print("bench: torch sees no CUDA device; the bench measures the card "
              "(SRS_BENCH_CPU_OK=1 runs it on the CPU)", file=sys.stderr)
        return 2
    from .pipeline import SuperResolutionPipeline

    workdir = os.environ.get(
        "SRS_BENCH_DIR", os.path.join(tempfile.gettempdir(), "srs_tpu_torch_bench"))
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "input_720p.png")
    out = os.path.join(workdir, "output_100mp.tiff")
    make_input(inp)
    pipe = SuperResolutionPipeline(bench_config(device))
    r0 = pipe.process(inp, out)  # warm-up: builds the kernels and every net
    if not r0.success:
        print(json.dumps({"metric": "error", "value": 0, "unit": "",
                          "vs_baseline": 0, "error": r0.error_message}))
        return 1
    result = measure(pipe, inp, out, workdir)
    print(json.dumps(result), flush=True)
    log_row(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
