#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with one CUDA card. Phases,
in order, each printing one JSON line with its seconds:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the pyramid kernels (``nvcc``) and the TIFF writer (``g++``),
   built together from the sources in the checkout; the kernels'
   registers and spills as ``ptxas -v`` prints them;
3. kernels: K1 (pyrDown) and K2 (pyrUp) held against their plain PyTorch
   versions on the card, at the main path's shapes, at odd and tiny
   sizes, and at the edges of their row-streaming blocks, with their
   times beside the bound and a PyTorch library call;
4. reference: the whole pipeline on small inputs with seeded ``edsr_m``
   (the store hidden), on the card and on the CPU (plain versions): with
   routing, selection and QA off, TIFFs within 1 LSB; with them on (the
   bench flags), the same routing decision and ladder models, the probe's
   gain and alpha within their bfloat16 tolerances, TIFFs within 1 LSB
   and QA values within the CPU tests' tolerances;
5. main path: ``SuperResolutionPipeline.process()`` for a 720x1280 input
   to the 100MP preset (12245x6887) with provider ``quality`` and
   ``edsr_xl`` at its full width (16 blocks, 128 features) on a [3, 3]
   ladder, routing, per-scale selection and QA off, weights seeded and the
   tail non-zero; run once to warm up, with every K1/K2 launch also held
   against the plain version on the same input (the main path's own
   shapes and data: tile levels, canvas collapse steps and finalize
   bands), and once with the launch counts reset, which must show both
   kernels;
6. bench path: the same input through ``bench.py:69-83``'s configuration
   with seeded ``edsr_xl`` handed in (routing with the SR-gain probe,
   per-scale selection from the store's EVAL.json, QA with the store's
   LPIPS features, the full-resolution panel and the report file),
   warmed up with every launch held against the plain version, then run
   with the launch counts reset;
7. packaged: the same configuration with nothing handed in, so the
   store (``srs_tpu_torch/models/checkpoints/``) serves its trained nets,
   as the reference serves its packaged checkpoints: every store file
   against MANIFEST.json's sha256, the default path's reads timed; a
   warm-up with every launch held against the plain version, then a run
   with the counts reset: selection's pick from the store's EVAL.json
   (``edsr_xl`` at each x3 step), every served net trained and no IBP,
   the probe's gain and alpha, QA's ``lpips_vgg`` and ``lpips_alex`` from
   the store's features, MP/s, stage times and peak memory beside the
   seeded bench path's; then card against CPU on a small input (96x112
   -> 1008x864) in float32: TIFFs within 1 LSB, the probe within its
   bfloat16 tolerances, the report within the CPU tests' tolerances;
8. cli_path: the command line, ``srs_tpu_torch.cli.main`` in this
   process, as a user runs ``python -m srs_tpu_torch process in.png
   out.tiff --target 100MP --blend multi_band --seam-repair
   --color-correction --content-aware`` with the store hidden in this
   process (``edsr_xl`` at full width untrained, so 8 IBP steps run):
   the 720x1280 input written as PNG by the port's encoder and decoded
   back exactly; a warm-up with every K1/K2 launch held against the plain
   version, then a run with the launch counts reset; its MP/s, stage
   times, peak memory, IBP seconds, seam and box counts and launches by
   shape; then ``python3 -m
   srs_tpu_torch process`` once in a subprocess at 1024x576, which serves
   the store's nets (no untrained net named on its standard error);
9. other_blends: ``weighted``, ``feather``, ``gradient_domain`` and
   ``poisson`` through ``process()`` at full width, QA off, nothing handed
   in (the store's nets), each with its blending seconds and the peak
   memory of the blend;
10. blend_reference: card against CPU on small inputs, untrained nets with
   IBP (the store hidden): each of the six blends, and ``multi_band`` with
   seam repair,
   colour correction and content-aware seams, TIFFs within 1 LSB; and
   seam detection and repair of a scene with medium and high seams, the
   same seams and canvases within 1e-3;
11. providers: ``process()`` at full width (the 720x1280 input to the
   100MP preset, QA, routing and selection off, weights seeded) for eight
   serving cases: ``fusion`` with the x3 members of the store's
   FUSION.json, ``quality`` with the dihedral self-ensemble,
   ``quality`` with ``prompt="food"`` and a seeded conditioned polish,
   ``hybrid`` with an untrained ``edsr_xl`` (the store hidden) and a
   seeded ``espcn_polish``,
   ``fast`` with a seeded ``espcn``, ``rcan`` as the quality net, and the
   reference's remote names ``seedream`` (the quality path's nets, within
   1 LSB of its TIFF) and ``veimagex`` (the fast case's, within 1 LSB of
   its TIFF), each reporting itself as the provider that served. Each
   a warm-up with every K1/K2 launch held against the plain version, then
   a timed run with the counts reset: MP/s, stage times, peak memory, and
   the nets and passes of each step from ``last_run_info``; fusion must
   show its members with 8 passes for each "+" member, the ensemble 8
   passes a step, and the prompt's pixels must differ from the quality
   path's;
12. provider_reference: the eight cases on a small input (48x64 -> 192x144,
   one x3 step), card against CPU in float32: TIFFs within 1 LSB and the
   same nets and passes; and fusion in bfloat16, held to a PSNR floor;
13. jobs: the job layer at full width on the quality path's flags:
   ``degrade`` (a real CUDA OOM after the real net in every quality-net
   call: retries, then degradation to ``fast`` with a seeded ``espcn`` at
   tile 256 / overlap 16 on the ladder for x0.7 of the scale, still
   12245x6887, with no memory left allocated), ``transient`` (two
   failures, then ``quality`` with no degradation, within 1 LSB of the
   main path), ``cancel`` (``cancel()`` from the SR stage, then the next
   ``process()`` on the same pipeline), ``resume`` (a tile store in the
   temporary directory: run 1 dies in blending, run 2 makes no upscale
   call, run 3 upscales just the tile whose file was deleted; within 2
   LSB) and ``batch`` (``process_batch`` of three jobs on two workers,
   the ENTERPRISE job first, each within 1 LSB; beside three back-to-back
   calls). Each case's runs hold every K1/K2 launch against the plain
   version, and a run with the counts reset shows both kernels;
14. zssr: ``process(provider="zssr")`` at full width on the quality
   path's flags: seeded ``edsr_xl`` handed in as trained, so
   ``zssr_prepare`` tunes a copy of it on the input for 150 steps (batch
   8, patch 48, lr 1e-4), which then serves both x3 steps; a warm-up with
   every K1/K2 launch held against the plain version, then a run with the
   counts reset. Its tune seconds, steps/s and TFLOP/s (three times the
   forward convolutions' FLOP a step) beside the bf16 dense peak, the SR
   stage, MP/s and peak memory; the tuned weights must differ from the
   seeded ones, the seeded ones must be unchanged, and the TIFF must
   differ from the main path's;
15. train: ``train_synthetic("edsr_xl", 3)`` for 200 steps at batch 32,
   patch 48 on a 96-image, 256-px corpus: corpus seconds, steps/s,
   TFLOP/s, first and last chunk loss (it must fall), peak memory; the
   state dict saved in a temporary checkpoint directory reloads, a
   ``process()`` with that directory serves the net as trained (no IBP
   call, the TIFF equal to one served with the weights handed in), and
   ``python3 -m srs_tpu_torch train --synthetic`` runs once in a
   subprocess;
16. train_reference: the trainer card against CPU on small inputs,
   float32 with TF32 off: five zssr steps (espcn) and five ``train_step``
   steps (edsr_m) with per-step losses within a relative 1e-3, and zssr
   in bfloat16 with the tuned nets' outputs above 40 dB PSNR;
17. library: the library API at full size. ``process(roi_regions=...)``
   on the bench path's pipeline (a text, product, face and brand region
   in input coordinates): the commercial keys and score, and the QA
   stage's seconds beside the bench path's; a two-job ``process_batch``
   whose ROI job gives the same commercial keys. Then
   ``TilingModule.split_image`` (6 tiles of 512) and ``merge_tiles``
   (the input back within 1e-3); the tiles upscaled x9 by the SR module
   (seeded ``edsr_xl``, [3, 3]); each ``BlendingModule`` fusion into the
   6480x11520 output (seconds, peak memory, K1/K2 launches by shape);
   ``detect_seams``, ``repair_seams`` and ``compute_blend_quality`` on the
   Laplacian result; ``poisson_fusion`` with the multigrid solver at full
   canvas size (a 2048-px mask; K1 restricts, K2 prolongs) with its final
   residual max |lap(u) - div| in the mask beside the Jacobi solver's;
   and ``python3 -m srs_tpu_torch.examples`` once in a subprocess. Every
   run that launches a kernel is first run with each launch held against
   the plain version, then timed with the counts reset;
18. library_reference: the library API card against CPU at the CPU
   tests' sizes (float32, TF32 off): the five fusions, the multigrid and
   Jacobi clones in each mode, split and merge, Canny, the commercial
   metrics with ROIs and a bicubic ``process(roi_regions=...)``;
19. subcommands: the operator subcommands on the bench configuration.
   ``python3 -m srs_tpu_torch bench`` once in a subprocess (exit 0, one
   JSON line, no row in the repository's BENCH_LOCAL.md); then the port's
   bench (``srs_tpu_torch/bench.py``: the reference's ``render_photo``
   input, which that run rendered, its knobs and its JSON line) in this
   process, a warm-up with every K1/K2 launch held against the plain
   version, then its timed ``process()`` with the counts reset: MP/s,
   ``mfu_pct`` and ``chip_kind`` (``utils/flops.py``), the stage times;
   ``info`` (backend cuda, the card among its devices); ``warmup`` at its
   defaults, listing the store's trained scales; ``process --profile DIR``
   on the bench input, whose trace must name K1's and K2's device kernels.
   All of them serve the store's nets;
20. generate: generation at the packaged generator's width (base 64,
   depth 2, 128 px): ``train_ark`` on the card at batch 64 on a
   64-image class corpus, 200 steps (steps/s, TFLOP/s beside the bf16
   peak, first and last chunk loss, which must fall, peak memory; the
   checkpoint and ``ark_meta.json`` reload equal); ``python3 -m
   srs_tpu_torch generate "product shot of a watch" out.png --size 2K
   --checkpoint-dir`` that directory in a subprocess (a 2048x2048 PNG from
   ``ark_gen-ddim``, 50 DDIM steps); the same call in this process with
   the refinement, three times: the seconds of the sample, the SR ladder
   and the refinement apart, its tile count, peak memory, the same seed
   within 1 LSB, another class moving it well above that reproduction
   noise;
21. generate_reference: the generator card against CPU at the CPU tests'
   sizes, float32 with TF32 off: the UNet, ``sample_ark`` and
   ``refine_ark`` with the draws handed in, one batch's loss and
   gradients, each within the CPU tests' tolerances; the bfloat16 sampler
   above a PSNR floor;
22. mesh: ``bench.py:69-83``'s configuration (the bench path's flags,
   the store's ledger and seeded ``edsr_xl``) with ``mesh_shape={"data":
   2, "space":
   2}`` on a virtual mesh of four shards on ``cuda:0``, handed in as
   ``pipe.dispatcher``: the six tiles split over ``data`` (3 a shard), the
   8064x11520 canvas over ``space`` (own 3456 rows, band 4608), the
   sharded banded finalize for the save and the QA proxy. A cold call with
   every K1/K2 launch held against the plain version, two warm calls with
   the counts reset: MP/s, stage times, peak memory, halo bytes; the
   sharded blend ran, no gather fallback, the TIFF 12245x6887 and within
   1 LSB of the bench path's on all but 1e-3 of samples, no more memory
   left allocated than the bench path left; and ``python3 -m srs_tpu_torch
   process ... --mesh data=2`` exits non-zero with no output on one card;
23. mesh_reference: the 2x2 mesh at small size (80x96 -> 864x720), card
   (virtual mesh) against CPU (the CPU repeated) in float32 with TF32 off:
   the sharded blend on both, TIFFs within 1 LSB;
24. webui: the web UI's headless path. The session at its defaults and
   ``extract_image_info`` of the input array, then the Monitor page's
   worker (``monitor_page.start_worker``) on the Configure page's state:
   the bench configuration at a block of 1024, nothing handed in (the
   store's trained nets and LPIPS features, no IBP). A warm-up with
   every K1/K2 launch held against the plain version, then a run with
   the counts reset: ``done``, a 12245x6887 TIFF,
   the bench path's report keys, the pipeline's records in the log
   buffer, peak memory under 40 GB, and the TIFF within 1 LSB of a direct
   ``process()`` with the same ``PipelineConfig``; MP/s, tiles, ladder,
   the SR chunking. Then the Cancel button mid-SR (``failed: ...
   cancelled``, at most 4 MiB left allocated); ``build_export`` as TIFF
   8-bit sRGB, TIFF 16-bit AdobeRGB and PNG sRGB, each decoded within 1
   LSB (after the same ``convert_profile``); a JPEG export without PIL
   raises; ``python3 -m srs_tpu_torch webui`` without Streamlit exits
   non-zero;
25. webui_reference: the worker's job at small size (60x80 -> 160x120,
   tile 64, QA on, untrained nets with the store hidden), card against
   CPU with TF32 off: TIFFs within 1 LSB;
26. sharded_train: ``parallel/train.sharded_train_step`` on ``edsr_xl`` x3
   at full width, batch 32, patch 48, on a data=2, space=2, model=2
   virtual mesh of ``cuda:0``, three steps against three unsharded
   ``train_step`` steps from the same weights, float32 with TF32 off:
   step 1's gradients within 1e-3 of their largest entry, the losses
   within relative 1e-3; steps/s of both and the halo bytes;
27. sharded_train_reference: two sharded steps of ``edsr_m`` x2 on the
   same mesh shape, card against CPU: losses within relative 1e-3;
28. dryrun: ``parallel/dryrun.dryrun_multichip(8)`` on a virtual mesh of
   ``cuda:0``, once with every K1/K2 launch held against the plain
   version, then with the counts reset;
29. drivers: the drivers of ``srs_tpu_torch/drivers/``. ``proof_200mp``
   on the store's nets at the 200MP preset at 16 bits (17320x9742 from
   the 720x1280 input, which routing sends to ``edsr_l_robust`` on the
   [2, 2, 3] ladder, 6 tiles of 512 px to 6144 px): once as a
   subprocess (cold), then in this process with every K1/K2 launch held
   against the plain version ([6,6144^2,3] among them), then timed with
   the counts reset: ``PROOF OK``, one SR attempt, no degradation, peak
   memory under 80 GB, stage times and MP/s; the TIFF read back
   (uint16, outside the timing) and area-downscaled to 1280x720 at least
   30 dB from the input. ``quality_bench --n 2 --size 512 --no-photo``
   (seven rows, launches held). The training drivers for a few steps
   into a temporary directory (``pretrain --only edsr_xl_x3 --mix proc``,
   ``train_polish``, ``train_cond``, which must move the FiLM layer,
   ``train_lpips``, ``fit_qa_models --only lpips``, ``train_ark``): finite
   losses, each saved file reloading equal; ``reeval --only edsr_xl_x3``
   on pretrain's net (its PSNR within 1e-3 dB of pretrain's) and
   ``eval_ark`` on the
   generator just trained; and the photo-bound drivers (``photo_eval``,
   ``routed_panel``, ``cond_panel``, ``fit_fusion``, the full
   ``fit_qa_models``, quality_bench's photo row) raise
   ``PhotoDataMissing`` naming a missing package;
30. drivers_reference: card against CPU at a reduced size (the store
   hidden): the proof at 32x18 -> 416x234 (still [3, 4]) within 16 in
   16-bit units, ``quality_bench --n 1 --size 192`` with seeded nets
   behind every row, each row within 0.05 dB and no two alike, and
   ``pretrain`` 3 steps of
   a seeded espcn x2 in float32 with TF32 off on the same batches, the
   loss within relative 1e-3 and the parameters' change within 1e-2;
31. kernel_shapes: K1 and K2 timed at every distinct (input, output)
   shape that the warm-up runs launched, each with its launches per
   path, bound and share of the bound.

With ``--profile`` it then runs both paths and the fusion case once more
under ``torch.profiler`` and prints the device's busy share, per stage
and in all, its time by kernel (K1 and K2 always, in all and per launch
with its shape) and by op, and the in-place adds by input shape; and a
zssr tune and a trainer run, each 30 steps of edsr_xl x3, with the busy
share, device launches a step and time by kernel and op; and the
generator's training step, 50-step sample and refinement chunk at the
packaged width, likewise.
Then it prints a ``done`` line with the total seconds, the kernels' JSON
line (each kernel's entry with its ``shapes`` of phase 31), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Without a CUDA card, or without the port
beside it, it exits with code 2 and prints no result. Outputs go to a
temporary directory that is removed at the end.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Tolerance of a kernel against its plain version on the same inputs
# (data in [0, 255]): float32 rounding differs where nvcc contracts a
# multiply and an add into one FMA; 2.55e-4 is 1e-6 of the data range.
KERNEL_ATOL = 2.55e-4
# Published H100 SXM rates (NVIDIA data sheet): memory and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# K2 cases at the edges of its blocking (a block covers 128 source
# columns, 256 output, and 32 source rows, 64 output): sizes at those
# boundaries and one either side, odd n and n = 2m - 2, rows whose
# n_w * C is not a multiple of 4 (scalar stores), C = 1, 3 and 5,
# batch 1 and 6, and rank-3 inputs. (input shape, output (h, w)).
PYR_UP_EDGE_CASES = [
    ((1, 32, 128, 3), (64, 256)),
    ((1, 33, 129, 3), (65, 257)),
    ((1, 31, 127, 3), (60, 252)),
    ((6, 64, 256, 3), (127, 511)),
    ((6, 65, 255, 3), (128, 508)),
    ((1, 32, 129, 1), (63, 257)),
    ((2, 16, 128, 1), (32, 256)),
    ((2, 17, 130, 5), (34, 259)),
    ((1, 96, 384, 5), (191, 768)),
    ((33, 128, 3), (65, 255)),
    ((64, 257, 3), (128, 512)),
    ((1, 1, 300, 3), (1, 599)),
    ((1, 300, 1, 3), (599, 1)),
]

# K1 cases at the edges of its blocking (a block covers 128 output
# columns, 256 source, and a run of 4 to 32 output rows that the launcher
# sizes from the grid): sizes at those boundaries and one either side,
# odd H and W, H or W from 1 to 5 (REFLECT_101 folds more than once),
# rows whose W * C or output W * C is not a multiple of 4 (scalar copies
# or stores), C = 1, 3 and 5, batch 1 and 6, rank-3 inputs, and grids of
# under 2 x 132 blocks, which take the shortest run. Input shapes.
PYR_DOWN_EDGE_CASES = [
    (1, 64, 256, 3),
    (1, 63, 255, 3),
    (1, 65, 257, 3),
    (6, 128, 512, 3),
    (2, 129, 513, 1),
    (1, 40, 260, 3),
    (1, 40, 255, 1),
    (2, 37, 130, 5),
    (1, 1, 300, 3),
    (1, 2, 301, 3),
    (1, 300, 1, 3),
    (1, 301, 2, 3),
    (1, 3, 5, 3),
    (1, 4, 4, 3),
    (1, 5, 3, 1),
    (64, 257, 3),
    (300, 64, 3),
    (1, 288, 288, 3),
    (6, 288, 288, 3),
    (6, 576, 576, 3),
]

MAIN_H, MAIN_W = 720, 1280
MAIN_OUT = (12245, 6887)  # (width, height) of the 100MP preset at 16:9

# The store's files the default path reads (srs_tpu_torch/models/
# checkpoints/): the x3 net that selection serves, and the LPIPS features.
PACKAGED_READS = ("edsr_xl_x3.pt", "lpips_vgg.pt", "lpips_alex.pt")
# Card against CPU for the fusion case in bfloat16 (weights up to 1.31 in
# magnitude scale each member's bf16 difference between cuDNN and the
# CPU): PSNR between the two TIFFs, measured near 69 dB on an H100; the
# floor is the one the CPU tests hold a bf16 net to against the JAX net.
FUSION_BF16_PSNR_FLOOR = 45.0
# Report keys the bench path must produce, each finite.
REPORT_KEYS = ("psnr", "ssim", "ms_ssim", "lpips_vgg", "lpips_alex", "niqe", "brisque",
               "fullres_niqe", "fullres_brisque", "fullres_sharpness", "fullres_contrast",
               "overall_score")
# Card against CPU, with the tolerances of the CPU tests
# (tests/test_torch_routing.py, tests/test_torch_pipeline.py): the probe's
# bfloat16 gain and alpha, and each report value per key.
GAIN_ATOL_DB, ALPHA_ATOL = 0.1, 0.01
# A served alpha 0.001 apart is another output: the report is then held
# to relative 2e-2 in every key, as the CPU test of the shrink route does.
ALPHA_APART_RTOL = 2e-2


def report_tolerance(key: str) -> tuple:
    """(absolute, relative) tolerance of one report value, card against
    CPU; a value passes within either. NIQE and BRISQUE pick shape
    parameters from a moment-ratio table by argmin, where a near tie takes
    the neighbouring entry."""
    if key.startswith("psnr"):
        return 1e-3, 0.0
    if key.startswith(("ssim", "ms_ssim")):
        return 1e-5, 0.0
    if key in ("niqe", "brisque", "fullres_niqe", "fullres_brisque"):
        return 0.0, 2e-2
    if key.startswith("fullres_"):
        return 0.0, 1e-2
    return 1e-6, 1e-4


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **kw}),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, flops: int) -> tuple:
    """Least milliseconds the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pyr_down_work(shape_in, shape_out) -> tuple:
    """Bytes (one read of the input, one write of the output) and FLOP of
    K1: 9 FLOP per sample in each pass (5 multiplies, 4 adds), the
    vertical pass on [.., ceil(H/2), W, C], the horizontal on the output."""
    n_in, n_out = int(np.prod(shape_in)), int(np.prod(shape_out))
    n_vert = n_out // shape_out[-2] * shape_in[-2]
    return (n_in + n_out) * 4, 9 * (n_vert + n_out)


def pyr_up_work(shape_in, shape_out) -> tuple:
    """Bytes (one read of the input, one write of the output) and FLOP of
    K2: ~3 FLOP per sample in each pass (even: 4, odd: 2), the vertical
    pass on [.., n_h, m_w, C], the horizontal on the output."""
    n_in, n_out = int(np.prod(shape_in)), int(np.prod(shape_out))
    n_vert = n_out // shape_out[-2] * shape_in[-2]
    return (n_in + n_out) * 4, 3 * (n_vert + n_out)


def ptxas_summary(log_path: str) -> list:
    """[kernel, registers, spill stores, spill loads] per entry function
    of a library built with ``-Xptxas -v``."""
    rows, cur = [], None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                cur = [line.split("'")[1], None, None, None]
                rows.append(cur)
            elif cur is not None and "spill stores" in line:
                words = line.split()
                cur[2], cur[3] = int(words[4]), int(words[8])
            elif cur is not None and "Used" in line and "registers" in line:
                cur[1] = int(line.split("Used")[1].split()[0])
    return rows


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """Photo-like test input in [0, 255]: smooth colour fields, edges,
    texture and sensor noise, all from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2) * np.pi / np.array([h, w])
        img[..., c] = 128 + 60 * np.sin(fy * y + rng.uniform(0, 6)) * np.cos(fx * x)
    for _ in range(12):  # hard-edged discs
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.03, 0.2) * h
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += 12 * np.sin(0.9 * x + 0.4 * y)[..., None]  # fine texture
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def check_kernels(torch, K) -> dict:
    """Hold K1/K2 against their plain versions; time both at the main
    path's largest shapes. Returns the per-kernel numbers."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    def err(a, b):
        return float((a - b).abs().max())

    worst = {"pyr_down": 0.0, "pyr_up": 0.0}
    # Odd, even and tiny sizes, and channel counts other than 3.
    for shape in [(2, 63, 129, 3), (1, 5, 7, 3), (1, 1, 1, 3), (3, 2, 3, 1),
                  (2, 8, 9, 5), (1, 33, 32, 3), *PYR_DOWN_EDGE_CASES]:
        x = rand(*shape)
        worst["pyr_down"] = max(worst["pyr_down"], err(K.pyr_down(x), K.pyr_down_plain(x)))
    for shape, dst in [((2, 33, 65, 3), (65, 129)), ((2, 33, 65, 3), (66, 130)),
                       ((2, 33, 65, 3), (64, 128)), ((1, 1, 1, 3), (1, 1)),
                       ((1, 1, 1, 3), (2, 2)), ((1, 3, 5, 1), (5, 9)),
                       ((1, 3, 5, 5), (6, 10)), ((1, 17, 16, 3), (34, 31)),
                       *PYR_UP_EDGE_CASES]:
        x = rand(*shape)
        worst["pyr_up"] = max(worst["pyr_up"], err(K.pyr_up(x, dst), K.pyr_up_plain(x, dst)))

    torch.backends.cudnn.allow_tf32 = False
    g1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev) / 16.0
    g2 = torch.outer(g1, g1)

    # K1 at level 0 of the tile batch: [6,4608,4608,3] -> [6,2304,2304,3].
    x = rand(6, 4608, 4608, 3)
    worst["pyr_down"] = max(worst["pyr_down"], err(K.pyr_down(x), K.pyr_down_plain(x)))
    planes = x.permute(0, 3, 1, 2).reshape(18, 1, 4608, 4608).contiguous()
    conv = torch.nn.Conv2d(1, 1, 5, stride=2, padding=2, padding_mode="reflect",
                           bias=False).to(dev)
    conv.weight.data.copy_(g2[None, None])
    with torch.inference_mode():
        lib_err = err(conv(planes).reshape(6, 3, 2304, 2304).permute(0, 2, 3, 1),
                      K.pyr_down_plain(x))
        down = {
            "ms": cuda_ms(lambda: K.pyr_down(x), 50),
            "plain_ms": cuda_ms(lambda: K.pyr_down_plain(x), 5),
            "library_ms": cuda_ms(lambda: conv(planes), 20),
            "library_call": "nn.Conv2d(5x5, stride 2, padding_mode='reflect') on [18,1,4608,4608]",
            "library_max_abs_err": lib_err,
            "shape": "[6,4608,4608,3] -> [6,2304,2304,3]",
        }
        down["bytes"], down["flops"] = pyr_down_work(x.shape, (6, 2304, 2304, 3))
    del planes
    # K2 at the finest Laplacian level: [6,2304,2304,3] -> [6,4608,4608,3].
    xs = rand(6, 2304, 2304, 3)
    worst["pyr_up"] = max(worst["pyr_up"], err(K.pyr_up(xs, (4608, 4608)),
                                               K.pyr_up_plain(xs, (4608, 4608))))
    planes = xs.permute(0, 3, 1, 2).reshape(18, 1, 2304, 2304).contiguous()
    wt = (4.0 * g2)[None, None]
    with torch.inference_mode():
        up = {
            "ms": cuda_ms(lambda: K.pyr_up(xs, (4608, 4608)), 50),
            "plain_ms": cuda_ms(lambda: K.pyr_up_plain(xs, (4608, 4608)), 5),
            "library_ms": cuda_ms(
                lambda: F.conv_transpose2d(planes, wt, stride=2, padding=2,
                                           output_padding=1), 20),
            "library_call": "F.conv_transpose2d(5x5, stride 2) on [18,1,2304,2304]; "
                            "zero borders where pyrUp reflects",
            "shape": "[6,2304,2304,3] -> [6,4608,4608,3]",
        }
        up["bytes"], up["flops"] = pyr_up_work(xs.shape, (6, 4608, 4608, 3))
    del x, xs, planes
    torch.cuda.empty_cache()
    out = {}
    for name, d in (("pyr_down", down), ("pyr_up", up)):
        d["bound_ms"], d["bound_by"] = bound(d["bytes"], d["flops"])
        d["max_abs_err"] = worst[name]
        if worst[name] > KERNEL_ATOL:
            fail(f"{name} kernel disagrees with its plain version: "
                 f"max abs err {worst[name]} > {KERNEL_ATOL}")
        out[name] = d
    return out


def time_kernel_shapes(torch, K, held_by_path: dict) -> dict:
    """K1 and K2 at every distinct (input, output) shape of the warm-up
    runs, on random data of that shape: its launches per call on each
    path, the worst error held against the plain version there, mean
    milliseconds (CUDA events), bound and share of the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    calls = {"pyr_down": (lambda x, dst: K.pyr_down(x), pyr_down_work),
             "pyr_up": (lambda x, dst: K.pyr_up(x, dst), pyr_up_work)}
    out = {}
    for name, (call, work) in calls.items():
        by_shape = {}
        for path, held in held_by_path.items():
            for shape_in, shape_out, e in held[name]["shapes"]:
                key = (tuple(shape_in), tuple(shape_out))
                counts, worst = by_shape.get(key, ({}, 0.0))
                counts[path] = counts.get(path, 0) + 1
                by_shape[key] = (counts, max(worst, e))
        rows = []
        for (shape_in, shape_out), (counts, worst) in by_shape.items():
            x = torch.rand(shape_in, generator=gen, device=dev) * 255.0
            dst = shape_out[-3:-1]
            nbytes, flops = work(shape_in, shape_out)
            ms = cuda_ms(lambda: call(x, dst), max(10, min(200, int(4e9 // nbytes))))
            bound_ms, bound_by = bound(nbytes, flops)
            rows.append({"in": list(shape_in), "out": list(shape_out), "launches": counts,
                         "max_abs_err": worst, "ms": ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "pct_of_bound": 100.0 * bound_ms / ms})
            del x
        out[name] = rows
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def pyramid_calls(K, on_call):
    """While open, every pyrDown/pyrUp call the pipeline makes through
    ``ops/pyramid.py``, ``ops/blend.py`` and ``parallel/halo.py`` launches
    the kernel as usual and then calls ``on_call(name, input, output,
    dst_hw)``."""
    import srs_tpu_torch.ops.blend as blend
    import srs_tpu_torch.ops.pyramid as pyramid
    import srs_tpu_torch.parallel.halo as halo

    def down(x):
        out = K.pyr_down(x)
        on_call("pyr_down", x, out, None)
        return out

    def up(x, dst_hw=None):
        out = K.pyr_up(x, dst_hw)
        on_call("pyr_up", x, out, dst_hw)
        return out

    sites = [(pyramid, "pyr_down", down), (pyramid, "pyr_up", up), (blend, "pyr_down", down),
             (blend, "pyr_up", up), (halo, "pyr_up", up)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    for mod, attr, fn in sites:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def recorded_shapes(K, shapes: dict):
    """Appends the (input, output) shape of every pyrDown/pyrUp call to
    ``shapes[name]``, in launch order."""
    with pyramid_calls(K, lambda name, x, out, _dst: shapes[name].append(
            [list(x.shape), list(out.shape)])):
        yield shapes


@contextlib.contextmanager
def held_against_plain(K):
    """While open, every pyrDown/pyrUp call also runs the plain version on
    the same input. Yields the records, (name, input shape, output shape,
    max abs err) per call; the comparison itself launches nothing the
    counts see beyond the pipeline's own call."""
    records = []
    plain = {"pyr_down": lambda x, _dst: K.pyr_down_plain(x), "pyr_up": K.pyr_up_plain}

    def hold(name, x, out, dst_hw):
        records.append((name, list(x.shape), list(out.shape),
                        float((out - plain[name](x, dst_hw)).abs().max())))

    with pyramid_calls(K, hold):
        yield records


def reference_check(torch, tmp: str) -> dict:
    """The pipeline on small inputs, on the card and on the CPU with the
    plain versions and float32 convolutions (TF32 off). Routing, selection
    and QA off: same TIFF within 1 LSB. On (the bench flags, 96x112 ->
    1008x864, so the probe runs): the same routing decision and ladder
    models, gain and alpha within their bfloat16 tolerances, TIFF within
    1 LSB, and the same report keys with each value within
    ``report_tolerance``."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.models.registry import seeded_params
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    torch.backends.cudnn.allow_tf32 = False
    runs = {
        "quality": (synthetic_image(80, 96, seed=3), "864x720", (720, 864, 3),
                    dict(auto_route=False, per_scale_selection=False, enable_qa=False)),
        "bench": (synthetic_image(96, 112, seed=4), "1008x864", (864, 1008, 3), {}),
    }
    weights = {("edsr_m", s): seeded_params("edsr_m", s, seed=5 + s) for s in (2, 3, 4)}
    out = {}
    for name, (image, target, shape, flags) in runs.items():
        got = {}
        for device in ("cuda", "cpu"):
            cfg = PipelineConfig(block_size=64, target_resolution=target,
                                 quality_model="edsr_m", compute_dtype="float32",
                                 device=device, **flags)
            path = os.path.join(tmp, f"ref_{name}_{device}.tiff")
            pipe = SuperResolutionPipeline(cfg, weights)
            res = pipe.process(image, path)
            if not res.success:
                fail(f"reference run {name} on {device} failed: {res.error_message}")
            got[device] = (read_tiff(path).astype(np.int16), pipe.last_run_info,
                           res.quality_report)
        diff = np.abs(got["cuda"][0] - got["cpu"][0])
        if got["cuda"][0].shape != shape or diff.max() > 1:
            fail(f"card and CPU disagree on the small input ({name}): shape "
                 f"{got['cuda'][0].shape}, max diff {diff.max()} LSB")
        out[name] = {"shape": list(shape), "max_lsb": int(diff.max()),
                     "frac_differing": float((diff > 0).mean())}
        if name == "bench":
            out[name].update(compare_bench_runs(*got["cuda"][1:], *got["cpu"][1:]))
    torch.backends.cudnn.allow_tf32 = True
    return out


def compare_bench_runs(info, report, cpu_info, cpu_report) -> dict:
    """Card against CPU on the bench flags: routing, ladder models, QA."""
    r, rc = info["routing"], cpu_info["routing"]
    if r["errors"] or rc["errors"]:
        fail(f"routing swallowed an exception: card {r['errors']}, CPU {rc['errors']}")
    for key in ("ladder", "provider", "model", "models"):
        if info[key] != cpu_info[key]:
            fail(f"card and CPU route differently: {key} {info[key]} vs {cpu_info[key]}")
    if r["degradation"]["reason"] != rc["degradation"]["reason"]:
        fail(f"degradation {r['degradation']} vs {rc['degradation']}")
    if r["sr_gain"] is None or abs(r["sr_gain"] - rc["sr_gain"]) > GAIN_ATOL_DB \
            or abs(r["alpha"] - rc["alpha"]) > ALPHA_ATOL:
        fail(f"probe: card gain {r['sr_gain']} alpha {r['alpha']}, "
             f"CPU gain {rc['sr_gain']} alpha {rc['alpha']}")
    if set(report) != set(cpu_report):
        fail(f"report keys differ: {sorted(set(report) ^ set(cpu_report))}")
    same_alpha = info["sr_gain_alpha"] == cpu_info["sr_gain_alpha"]
    diffs, bad = {}, []
    for k, v in cpu_report.items():
        g = report[k]
        if isinstance(v, str) or k == "fullres_crops":
            if g != v:
                bad.append(f"{k}: card {g!r}, CPU {v!r}")
        elif np.isnan(v) or np.isnan(g):
            if not (np.isnan(v) and np.isnan(g)):
                bad.append(f"{k}: card {g}, CPU {v}")
        else:
            atol, rtol = report_tolerance(k) if same_alpha else (1e-6, ALPHA_APART_RTOL)
            d = abs(g - v)
            diffs[k] = [d, d / max(abs(v), 1e-12)]
            if d > atol and d > rtol * abs(v):
                bad.append(f"{k}: card {g}, CPU {v} (abs {d:.3g} > {atol}, "
                           f"relative {diffs[k][1]:.3g} > {rtol})")
    if bad:
        fail(f"card and CPU reports disagree (served alpha card "
             f"{info['sr_gain_alpha']}, CPU {cpu_info['sr_gain_alpha']}): {bad}; "
             f"[abs, relative] differences: {diffs}")
    return {"routing": {"provider": info["provider"], "models": info["models"],
                        "degradation": r["degradation"]["reason"],
                        "sr_gain": [r["sr_gain"], rc["sr_gain"]],
                        "alpha": [r["alpha"], rc["alpha"]],
                        "served_alpha": [info["sr_gain_alpha"], cpu_info["sr_gain_alpha"]]},
            "report_diffs": diffs}


def check_held(K, name: str, records, require_launch: bool = True) -> dict:
    """Every launch of a warm-up run was held against its plain version
    (``records`` of :func:`held_against_plain`), within the tolerance, and
    with ``require_launch`` each kernel launched at least once.
    Returns, per kernel, the calls, the worst error and each launch's
    [input shape, output shape, error]."""
    held = {}
    for kname, shape_in, shape_out, e in records:
        h = held.setdefault(kname, {"calls": 0, "max_abs_err": 0.0, "shapes": []})
        h["calls"] += 1
        h["max_abs_err"] = max(h["max_abs_err"], e)
        h["shapes"].append([shape_in, shape_out, e])
    for kname, n in K.LAUNCHES.items():
        h = held.get(kname, {"calls": 0, "max_abs_err": 0.0})
        if (require_launch and n == 0) or h["calls"] != n:
            fail(f"{name}: {kname}: {n} launches in the warm-up run, {h['calls']} held "
                 "against the plain version")
        if h["max_abs_err"] > KERNEL_ATOL:
            fail(f"{name}: {kname} disagrees with its plain version: "
                 f"max abs err {h['max_abs_err']} > {KERNEL_ATOL}")
    return held


def launches_by_shape(held: dict) -> dict:
    """Per kernel, "in -> out" shape and its launches in one run."""
    out = {}
    for kname, h in held.items():
        counts = {}
        for shape_in, shape_out, _e in h["shapes"]:
            key = f"{shape_in} -> {shape_out}"
            counts[key] = counts.get(key, 0) + 1
        out[kname] = counts
    return out


def xl_weights() -> dict:
    """Seeded weights at edsr_xl's full width for every scale the reference
    ships trained (x2, x3, x4), so the ladder choice matches it."""
    from srs_tpu_torch.models.registry import seeded_params

    return {("edsr_xl", s): seeded_params("edsr_xl", s, seed=10 + s) for s in (2, 3, 4)}


def fast_weights() -> dict:
    """Seeded espcn, the fast net, at every scale the reference ships."""
    from srs_tpu_torch.models.registry import seeded_params

    return {("espcn", s): seeded_params("espcn", s, seed=40 + s) for s in (2, 3, 4)}


@contextlib.contextmanager
def store_masked(tmp: str):
    """While open, the port's store of trained weights is hidden in this
    process (an empty directory in its place), as the CPU tests hide it:
    every net untrained unless handed in, LPIPS on seeded features; the
    packaged ledgers stay. Phases built on seeded or untrained nets run
    so."""
    from srs_tpu_torch.models import registry

    saved = registry.PACKAGED_CHECKPOINT_DIR
    registry.PACKAGED_CHECKPOINT_DIR = os.path.join(tmp, "no_store")
    try:
        yield
    finally:
        registry.PACKAGED_CHECKPOINT_DIR = saved


# The full-width quality path's configuration, and the flags that turn
# routing, selection and QA off (the main path, the providers and the
# job layer's cases run with them).
QUALITY_PATH = dict(block_size=512, overlap_ratio=0.2, target_resolution="100MP",
                    provider="quality", quality_model="edsr_xl", ibp_steps=4, bit_depth=8,
                    device="cuda")
QUALITY_FLAGS = dict(auto_route=False, per_scale_selection=False, enable_qa=False)


def drive_path(torch, K, tmp: str, name: str, image: np.ndarray, weights=None,
               prompt=None, before_run=None, ladder=(3, 3), **flags):
    """One path of ``process()`` on the 720x1280 input to the 100MP preset:
    a warm-up run with every K1/K2 launch held against its plain version,
    then a run with the launch counts set to 0 just before it and read just
    after. ``flags`` override the quality path's configuration; ``weights``
    default to :func:`xl_weights`; ``before_run(pipe)`` runs before each of
    the two runs; the timed run must serve ``ladder``. Returns (numbers,
    pipeline, result, path of the output)."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    cfg = {**QUALITY_PATH, **flags}
    pipe = SuperResolutionPipeline(PipelineConfig(**cfg),
                                   xl_weights() if weights is None else weights)
    path = os.path.join(tmp, f"out_{name}.tiff")

    if before_run is not None:
        before_run(pipe)
    K.reset_launches()
    with held_against_plain(K) as records:
        warm = pipe.process(image, path, prompt=prompt)
    if not warm.success:
        fail(f"{name}: warm-up process() failed: {warm.error_message}")
    os.remove(path)
    held = check_held(K, name, records)

    if before_run is not None:
        before_run(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.time()
    res = pipe.process(image, path, prompt=prompt)
    elapsed = time.time() - t0
    launches = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    if not res.success:
        fail(f"{name}: process() failed: {res.error_message}")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"{name} never launched kernel {kname}")
    if pipe.last_run_info["ladder"] != list(ladder):
        fail(f"{name}: ladder {pipe.last_run_info['ladder']} != {list(ladder)}")
    size = os.path.getsize(path)
    out = read_tiff(path)
    w, h = MAIN_OUT
    if out.shape != (h, w, 3) or out.dtype != np.uint8:
        fail(f"{name}: output {out.shape} {out.dtype} != ({h}, {w}, 3) uint8")
    # Content check: the output's per-channel means follow the input's.
    mean_in, mean_out = image.mean(axis=(0, 1)), out.mean(axis=(0, 1), dtype=np.float64)
    if np.abs(mean_in - mean_out).max() > 10.0 or out.std() < 10:
        fail(f"{name}: output statistics off: input means {mean_in}, output means "
             f"{mean_out}, std {out.std()}")
    return {
        "stage_times": res.stage_times,
        "warmup_stage_times": warm.stage_times,
        "elapsed_s": elapsed,
        "output_mp": w * h / 1e6,
        "mp_per_s": w * h / 1e6 / elapsed,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "memory_allocated_before_after": [mem_before, mem_after],
        "tiff_bytes": size,
        "ladder": pipe.last_run_info["ladder"],
        "num_tiles": pipe.last_run_info["num_tiles"],
        "launches": launches,
        "held_against_plain": held,
        "input_means": [float(v) for v in mean_in],
        "output_means": [float(v) for v in mean_out],
        "save_breakdown": pipe.last_run_info["save_breakdown"],
    }, pipe, res, path


def main_path(torch, K, tmp: str, image: np.ndarray):
    """The quality path: routing, per-scale selection and QA off."""
    nums, pipe, _res, _path = drive_path(
        torch, K, tmp, "main_path", image, **QUALITY_FLAGS)
    return nums, pipe


def bench_path(torch, K, tmp: str, image: np.ndarray):
    """``bench.py:69-83``'s configuration with seeded ``edsr_xl`` handed in:
    routing and the SR-gain probe, per-scale selection from the store's
    EVAL.json (the handed-in net is the trained x3 candidate it ranks
    first), QA with the store's LPIPS features and its report."""
    nums, pipe, res, path = drive_path(torch, K, tmp, "bench_path", image)
    cfg, info = pipe.config, pipe.last_run_info
    if not (cfg.auto_route and cfg.per_scale_selection and cfg.enable_qa):
        fail("bench path: routing, selection and QA must be on")
    routing = info.get("routing")
    if not routing or routing["errors"] or routing["degradation"] is None \
            or routing["sr_gain"] is None:
        fail(f"bench path: routing or the probe did not run cleanly: {routing}")
    if info["models"] != ["edsr_xl", "edsr_xl"]:
        fail(f"bench path: ladder models {info['models']}")
    report = res.quality_report or {}
    bad = [k for k in REPORT_KEYS if not np.isfinite(report.get(k, float("nan")))]
    if bad or report.get("fullres_crops", 0) <= 0:
        fail(f"bench path: report values missing or not finite: {bad}")
    # NIQE and BRISQUE come from the packaged models (the port's copies in
    # srs_tpu_torch/qa/data), not from their closed forms.
    from srs_tpu_torch.qa.niqe import DATA_DIR, brisque_score, niqe_score

    missing = [f for f in ("niqe_pristine.npz", "brisque_model.npz", "lpips_calib.json")
               if not os.path.isfile(os.path.join(DATA_DIR, f))]
    if missing:
        fail(f"bench path: QA data files missing from {DATA_DIR}: {missing}")
    proxy = torch.from_numpy(image).cuda().float()
    packaged = {"niqe": niqe_score(proxy), "brisque": brisque_score(proxy)}
    if any(v is None for v in packaged.values()):
        fail(f"bench path: the packaged NIQE/BRISQUE models were not read: {packaged}")
    report_path = path.rsplit(".", 1)[0] + "_qa_report.json"
    if not os.path.isfile(report_path):
        fail("bench path: no _qa_report.json beside the output")
    if "quality_assessment" not in res.stage_times:
        fail("bench path: no quality_assessment stage")
    lpips_sources = pipe.quality_module._lpips.sources
    if lpips_sources != {"vgg": "store", "alex": "store"}:
        fail(f"bench path: LPIPS features from {lpips_sources}, not the store")
    nums.update(
        routing=routing, provider=info["provider"], models=info["models"],
        sr_gain_alpha=info["sr_gain_alpha"], quality_score=res.quality_score,
        packaged_scores_of_input=packaged, lpips_sources=lpips_sources,
        report={k: v for k, v in report.items()},
    )
    return nums, pipe


@contextlib.contextmanager
def ibp_calls():
    """While open, each back-projection call (``sr_module.back_project``)
    appends to the list it yields."""
    import srs_tpu_torch.models.sr_module as sr_module

    calls: list = []
    real = sr_module.back_project

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    sr_module.back_project = counted
    try:
        yield calls
    finally:
        sr_module.back_project = real


def store_check(torch) -> dict:
    """The store as the card's copy holds it: every file of MANIFEST.json
    present with its bytes and sha256; then the default path's reads
    (``PACKAGED_READS``, each checked against the manifest and loaded)
    timed from cold."""
    import hashlib

    from srs_tpu_torch.models import registry

    store = registry.PACKAGED_CHECKPOINT_DIR
    manifest = registry.store_manifest()
    if not manifest or any(f not in manifest for f in PACKAGED_READS + ("EVAL.json",
                                                                       "FUSION.json")):
        fail(f"packaged: the store at {store} lists {sorted(manifest)}")
    t0 = time.time()
    bad = []
    for fname, entry in sorted(manifest.items()):
        path = os.path.join(store, fname)
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        if os.path.getsize(path) != entry["bytes"] or h.hexdigest() != entry["sha256"]:
            bad.append(fname)
    if bad:
        fail(f"packaged: store files differ from MANIFEST.json: {bad}")
    sha_s = time.time() - t0
    registry.clear_param_cache()
    load_s = {}
    for fname in PACKAGED_READS:
        t0 = time.time()
        registry.load_packaged(fname)
        load_s[fname] = time.time() - t0
    return {"files": len(manifest), "store_bytes": sum(e["bytes"] for e in manifest.values()),
            "sha256_all_s": sha_s, "load_s": load_s, "load_total_s": sum(load_s.values())}


def packaged_phase(torch, K, tmp: str, image: np.ndarray, bench_nums: dict) -> dict:
    """Phase 7: ``bench.py:69-83``'s configuration with nothing handed in (no
    weights, ledger or LPIPS parameters): the store's trained nets. The
    store's files against MANIFEST.json and its load seconds; a warm-up
    with every K1/K2 launch held against the plain version, then a run
    with the counts reset. Selection must serve the store's EVAL.json
    pick (edsr_xl at each x3 step), every served net trained with no IBP,
    the probe's gain and alpha recorded, and QA's LPIPS from the store's
    features. Then card against CPU on a small input (96x112 -> 1008x864),
    float32 with TF32 off: the same route and models, the probe within
    its bfloat16 tolerances, the TIFF within 1 LSB, the report within the
    CPU tests' tolerances."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.models.selection import panel_best_model
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    store = store_check(torch)
    with ibp_calls() as ibp:
        nums, pipe, res, _path = drive_path(torch, K, tmp, "packaged", image, weights={})
    cfg, info, sr = pipe.config, pipe.last_run_info, pipe.sr_module
    if not (cfg.auto_route and cfg.per_scale_selection and cfg.enable_qa) or cfg.checkpoint_dir:
        fail(f"packaged: not the bench configuration: {cfg}")
    picks = [panel_best_model(s, cfg.quality_model, sr.is_trained) for s in info["ladder"]]
    if info["models"] != picks or picks != ["edsr_xl", "edsr_xl"]:
        fail(f"packaged: served {info['models']}, selection from the store picks {picks}")
    untrained = [m for m, s in zip(info["models"], info["ladder"]) if not sr.is_trained(m, s)]
    if untrained or ibp:
        fail(f"packaged: untrained nets {untrained}, {len(ibp)} IBP calls")
    routing = info["routing"]
    if routing["errors"] or routing["degradation"] is None or routing["sr_gain"] is None \
            or routing["alpha"] is None:
        fail(f"packaged: routing or the probe did not run cleanly: {routing}")
    report = res.quality_report or {}
    lpips_sources = pipe.quality_module._lpips.sources
    bad = [k for k in REPORT_KEYS if not np.isfinite(report.get(k, float("nan")))]
    if bad or lpips_sources != {"vgg": "store", "alex": "store"}:
        fail(f"packaged: report values {bad} not finite, LPIPS from {lpips_sources}")

    # card against CPU on a small input, the same configuration
    torch.backends.cudnn.allow_tf32 = False
    small = synthetic_image(96, 112, seed=4)
    got = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"packaged_small_{device}.tiff")
        p = SuperResolutionPipeline(PipelineConfig(
            block_size=64, target_resolution="1008x864", ibp_steps=4,
            compute_dtype="float32", device=device))
        t0 = time.time()
        r = p.process(small, path)
        if not r.success:
            fail(f"packaged: small run on {device} failed: {r.error_message}")
        got[device] = (read_tiff(path).astype(np.int16), p.last_run_info, r.quality_report,
                       time.time() - t0)
        os.remove(path)
    torch.backends.cudnn.allow_tf32 = True
    diff = np.abs(got["cuda"][0] - got["cpu"][0])
    if got["cuda"][0].shape != (864, 1008, 3) or diff.max() > 1:
        fail(f"packaged: card and CPU disagree on the small input: shape "
             f"{got['cuda'][0].shape}, max diff {diff.max()} LSB")
    small_cmp = compare_bench_runs(*got["cuda"][1:3], *got["cpu"][1:3])
    seeded_report = bench_nums["report"]
    nums.update(
        store=store, provider=info["provider"], ladder=info["ladder"], models=info["models"],
        step_members=info["step_members"], ibp_calls=len(ibp), routing=routing,
        sr_gain_alpha=info["sr_gain_alpha"], quality_score=res.quality_score,
        lpips_sources=lpips_sources, report=dict(report),
        seeded_bench_path={"mp_per_s": bench_nums["mp_per_s"],
                           "peak_mem_gb": bench_nums["peak_mem_gb"],
                           "stage_times": bench_nums["stage_times"],
                           "routing": {k: bench_nums["routing"][k]
                                       for k in ("sr_gain", "alpha", "provider")},
                           "quality_score": bench_nums["quality_score"],
                           "report": {k: seeded_report[k] for k in REPORT_KEYS}},
        card_against_cpu={"max_lsb": int(diff.max()),
                          "frac_differing": float((diff > 0).mean()),
                          "seconds": [got["cuda"][3], got["cpu"][3]], **small_cmp},
    )
    return nums


# The command line's full-width run: the reference's ``process`` flags
# with every post-pass on, and defaults otherwise (provider quality,
# edsr_xl, 8 IBP steps, routing, per-scale selection and QA on).
CLI_FLAGS = ["--target", "100MP", "--blend", "multi_band", "--seam-repair",
             "--color-correction", "--content-aware"]
OTHER_BLENDS = ("weighted", "feather", "gradient_domain", "poisson")
ALL_BLENDS = ("laplacian", "multi_band") + OTHER_BLENDS


@contextlib.contextmanager
def captured_runs(torch):
    """While open, records each ``SuperResolutionPipeline.process`` call as
    (pipeline, result), and the card seconds of the steps inside its SR
    and blending stages, each synchronised before and after: ``ibp``
    (each back-projection call), ``blend_weights`` (the dense weights,
    content-aware ones with the content analysis), ``blend`` (the fusion
    itself), ``seam_repair`` and ``color_correction``."""
    import srs_tpu_torch.models.sr_module as sr_module
    import srs_tpu_torch.pipeline as pipeline

    runs, steps = [], {}
    cls = pipeline.SuperResolutionPipeline
    sites = {"ibp": (sr_module, "back_project"), "blend_weights": (cls, "_blend_weights"),
             "blend": (pipeline, "laplacian_fusion_tiles"), "seam_repair": (cls, "_repair"),
             "color_correction": (pipeline, "color_correction")}
    saved = {name: getattr(owner, attr) for name, (owner, attr) in sites.items()}
    process = cls.process

    def recorded(self, *args, **kwargs):
        res = process(self, *args, **kwargs)
        runs.append((self, res))
        return res

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            steps.setdefault(name, []).append(time.time() - t0)
            return out
        return call

    cls.process = recorded
    for name, (owner, attr) in sites.items():
        setattr(owner, attr, timed(name, saved[name]))
    try:
        yield runs, steps
    finally:
        cls.process = process
        for name, (owner, attr) in sites.items():
            setattr(owner, attr, saved[name])


def cv2_version():
    """OpenCV's version where it imports (the content analysis's face and
    text detectors run only then), else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def cli_path(torch, K, tmp: str, image: np.ndarray) -> dict:
    """The command line at full width on the card (module docstring, phase 8)."""
    from srs_tpu_torch import cli
    from srs_tpu_torch.io.image import load_image, save_image
    from srs_tpu_torch.io.native import read_tiff

    png = os.path.join(tmp, "in.png")
    save_image(png, image)
    t0 = time.time()
    decoded = load_image(png)
    decode_s = time.time() - t0
    if not np.array_equal(decoded, np.clip(image, 0, 255).astype(np.uint8).astype(np.float32)):
        fail("cli_path: the PNG the port wrote does not decode to its pixels")
    out = os.path.join(tmp, "cli.tiff")
    argv = ["process", png, out, *CLI_FLAGS]

    K.reset_launches()
    with held_against_plain(K) as records, captured_runs(torch) as (runs, _ibp):
        if cli.main(argv) != 0:
            fail(f"cli_path: warm-up main({argv}) failed")
    held = check_held(K, "cli_path", records)
    warm_pipe, warm = runs[-1]
    os.remove(out)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with captured_runs(torch) as (runs, steps):
        t0 = time.time()
        rc = cli.main(argv)
        elapsed = time.time() - t0
    ibp = steps.get("ibp", [])
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(runs) != 1:
        fail(f"cli_path: main({argv}) returned {rc}")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"cli_path never launched kernel {kname}")
    pipe, res = runs[0]
    cfg, info = pipe.config, pipe.last_run_info
    if cfg.blend_method != "multi_band" or not (cfg.enable_seam_repair and
                                                cfg.enable_color_correction and
                                                cfg.content_aware and cfg.enable_qa):
        fail(f"cli_path: the flags did not reach the config: {cfg}")
    if info["ladder"] != [3, 3] or any(pipe.sr_module.is_trained(m, 3) for m in info["models"]):
        fail(f"cli_path: expected untrained nets on [3, 3], got {info['ladder']} "
             f"{info['models']}")
    if len(ibp) != 1 or cfg.ibp_steps != 8:
        fail(f"cli_path: IBP ran {len(ibp)} times with {cfg.ibp_steps} steps")
    if "seam_repair" not in info or "error" in info.get("content", {"error": "not run"}):
        fail(f"cli_path: seam repair or the content analysis did not run: "
             f"{info.get('seam_repair')}, {info.get('content')}")
    w, h = MAIN_OUT
    got = read_tiff(out)
    if got.shape != (h, w, 3) or got.dtype != np.uint8:
        fail(f"cli_path: output {got.shape} {got.dtype} != ({h}, {w}, 3) uint8")
    mean_in, mean_out = image.mean(axis=(0, 1)), got.mean(axis=(0, 1), dtype=np.float64)
    if np.abs(mean_in - mean_out).max() > 10.0 or got.std() < 10:
        fail(f"cli_path: output statistics off: input means {mean_in}, output means "
             f"{mean_out}, std {got.std()}")
    report = res.quality_report or {}
    bad = [k for k in REPORT_KEYS if not np.isfinite(report.get(k, float("nan")))]
    if bad:
        fail(f"cli_path: report values missing or not finite: {bad}")

    small = os.path.join(tmp, "sub.tiff")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "srs_tpu_torch", "process", png, small, "--target", "1024x576"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    sub_s = time.time() - t0
    if proc.returncode != 0 or not proc.stdout.startswith(f"OK {small}"):
        fail(f"cli_path: python3 -m srs_tpu_torch process exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    if read_tiff(small).shape != (576, 1024, 3):
        fail(f"cli_path: the subprocess wrote {read_tiff(small).shape}")
    if "untrained net" in proc.stderr:  # the store's nets serve it
        fail(f"cli_path: the subprocess served an untrained net: {proc.stderr[-2000:]}")
    return {
        "argv": argv,
        "png_decode_s": decode_s,
        "png_bytes": os.path.getsize(png),
        "stage_times": res.stage_times,
        "warmup_stage_times": warm.stage_times,
        "elapsed_s": elapsed,
        "mp_per_s": w * h / 1e6 / elapsed,
        "peak_mem_gb": peak,
        "ibp_s": ibp[0],
        "ibp_shape": [6, 4608, 4608, 3],
        "step_seconds": {k: sum(v) for k, v in steps.items()},
        "ladder": info["ladder"],
        "models": info["models"],
        "routing": {"provider": info["provider"], "sr_gain": info["routing"]["sr_gain"],
                    "errors": info["routing"]["errors"]},
        "seam_repair": info["seam_repair"],
        "warmup_seam_repair": warm_pipe.last_run_info["seam_repair"],
        "content": info["content"],
        "cv2": cv2_version(),
        "quality_score": res.quality_score,
        "save_breakdown": info["save_breakdown"],
        "launches": launches,
        "launches_by_shape": launches_by_shape(held),
        "held_against_plain": held,
        "subprocess": {"argv_tail": ["--target", "1024x576"], "seconds": sub_s,
                       "stdout": proc.stdout.strip().splitlines()},
    }


def other_blends(torch, tmp: str, image: np.ndarray) -> dict:
    """``process()`` with each other blend at full width, QA off, no
    weights: blending seconds, and the peak and added memory of the blend
    (``_blend`` alone: the Poisson solve's temporaries show there)."""
    import srs_tpu_torch.pipeline as pipeline
    from srs_tpu_torch.io.native import read_tiff

    cls = pipeline.SuperResolutionPipeline
    blend = cls._blend
    mem = {}

    def measured(self, *args, **kwargs):
        torch.cuda.synchronize()
        mem["at_entry_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        out = blend(self, *args, **kwargs)
        torch.cuda.synchronize()
        mem["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        mem["added_gb"] = mem["peak_gb"] - mem["at_entry_gb"]
        return out

    out = {}
    w, h = MAIN_OUT
    cls._blend = measured
    try:
        for name in OTHER_BLENDS:
            path = os.path.join(tmp, f"blend_{name}.tiff")
            cfg = pipeline.PipelineConfig(blend_method=name, enable_qa=False)
            t0 = time.time()
            res = cls(cfg).process(image, path)
            elapsed = time.time() - t0
            if not res.success:
                fail(f"other_blends: {name}: {res.error_message}")
            got = read_tiff(path)
            if got.shape != (h, w, 3) or np.abs(got.mean(axis=(0, 1)) -
                                                image.mean(axis=(0, 1))).max() > 10.0:
                fail(f"other_blends: {name}: output {got.shape}, means "
                     f"{got.mean(axis=(0, 1))}")
            os.remove(path)
            out[name] = {"blending_s": res.stage_times["blending"], "elapsed_s": elapsed,
                         "mp_per_s": w * h / 1e6 / elapsed, "stage_times": res.stage_times,
                         "blend_memory": dict(mem)}
    finally:
        cls._blend = blend
    return out


def blend_reference(torch, tmp: str) -> dict:
    """Card against CPU on small inputs, no weights (untrained nets, 8 IBP
    steps): each blend, and multi_band with the three post-passes, TIFFs
    within 1 LSB; then seam detection and repair of a scene with medium
    and high seams on both, the same seams and canvases within 1e-3."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.ops.seam import detect_seams, repair_seams
    from srs_tpu_torch.ops.tiles import extract_tiles, merge_tiles
    from srs_tpu_torch.ops.weights import layout_weights
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
    from srs_tpu_torch.tiling.geometry import compute_layout

    image = synthetic_image(72, 96, seed=5)
    runs = {b: dict(blend_method=b) for b in ALL_BLENDS}
    runs["multi_band+post"] = dict(blend_method="multi_band", enable_seam_repair=True,
                                   enable_color_correction=True, content_aware=True)
    out = {}
    for name, flags in runs.items():
        got = {}
        for device in ("cuda", "cpu"):
            # edsr_m in float32: the CPU side stays quick; untrained, the
            # net is bicubic whatever its width
            cfg = PipelineConfig(block_size=32, target_resolution="384x288", enable_qa=False,
                                 quality_model="edsr_m", compute_dtype="float32",
                                 device=device, **flags)
            path = os.path.join(tmp, f"small_{name}_{device}.tiff")
            res = SuperResolutionPipeline(cfg).process(image, path)
            if not res.success:
                fail(f"blend_reference: {name} on {device}: {res.error_message}")
            got[device] = read_tiff(path).astype(np.int16)
        diff = np.abs(got["cuda"] - got["cpu"])
        if got["cuda"].shape != (288, 384, 3) or diff.max() > 1:
            fail(f"blend_reference: card and CPU disagree on {name}: shape "
                 f"{got['cuda'].shape}, max diff {diff.max()} LSB")
        out[name] = {"max_lsb": int(diff.max()), "frac_differing": float((diff > 0).mean())}

    # a 3x3 grid of 64-px tiles that disagree in their overlaps
    lo = compute_layout(176, 176, 64, 0.3, step_multiple=8)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0 : lo.padded_h, 0 : lo.padded_w].astype(np.float32)
    scene = np.stack([128 + 70 * np.sin(xx / 11.0), 128 + 70 * np.cos(yy / 9.0),
                      128 + 50 * np.sin((xx + yy) / 13.0)], -1).astype(np.float32)
    tiles = extract_tiles(torch.from_numpy(scene), lo).clone()
    for t in range(lo.num_tiles):
        tiles[t] += torch.from_numpy(rng.normal(0, 4 + 12 * (t % 3), tiles[t].shape)).float()
    canvas = merge_tiles(tiles, layout_weights(lo, "ramp"), lo)
    found = {}
    for device in ("cuda", "cpu"):
        c, t = canvas.to(device), tiles.to(device)
        seams = detect_seams(extract_tiles(c, lo), t, lo)
        bad = [s for s in seams if s.severity != "low"]
        found[device] = (seams, repair_seams(c, bad, t, lo).cpu())
    (s_gpu, r_gpu), (s_cpu, r_cpu) = found["cuda"], found["cpu"]
    same = [(a.x, a.y, a.width, a.height, a.severity) for a in s_gpu] == \
        [(a.x, a.y, a.width, a.height, a.severity) for a in s_cpu]
    err = float((r_gpu - r_cpu).abs().max()) if same else float("inf")
    severities = [s.severity for s in s_cpu]
    if not same or err > 1e-3 or "high" not in severities or "medium" not in severities:
        fail(f"blend_reference: seam repair, card against CPU: same seams {same}, "
             f"max abs err {err}, severities {sorted(set(severities))}")
    out["seam_repair_scene"] = {"seams": len(s_cpu), "high": severities.count("high"),
                                "medium": severities.count("medium"), "max_abs_err": err}
    return out


# The serving case that needs an untrained quality net (the polish runs
# only after one): it runs with the store hidden (``store_masked``).
UNTRAINED_CASES = ("hybrid",)


def provider_cases() -> dict:
    """The eight serving cases: name -> (config flags, weights, prompt).
    Every fusion member of the store's FUSION.json is seeded at x3,
    edsr_xl at x2/x3/x4 (the ladder's nets); the reference's remote names
    ``seedream`` and ``veimagex`` serve the quality path's and the fast
    case's nets."""
    from srs_tpu_torch.models.registry import seeded_params

    xl = xl_weights()
    members = {(m, 3): seeded_params(m, 3, seed=20 + i)
               for i, m in enumerate(("edsr_l", "rcan", "edsr_m", "espcn"))}
    return {
        "fusion": (dict(provider="fusion"), {**xl, **members}, None),
        "self_ensemble": (dict(self_ensemble=True), xl, None),
        "prompt": ({}, {**xl, ("cond_polish", 1): seeded_params("cond_polish", 1, seed=30)},
                   "food"),
        "hybrid": (dict(provider="hybrid"),
                   {("espcn_polish", 1): seeded_params("espcn_polish", 1, seed=31)}, None),
        "fast": (dict(provider="fast"), fast_weights(), None),
        "rcan": (dict(quality_model="rcan"),
                 {("rcan", s): seeded_params("rcan", s, seed=50 + s) for s in (2, 3, 4)},
                 None),
        "seedream": (dict(provider="seedream"), xl, None),
        "veimagex": (dict(provider="veimagex"), fast_weights(), None),
    }


def expected_members(name: str) -> list:
    """The [net, passes] each ladder step of a case must report (fusion's
    members from the store's FUSION.json at x3)."""
    from srs_tpu_torch.models.fusion import load_fusion

    fused = [[m.rstrip("+"), 8 if m.endswith("+") else 1]
             for m in load_fusion(3)[0] if m != "bicubic"]
    return {"fusion": fused, "self_ensemble": [["edsr_xl", 8]], "prompt": [["edsr_xl", 1]],
            "hybrid": [["edsr_xl", 1], ["espcn_polish", 1]], "fast": [["espcn", 1]],
            "rcan": [["rcan", 1]], "seedream": [["edsr_xl", 1]],
            "veimagex": [["espcn", 1]]}[name]


def providers(torch, K, tmp: str, image: np.ndarray, quality_tiff: str):
    """The eight serving cases at full width (module docstring, phase 11).
    ``seedream`` must land within 1 LSB of the quality path's TIFF (the
    same nets) and ``veimagex`` of the fast case's. Returns (numbers,
    pipeline) per case."""
    from srs_tpu_torch.io.native import read_tiff

    out, pipes = {}, {}
    for name, (flags, weights, prompt) in provider_cases().items():
        with (store_masked(tmp) if name in UNTRAINED_CASES else contextlib.nullcontext()):
            nums, pipe, _res, path = drive_path(torch, K, tmp, f"provider_{name}", image,
                                                weights=weights, prompt=prompt,
                                                **{**QUALITY_FLAGS, **flags})
        info = pipe.last_run_info
        want = expected_members(name)
        if info["step_members"] != [want, want]:
            fail(f"providers: {name}: step members {info['step_members']}, want {want} "
                 "at each of the two steps")
        served = {"fusion": "fusion", "hybrid": "hybrid", "fast": "fast", "seedream": "seedream",
                  "veimagex": "veimagex"}.get(name, "quality")
        if info["provider"] != served:
            fail(f"providers: {name}: served {info['provider']}, want {served}")
        if name == "prompt":
            if not info["conditioned"] or info["prompt_category"] != "food":
                fail(f"providers: prompt: not conditioned: {info['prompt_category']}")
            # the quality path's TIFF: the same nets and input, unconditioned
            diff = np.abs(read_tiff(path).astype(np.int16) - read_tiff(quality_tiff))
            nums["prompt_vs_quality_path"] = {"mean_abs_lsb": float(diff.mean()),
                                              "max_lsb": int(diff.max()),
                                              "frac_differing": float((diff > 0).mean())}
            if diff.max() == 0:
                fail("providers: prompt: the conditioned output equals the quality path's")
        # the remote names serve the same nets as quality and fast
        alias_of = {"seedream": quality_tiff,
                    "veimagex": os.path.join(tmp, "out_provider_fast.tiff")}.get(name)
        if alias_of is not None:
            worst, share = lsb_apart(path, alias_of)
            nums["vs_served_tier"] = {"max_lsb": worst, "frac_differing": share}
            if worst > 1:
                fail(f"providers: {name} is {worst} LSB from its tier's TIFF")
        if name != "fast":  # veimagex is held against it
            os.remove(path)
        nums.update(provider=info["provider"], models=info["models"],
                    step_members=info["step_members"], self_ensemble=info["self_ensemble"],
                    conditioned=info["conditioned"])
        out[name], pipes[name] = nums, pipe
    os.remove(os.path.join(tmp, "out_provider_fast.tiff"))
    return out, pipes


def provider_reference(torch, tmp: str) -> dict:
    """The six cases on a small input, card against CPU (module docstring,
    phase 12)."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    image = synthetic_image(48, 64, seed=6)
    cases = provider_cases()
    runs = [(name, "float32") for name in cases] + [("fusion", "bfloat16")]
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, dtype in runs:
        flags, weights, prompt = cases[name]
        got = {}
        for device in ("cuda", "cpu"):
            cfg = PipelineConfig(**{"block_size": 32, "target_resolution": "192x144",
                                    "quality_model": "edsr_xl", "compute_dtype": dtype,
                                    "device": device, **QUALITY_FLAGS, **flags})
            path = os.path.join(tmp, f"prov_{name}_{dtype}_{device}.tiff")
            t0 = time.time()
            with (store_masked(tmp) if name in UNTRAINED_CASES else contextlib.nullcontext()):
                pipe = SuperResolutionPipeline(cfg, weights)
                res = pipe.process(image, path, prompt=prompt)
            if not res.success:
                fail(f"provider_reference: {name} {dtype} on {device}: {res.error_message}")
            got[device] = (read_tiff(path).astype(np.int16), pipe.last_run_info,
                           time.time() - t0)
        (a, info, t_gpu), (b, cpu_info, t_cpu) = got["cuda"], got["cpu"]
        diff = np.abs(a - b)
        key = name if dtype == "float32" else f"{name}_{dtype}"
        if a.shape != (144, 192, 3) or info["step_members"] != cpu_info["step_members"] \
                or info["step_members"] != [expected_members(name)]:
            fail(f"provider_reference: {key}: shape {a.shape}, step members card "
                 f"{info['step_members']}, CPU {cpu_info['step_members']}")
        mse = float(np.mean(diff.astype(np.float64) ** 2))
        psnr = float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
        out[key] = {"max_lsb": int(diff.max()), "frac_differing": float((diff > 0).mean()),
                    "psnr_db": psnr, "seconds": [t_gpu, t_cpu]}
        if dtype == "float32" and diff.max() > 1:
            fail(f"provider_reference: card and CPU disagree on {key}: max diff "
                 f"{diff.max()} LSB")
        if dtype == "bfloat16" and psnr < FUSION_BF16_PSNR_FLOOR:
            fail(f"provider_reference: {key}: card against CPU {psnr:.2f} dB < "
                 f"{FUSION_BF16_PSNR_FLOOR} dB")
    torch.backends.cudnn.allow_tf32 = True
    return out


JOB_CASES = ("degrade", "transient", "cancel", "resume", "batch")
# memory_allocated() after a failed, degraded or cancelled job may exceed
# its value before by at most this (a failed attempt's chunk would hold
# gigabytes).
LEAK_TOL_BYTES = 4 << 20
# A resumed TIFF against a fresh run's: the store keeps uint8 tiles
# (tests/test_pipeline.py:456 holds the reference to the same bound).
RESUME_LSB = 2


def max_lsb(path: str, ref_path: str) -> int:
    from srs_tpu_torch.io.native import read_tiff

    a, b = read_tiff(path), read_tiff(ref_path)
    if a.shape != b.shape:
        fail(f"{path}: shape {a.shape} != {b.shape}")
    return int(np.abs(a.astype(np.int16) - b).max())


def real_upscale(pipe):
    """The SR module's own ``upscale_tiles``, bound to its instance."""
    return type(pipe.sr_module).upscale_tiles.__get__(pipe.sr_module)


def jobs_degrade(torch, K, tmp: str, image: np.ndarray) -> tuple:
    """A real CUDA OOM in every quality-net call: the real net runs on the
    chunk, then the wrapper asks the allocator for twice the card's memory
    while the chunk's tensors are alive. Retries, then degradation to
    ``fast`` (seeded espcn) at tile 256 / overlap 16 on the ladder for x0.7
    of the scale; the TIFF still 12245x6887, and no memory left behind."""
    from srs_tpu_torch.models.sr_module import scale_ladder

    total = torch.cuda.get_device_properties(0).total_memory
    ooms = {"n": 0}

    def install(pipe):
        real = real_upscale(pipe)

        def oom(tiles, scale, provider="quality", **kw):
            out = real(tiles, scale, provider=provider, **kw)
            if provider not in ("fast", "bicubic"):
                ooms["n"] += 1
                torch.empty(2 * total, dtype=torch.uint8, device="cuda")
            return out

        pipe.sr_module.upscale_tiles = oom

    w, h = MAIN_OUT
    want = scale_ladder(max(1.5, 0.7 * max(w / MAIN_W, h / MAIN_H)), trained={2, 3, 4})
    nums, pipe, _res, path = drive_path(
        torch, K, tmp, "jobs_degrade", image, weights={**xl_weights(), **fast_weights()},
        before_run=install, ladder=want, **QUALITY_FLAGS)
    os.remove(path)
    info, stats = pipe.last_run_info, pipe.scheduler.get_statistics()
    devices = [a for a in pipe.scheduler._agents.values() if a.device is not None]
    errors = {t.error_message.split(":")[0] for t in pipe.scheduler._tasks.values()}
    if info["provider"] != "fast" or info["sr_attempts"] <= 1 or info["sr_degradations"] < 1 \
            or info["block"] != 256:
        fail(f"jobs_degrade: served {info['provider']} at block {info['block']} after "
             f"{info['sr_attempts']} attempts, {info['sr_degradations']} degradations")
    if stats["counters"]["retried"] < 1 or stats["counters"]["degraded"] < 1 \
            or len(devices) != 1 or not stats["agents"]["mesh_backed"] \
            or "OutOfMemoryError" not in errors:
        fail(f"jobs_degrade: scheduler {stats}, device agents {len(devices)}, errors {errors}")
    before, after = nums["memory_allocated_before_after"]
    if after - before > LEAK_TOL_BYTES:
        fail(f"jobs_degrade: {after - before} bytes still allocated after the job")
    nums.update(ooms_raised=ooms["n"], provider=info["provider"], models=info["models"],
                sr_attempts=info["sr_attempts"], sr_degradations=info["sr_degradations"],
                layout={"block": info["block"], "overlap": info["overlap"],
                        "num_tiles": info["num_tiles"]},
                scheduler_counters=stats["counters"], device_agents=len(devices),
                task_errors=sorted(errors), leak_bytes=after - before,
                leak_tolerance_bytes=LEAK_TOL_BYTES)
    return nums, pipe


def jobs_transient(torch, K, tmp: str, image: np.ndarray, main_tiff: str) -> dict:
    """Two failures, then the real net: served by ``quality`` after three
    attempts with no degradation, the TIFF within 1 LSB of main_path's."""

    def install(pipe):
        real, calls = real_upscale(pipe), {"n": 0}

        def transient(tiles, scale, **kw):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("transient failure")
            return real(tiles, scale, **kw)

        pipe.sr_module.upscale_tiles = transient

    nums, pipe, _res, path = drive_path(torch, K, tmp, "jobs_transient", image,
                                        before_run=install, **QUALITY_FLAGS)
    info, stats = pipe.last_run_info, pipe.scheduler.get_statistics()
    lsb = max_lsb(path, main_tiff)
    os.remove(path)
    if info["provider"] != "quality" or info["sr_attempts"] != 3 \
            or info["sr_degradations"] != 0 or stats["counters"]["degraded"] != 0 or lsb > 1:
        fail(f"jobs_transient: served {info['provider']} after {info['sr_attempts']} "
             f"attempts, {info['sr_degradations']} degradations, {stats['counters']}, "
             f"{lsb} LSB from main_path")
    nums.update(sr_attempts=info["sr_attempts"], sr_degradations=info["sr_degradations"],
                scheduler_counters=stats["counters"], max_lsb_vs_main_path=lsb)
    return nums


def jobs_cancel(torch, K, tmp: str, image: np.ndarray, pipe, main_tiff: str) -> dict:
    """``cancel()`` from the SR stage on the warm quality-path pipeline: a
    failed result naming the cancel, no kernel launched (it stops before
    blending), memory back where it was; then the next ``process()`` on
    the same pipeline succeeds (the stale cancel is cleared), every launch
    held against the plain version, the TIFF within 1 LSB of main_path's."""
    path = os.path.join(tmp, "out_jobs_cancel.tiff")
    orig = pipe._upscale_batch

    def cancel_during_sr(*args, **kwargs):
        pipe.cancel()
        return orig(*args, **kwargs)

    pipe._upscale_batch = cancel_during_sr
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.time()
    try:
        res = pipe.process(image, path)
    finally:
        del pipe._upscale_batch
    elapsed = time.time() - t0
    launches = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if res.success or "cancelled" not in (res.error_message or "") or os.path.exists(path) \
            or any(launches.values()) or after - before > LEAK_TOL_BYTES:
        fail(f"jobs_cancel: success {res.success}, message {res.error_message!r}, "
             f"launches {launches}, {after - before} bytes left allocated")
    K.reset_launches()
    with held_against_plain(K) as records:
        nxt = pipe.process(image, path)
    if not nxt.success:
        fail(f"jobs_cancel: the next process() failed: {nxt.error_message}")
    held = check_held(K, "jobs_cancel", records)
    lsb = max_lsb(path, main_tiff)
    os.remove(path)
    if lsb > 1:
        fail(f"jobs_cancel: the next run is {lsb} LSB from main_path")
    return {"error_message": res.error_message, "cancelled_s": elapsed,
            "cancelled_stage_times": res.stage_times, "cancelled_launches": launches,
            "leak_bytes": after - before, "next_run_stage_times": nxt.stage_times,
            "next_run_max_lsb_vs_main_path": lsb, "launches": dict(K.LAUNCHES),
            "held_against_plain": held}


def jobs_resume(torch, K, tmp: str, image: np.ndarray, main_tiff: str) -> dict:
    """SR resume from a tile store in the temporary directory, with
    ``enable_checkpoint`` on: run 1 dies in blending after the SR stage
    wrote the store; run 2 (a fresh pipeline, once held against the plain
    versions, once timed) makes no upscale_tiles call; after one tile's npz
    is deleted, run 3 upscales exactly that tile. Each TIFF within 2 LSB of
    main_path's (a fresh run of the same job)."""
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
    from srs_tpu_torch.tiling.cache import TileStore

    store_dir = os.path.join(tmp, "tile_store")
    path = os.path.join(tmp, "out_jobs_resume.tiff")
    cfg = dict(**QUALITY_PATH, **QUALITY_FLAGS, enable_checkpoint=True)
    weights = xl_weights()

    def fresh():
        pipe = SuperResolutionPipeline(PipelineConfig(**cfg), weights)
        pipe.tiling_module.store = TileStore(store_dir)
        real, batches = real_upscale(pipe), []

        def counted(tiles, scale, **kw):
            batches.append(int(tiles.shape[0]))
            return real(tiles, scale, **kw)

        pipe.sr_module.upscale_tiles = counted
        return pipe, batches

    def killed(*_args, **_kwargs):
        raise RuntimeError("killed in blending")

    pipe, batches = fresh()
    pipe._blend = killed
    run1 = pipe.process(image, path)
    ck1 = pipe.last_run_info.get("checkpoint") or {}
    if run1.success or "killed" not in run1.error_message or not batches \
            or "write_s" not in ck1:
        fail(f"jobs_resume: run 1 {run1.success} {run1.error_message!r}, upscale calls "
             f"{batches}, checkpoint {ck1}")
    stats = TileStore(store_dir).stats()
    n_tiles = pipe.last_run_info["num_tiles"]
    out = {"run1": {"stage_times": run1.stage_times, "upscale_batches": batches,
                    "write_s": ck1["write_s"], "store_files": stats["l2_files"],
                    "store_bytes": stats["l2_bytes"],
                    "uint8_bytes": n_tiles * (512 * 9) ** 2 * 3}}

    pipe, batches = fresh()
    K.reset_launches()
    with held_against_plain(K) as records:
        run2 = pipe.process(image, path)
    if not run2.success or batches or not pipe.last_run_info["resumed"]:
        fail(f"jobs_resume: run 2 {run2.error_message}, upscale calls {batches}")
    held = check_held(K, "jobs_resume", records)
    lsb2 = max_lsb(path, main_tiff)

    pipe, batches = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    run2b = pipe.process(image, path)
    elapsed = time.time() - t0
    launches = dict(K.LAUNCHES)
    if not run2b.success or batches or not all(launches.values()):
        fail(f"jobs_resume: timed run 2 {run2b.error_message}, upscale calls {batches}, "
             f"launches {launches}")
    ck2 = pipe.last_run_info["checkpoint"]
    w, h = MAIN_OUT
    out["run2"] = {"stage_times": run2b.stage_times, "elapsed_s": elapsed,
                   "mp_per_s": w * h / 1e6 / elapsed, "read_s": ck2["read_s"],
                   "tiles_read": ck2["tiles_read"],
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "max_lsb_vs_main_path": lsb2, "launches": launches}

    os.remove(os.path.join(store_dir, ck1["written_key"], "sr_0.npz"))
    pipe, batches = fresh()
    K.reset_launches()
    with held_against_plain(K) as records:
        run3 = pipe.process(image, path)
    ck3 = pipe.last_run_info.get("checkpoint") or {}
    if not run3.success or batches != [1, 1] or ck3.get("tiles_upscaled") != 1:
        fail(f"jobs_resume: run 3 {run3.error_message}, upscale batches {batches} (want "
             f"one tile per ladder step), checkpoint {ck3}")
    check_held(K, "jobs_resume_partial", records)
    lsb3 = max_lsb(path, main_tiff)
    os.remove(path)
    if max(lsb2, lsb3) > RESUME_LSB:
        fail(f"jobs_resume: resumed TIFFs {lsb2} and {lsb3} LSB from main_path "
             f"> {RESUME_LSB}")
    out["run3"] = {"stage_times": run3.stage_times, "upscale_batches": batches,
                   "read_s": ck3["read_s"], "write_s": ck3["write_s"],
                   "max_lsb_vs_main_path": lsb3}
    out.update(launches=launches, held_against_plain=held, tolerance_lsb=RESUME_LSB)
    return out


def jobs_batch(torch, K, tmp: str, image: np.ndarray, main_tiff: str) -> dict:
    """``process_batch`` of three quality-path jobs, two workers; the job
    listed last is ENTERPRISE and must start first. A warm-up batch with
    every launch held against the plain version, then a timed batch, then
    three back-to-back ``process()`` calls on the same pipeline; each TIFF
    within 1 LSB of main_path's."""
    import threading

    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
    from srs_tpu_torch.scheduler import VIPLevel

    pipe = SuperResolutionPipeline(PipelineConfig(**QUALITY_PATH, **QUALITY_FLAGS),
                                   xl_weights())
    jobs = [{"input": image, "output": os.path.join(tmp, f"out_batch_{i}.tiff")}
            for i in range(3)]
    jobs[-1]["vip_level"] = VIPLevel.ENTERPRISE
    events, lock = [], threading.Lock()
    process = pipe.process

    def traced(inp, outp, **kw):
        with lock:
            events.append(("start", outp, time.time()))
        res = process(inp, outp, **kw)
        with lock:
            events.append(("end", outp, time.time()))
        return res

    pipe.process = traced
    K.reset_launches()
    with held_against_plain(K) as records:
        warm = pipe.process_batch(jobs, max_concurrent=2)
    if not all(r.success for r in warm):
        fail(f"jobs_batch: warm-up batch failed: {[r.error_message for r in warm]}")
    held = check_held(K, "jobs_batch", records)

    events.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    results = pipe.process_batch(jobs, max_concurrent=2)
    wall = time.time() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(r.success for r in results) or pipe._stage_sem is not None:
        fail(f"jobs_batch: {[r.error_message for r in results]}")
    starts = sorted((t, outp) for kind, outp, t in events if kind == "start")
    if starts[0][1] != jobs[-1]["output"]:
        fail(f"jobs_batch: the ENTERPRISE job did not start first: {starts}")
    per_job = {os.path.basename(outp): [round(t - t0, 4) for kind, o, t in events if o == outp]
               for outp in (j["output"] for j in jobs)}
    lsb = [max_lsb(j["output"], main_tiff) for j in jobs]
    if max(lsb) > 1:
        fail(f"jobs_batch: batch TIFFs {lsb} LSB from main_path")

    seq_path = os.path.join(tmp, "out_batch_seq.tiff")
    t0 = time.time()
    for job in jobs:
        res = process(job["input"], seq_path)
        if not res.success:
            fail(f"jobs_batch: back-to-back process() failed: {res.error_message}")
    seq = time.time() - t0
    for path in [j["output"] for j in jobs] + [seq_path]:
        os.remove(path)
    return {"wall_s": wall, "back_to_back_s": seq, "images_per_hour": 3 * 3600 / wall,
            "back_to_back_images_per_hour": 3 * 3600 / seq, "speedup": seq / wall,
            "jobs_start_end_s": per_job, "stage_times": [r.stage_times for r in results],
            "peak_mem_gb": peak / 1e9, "max_lsb_vs_main_path": lsb, "launches": launches,
            "held_against_plain": held}


def job_layer(torch, K, tmp: str, image: np.ndarray, main_pipe, main_tiff: str) -> dict:
    """The job layer at full width (module docstring, phase 13)."""
    out, times = {}, {}
    t0 = time.time()
    out["degrade"], _ = jobs_degrade(torch, K, tmp, image)
    times["degrade"] = time.time() - t0
    t0 = time.time()
    out["transient"] = jobs_transient(torch, K, tmp, image, main_tiff)
    times["transient"] = time.time() - t0
    t0 = time.time()
    out["cancel"] = jobs_cancel(torch, K, tmp, image, main_pipe, main_tiff)
    times["cancel"] = time.time() - t0
    t0 = time.time()
    out["resume"] = jobs_resume(torch, K, tmp, image, main_tiff)
    times["resume"] = time.time() - t0
    t0 = time.time()
    out["batch"] = jobs_batch(torch, K, tmp, image, main_tiff)
    times["batch"] = time.time() - t0
    out["case_seconds"] = times
    return out


# -- the training slice ------------------------------------------------------------------------

# Published bf16 dense peak of one H100 SXM (NVIDIA data sheet), the rate a
# training step's convolutions run at.
BF16_FLOPS = 989e12
# The reference's zssr defaults (pipeline.py:121, sr_module.py:612-620).
ZSSR_STEPS, ZSSR_PATCH, ZSSR_BATCH = 150, 48, 8
# The trainer's run: edsr_xl x3 at the reference's batch and patch.
TRAIN = dict(steps=200, corpus_n=96, corpus_size=256, patch=48, batch=32)
# Card against CPU in float32 (TF32 off): per-step losses of the same
# optimizer steps on the same patches. Adam's first steps move each weight
# by about lr whatever its gradient's size, so a gradient component near
# zero whose sign differs between two summation orders moves that weight
# by 2 lr; over five steps the losses agree to this relative tolerance.
TRAIN_LOSS_RTOL = 1e-3
# The bf16 zssr net's output, card against CPU (tests/test_torch_train.py
# holds the port against the reference to the same floor).
ZSSR_BF16_PSNR_FLOOR = 40.0


def conv_flops(torch, net, h: int, w: int) -> int:
    """FLOP (two per multiply-add) of the convolutions of one forward pass
    of ``net`` on one (h, w) input, from the shapes its convolutions see."""
    total = []

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        total.append(2 * out.numel() * mod.in_channels // mod.groups * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(torch.zeros(1, h, w, 3, device=next(net.parameters()).device))
    for hk in hooks:
        hk.remove()
    return int(sum(total))


def zssr_path(torch, K, tmp: str, image: np.ndarray, main_tiff: str) -> tuple:
    """``process(provider="zssr")`` at full width: seeded edsr_xl handed in
    as trained (so the base is the quality net at lr 1e-4), tuned on the
    input for the reference's 150 steps at batch 8, patch 48, then served
    on both x3 steps and blended with K1/K2. The tuned net must differ from
    the seeded one, the seeded weights must be unchanged, and the TIFF must
    differ from the main path's."""
    from srs_tpu_torch.io.native import read_tiff

    weights = xl_weights()
    seeded = {k: v.clone() for k, v in weights[("edsr_xl", 3)].items()}
    nums, pipe, res, path = drive_path(torch, K, tmp, "zssr", image, weights=weights,
                                       provider="zssr", zssr_steps=ZSSR_STEPS, **QUALITY_FLAGS)
    info, sr = pipe.last_run_info, pipe.sr_module
    z = info["zssr"]
    if info["provider"] != "zssr" or z is None or z["base"] != "edsr_xl" or z["lr"] != 1e-4 \
            or not z["base_trained"] or z["steps"] != ZSSR_STEPS:
        fail(f"zssr: served {info['provider']} with {z}")
    if info["step_members"] != [[["edsr_xl", 1]], [["edsr_xl", 1]]]:
        fail(f"zssr: step members {info['step_members']}")
    if any(not torch.equal(weights[("edsr_xl", 3)][k], v) for k, v in seeded.items()):
        fail("zssr: the seeded weights handed in changed")
    tuned = sr.zssr_nets[3].state_dict()
    moved = {k: float((tuned[k].float().cpu() - v.to(tuned[k].dtype).float()).abs().max())
             for k, v in seeded.items()}
    if max(moved.values()) == 0.0:
        fail("zssr: the tuned weights equal the seeded ones")
    diff = np.abs(read_tiff(path).astype(np.int16) - read_tiff(main_tiff))
    if diff.max() == 0:
        fail("zssr: the TIFF equals the main path's")
    os.remove(path)
    flops = 3 * ZSSR_BATCH * conv_flops(torch, sr.zssr_nets[3], ZSSR_PATCH, ZSSR_PATCH)
    tune_s = z["seconds"]
    nums.update(
        provider=info["provider"], zssr=z, step_members=info["step_members"],
        tune_s=tune_s, steps_per_s=ZSSR_STEPS / tune_s,
        step_tflop=flops / 1e12, tflop_per_s=flops * ZSSR_STEPS / tune_s / 1e12,
        bf16_peak_tflop_per_s=BF16_FLOPS / 1e12,
        pct_of_bf16_peak=100.0 * flops * ZSSR_STEPS / tune_s / BF16_FLOPS,
        sr_stage_without_tune_s=res.stage_times["super_resolution"] - tune_s,
        max_weight_change=max(moved.values()),
        vs_main_path={"mean_abs_lsb": float(diff.mean()), "max_lsb": int(diff.max())},
    )
    return nums, pipe


def train_phase(torch, tmp: str) -> dict:
    """``train_synthetic`` on edsr_xl x3 (module docstring, phase 15), a
    ``process()`` that loads what it saved as trained (no IBP), and one
    ``python3 -m srs_tpu_torch train --synthetic`` subprocess."""
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.models.corpus import make_corpus
    from srs_tpu_torch.models.registry import build_model, load_checkpoint
    from srs_tpu_torch.models.train import train_synthetic
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    ckpt = os.path.join(tmp, "models")
    t0 = time.time()
    corpus = make_corpus(TRAIN["corpus_n"], TRAIN["corpus_size"], seed=0)
    corpus_s = time.time() - t0
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, loss = train_synthetic("edsr_xl", 3, steps=TRAIN["steps"], patch=TRAIN["patch"],
                                  batch=TRAIN["batch"], corpus=corpus, checkpoint_dir=ckpt,
                                  device="cuda", on_step=lambda i, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = torch.stack(losses).cpu().numpy()
    first, last = float(per_step[:50].mean()), float(per_step[-50:].mean())
    if len(per_step) != TRAIN["steps"] or not np.isfinite(per_step).all() or not last < first:
        fail(f"train: {len(per_step)} steps, first chunk {first}, last chunk {last}")
    if abs(loss - last) > 1e-5 * max(1.0, abs(last)):
        fail(f"train: returned loss {loss} is not the last chunk's mean {last}")
    saved = load_checkpoint("edsr_xl", 3, ckpt)
    if saved is None or any(not torch.equal(saved[k], v) for k, v in state.items()):
        fail("train: the saved checkpoint does not reload as the trained state")
    net, _ = build_model("edsr_xl", 3, state, device="cuda")
    flops = 3 * TRAIN["batch"] * conv_flops(torch, net, TRAIN["patch"], TRAIN["patch"])
    del net

    # process() with the same checkpoint_dir counts the net as trained: no IBP
    image = synthetic_image(96, 112, seed=8)
    cfg = dict(block_size=64, target_resolution="1008x864", ibp_steps=4, device="cuda",
               **QUALITY_FLAGS)
    with ibp_calls() as ibp:
        pipe = SuperResolutionPipeline(PipelineConfig(checkpoint_dir=ckpt, **cfg))
        res = pipe.process(image, os.path.join(tmp, "trained.tiff"))
    if not res.success:
        fail(f"train: process() with the trained net failed: {res.error_message}")
    info = pipe.last_run_info
    if ibp or info["step_members"] != [[["edsr_xl", 1]], [["edsr_xl", 1]]] \
            or not pipe.sr_module.is_trained("edsr_xl", 3):
        fail(f"train: process() served {info['step_members']} with {len(ibp)} IBP calls")
    handed = SuperResolutionPipeline(PipelineConfig(**cfg), {("edsr_xl", 3): state})
    res2 = handed.process(image, os.path.join(tmp, "handed.tiff"))
    lsb = int(np.abs(read_tiff(res.output_path).astype(np.int16)
                     - read_tiff(res2.output_path)).max())
    if not res2.success or lsb:
        fail(f"train: loaded and handed-in weights differ by {lsb} LSB")

    # the command line, once, in its own process
    cli_dir = os.path.join(tmp, "cli_models")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch", "train", "--synthetic",
                           "--steps", "2", "--corpus-n", "2", "--patch", "24", "--batch", "8",
                           "--checkpoint-dir", cli_dir],
                          capture_output=True, text=True, timeout=300)
    cli_s = time.time() - t0
    if proc.returncode != 0 or not os.path.isfile(os.path.join(cli_dir, "espcn_x2.pt")):
        fail(f"train: python -m srs_tpu_torch train exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return {
        "config": {"model": "edsr_xl", "scale": 3, **TRAIN},
        "corpus_s": corpus_s, "train_s": train_s, "steps_per_s": TRAIN["steps"] / train_s,
        "step_tflop": flops / 1e12, "tflop_per_s": flops * TRAIN["steps"] / train_s / 1e12,
        "bf16_peak_tflop_per_s": BF16_FLOPS / 1e12,
        "pct_of_bf16_peak": 100.0 * flops * TRAIN["steps"] / train_s / BF16_FLOPS,
        "first_chunk_loss": first, "last_chunk_loss": last, "peak_mem_gb": peak,
        "process_trained": {"step_members": info["step_members"], "ibp_calls": len(ibp),
                            "stage_times": res.stage_times, "vs_handed_in_lsb": lsb},
        "cli": {"seconds": cli_s, "stdout": proc.stdout.strip().splitlines()[-1:]},
    }


def train_reference(torch) -> dict:
    """The trainer card against CPU on small inputs, float32 with TF32 off:
    five ``zssr_finetune`` steps of a seeded espcn x2 and five
    ``train_step`` steps of a seeded edsr_m x2 on the same batches, per-step
    losses within ``TRAIN_LOSS_RTOL``; and zssr in bfloat16, the tuned
    nets' outputs on the same input above ``ZSSR_BF16_PSNR_FLOOR``."""
    from srs_tpu_torch.models.registry import build_model, seeded_params
    from srs_tpu_torch.models.train import init_train_state, train_step, zssr_finetune

    torch.backends.cudnn.allow_tf32 = False
    image = synthetic_image(40, 48, seed=9)
    probe = torch.from_numpy(synthetic_image(16, 16, seed=10)[None])
    out = {}
    for dtype in ("float32", "bfloat16"):
        losses, outputs = {}, {}
        for device in ("cuda", "cpu"):
            net, _ = build_model("espcn", 2, seeded_params("espcn", 2, seed=3), dtype=dtype,
                                 device=device, master_weights=True)
            rec = []
            tuned = zssr_finetune(net, image, scale=2, steps=5, patch=12, batch=8, lr=1e-3,
                                  on_step=lambda i, m, rec=rec: rec.append(float(m["loss"])))
            losses[device] = rec
            with torch.no_grad():
                outputs[device] = tuned(probe.to(device)).cpu().numpy().astype(np.float64)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        mse = float(np.mean((outputs["cuda"] - outputs["cpu"]) ** 2))
        psnr = float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
        out[f"zssr_{dtype}"] = {"losses": losses, "max_rel_loss_diff": rel, "psnr_db": psnr}
        if dtype == "float32" and rel > TRAIN_LOSS_RTOL:
            fail(f"train_reference: zssr losses card {losses['cuda']} CPU {losses['cpu']}")
        if dtype == "bfloat16" and psnr < ZSSR_BF16_PSNR_FLOOR:
            fail(f"train_reference: bf16 zssr output {psnr:.2f} dB < {ZSSR_BF16_PSNR_FLOOR}")

    rng = np.random.default_rng(11)
    batches = []
    for _ in range(5):
        hr = rng.uniform(0, 255, (4, 48, 48, 3)).astype(np.float32)
        batches.append((hr.reshape(4, 24, 2, 24, 2, 3).mean(axis=(2, 4)), hr))
    losses = {}
    for device in ("cuda", "cpu"):
        net, _ = build_model("edsr_m", 2, seeded_params("edsr_m", 2, seed=4), dtype="float32",
                             device=device, master_weights=True)
        net, opt = init_train_state(net, 1e-3)
        rec = []
        for lr_b, hr_b in batches:
            m = train_step(net, opt, torch.from_numpy(lr_b).to(device),
                           torch.from_numpy(hr_b).to(device))
            rec.append((float(m["loss"]), float(m["grad_norm"])))
        losses[device] = rec
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(losses["cuda"], losses["cpu"]))
    out["train_step_float32"] = {"loss_grad_norm": losses, "max_rel_loss_diff": rel}
    if rel > TRAIN_LOSS_RTOL:
        fail(f"train_reference: train_step losses card {losses['cuda']} CPU {losses['cpu']}")
    torch.backends.cudnn.allow_tf32 = True
    out["tolerance"] = {"loss_rtol": TRAIN_LOSS_RTOL, "bf16_psnr_floor": ZSSR_BF16_PSNR_FLOOR}
    return out


# -- the library API (phases 17 and 18) ----------------------------------------

# Regions of interest of the library phase's process() in input (720x1280)
# coordinates: one of each kind, the brand with its reference colour.
LIBRARY_ROIS = [
    {"type": "text", "bbox": [80, 60, 360, 90]},
    {"type": "product", "bbox": [520, 180, 320, 320]},
    {"type": "face", "bbox": [940, 120, 200, 240]},
    {"type": "brand", "bbox": [60, 420, 240, 200], "reference_color": [200, 30, 30]},
]
LIBRARY_ROI_KEYS = ("text_sharpness_0", "text_contrast_0", "product_texture_1",
                    "face_naturalness_2", "skin_tone_naturalness_2", "brand_color_delta_e_3",
                    "brand_color_accuracy_3")
COMMERCIAL_KEYS = ("global_sharpness", "high_frequency_ratio", "color_variance",
                   "oversharpen_score", "artifact_score", "noise_level",
                   "brightness_uniformity", "commercial_score")
LIBRARY_FUSIONS = ("laplacian_fusion", "multi_band_fusion", "weighted_average_fusion",
                   "feather_blend", "gradient_domain_fusion")
# The input cut by TilingModule at the bench configuration's block (6
# tiles of 512), upscaled x9 by seeded edsr_xl on the [3, 3] ladder, and
# blended into the 720x1280 input's x9.
LIBRARY_BLOCK, LIBRARY_TILES, LIBRARY_MODEL, LIBRARY_SCALE = 512, 6, "edsr_xl", 9
LIBRARY_CANVAS = (MAIN_H * LIBRARY_SCALE, MAIN_W * LIBRARY_SCALE)
CLONE_MASK = 2048  # side of the multigrid clone's square mask
# Commercial metrics card against CPU, and batch against single call
# (tests/test_torch_commercial.py): relative 1e-4, absolute 1e-6.
COMMERCIAL_RTOL, COMMERCIAL_ATOL = 1e-4, 1e-6
# The same four kinds at the card-against-CPU phase's small sizes.
LIBRARY_ROIS_SMALL = [
    {"type": "text", "bbox": [4, 6, 30, 20]},
    {"type": "product", "bbox": [30, 10, 36, 40]},
    {"type": "face", "bbox": [10, 30, 40, 30]},
    {"type": "brand", "bbox": [40, 30, 40, 30], "reference_color": [200, 30, 30]},
]
EXAMPLE_SECTIONS = ("prompts", "sr_module", "tiling_and_blending", "quality_assessment",
                    "scheduler", "pipeline")
# K1's tolerance against its plain version: a coarse-mask sample nearer
# than this to the multigrid's 0.999 cut could fall either side.
MASK_CUT, MASK_CUT_TOL = 0.999, 6.1e-5


def commercial_of(report: dict) -> dict:
    """The commercial keys of a QA report (global and per ROI)."""
    roi = ("text_", "product_", "face_", "skin_", "brand_")
    return {k: v for k, v in report.items() if k in COMMERCIAL_KEYS or k.startswith(roi)}


def commercial_mismatch(got: dict, want: dict) -> list:
    """Keys whose values differ beyond the commercial tolerance (levels
    must be equal), or that only one side has."""
    bad = sorted(set(got) ^ set(want))
    for k, v in want.items():
        if k not in got:
            continue
        if isinstance(v, str):
            if got[k] != v:
                bad.append(k)
        elif not abs(got[k] - v) <= max(COMMERCIAL_ATOL, COMMERCIAL_RTOL * abs(v)):
            bad.append(k)
    return bad


def merge_held(*helds) -> dict:
    """One :func:`check_held` record of several runs."""
    out = {}
    for held in helds:
        for kname, h in held.items():
            m = out.setdefault(kname, {"calls": 0, "max_abs_err": 0.0, "shapes": []})
            m["calls"] += h["calls"]
            m["max_abs_err"] = max(m["max_abs_err"], h["max_abs_err"])
            m["shapes"] += h.get("shapes", [])
    return out


def held_then_timed(torch, K, name: str, fn, require_launch: bool = True):
    """``fn()`` once with every K1/K2 launch held against its plain
    version, then once timed (host clock to a synchronise) with the launch
    counts set to 0 just before and read just after, and its peak memory.
    Returns (result of the timed run, seconds, launches, held, peak GB)."""
    K.reset_launches()
    with held_against_plain(K) as records:
        fn()
    torch.cuda.synchronize()
    held = check_held(K, name, records, require_launch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(K.LAUNCHES)
    return out, seconds, launches, held, torch.cuda.max_memory_allocated() / 1e9


def library_roi(torch, K, tmp: str, image: np.ndarray, bench_pipe, bench_nums) -> dict:
    """``process(roi_regions=...)`` on the bench path's pipeline and
    flags, and a two-job ``process_batch`` in which one job carries the
    regions."""
    path = os.path.join(tmp, "out_library_roi.tiff")
    res, seconds, launches, held, peak = held_then_timed(
        torch, K, "library_roi", lambda: bench_pipe.process(image, path, roi_regions=LIBRARY_ROIS))
    if not res.success:
        fail(f"library: process(roi_regions) failed: {res.error_message}")
    report = res.quality_report or {}
    commercial = commercial_of(report)
    missing = [k for k in LIBRARY_ROI_KEYS + COMMERCIAL_KEYS if k not in commercial]
    numbers = [v for v in commercial.values() if not isinstance(v, str)]
    if missing or not all(np.isfinite(numbers)):
        fail(f"library: commercial keys missing or not finite: {missing} {commercial}")

    jobs = [{"input": image, "output": os.path.join(tmp, "library_batch_0.tiff")},
            {"input": image, "output": os.path.join(tmp, "library_batch_1.tiff"),
             "roi_regions": LIBRARY_ROIS}]
    K.reset_launches()
    t0 = time.time()
    batch = bench_pipe.process_batch(jobs, max_concurrent=2)
    batch_s = time.time() - t0
    batch_launches = dict(K.LAUNCHES)
    if not all(r.success for r in batch):
        fail(f"library: process_batch with ROIs failed: {[r.error_message for r in batch]}")
    in_plain_job = commercial_of(batch[0].quality_report)
    bad = commercial_mismatch(commercial_of(batch[1].quality_report), commercial)
    if in_plain_job or bad:
        fail(f"library: batch commercial keys: job without ROIs {sorted(in_plain_job)}, "
             f"the ROI job against process() {bad}")
    qa_s = res.stage_times["quality_assessment"]
    return {
        "rois": LIBRARY_ROIS, "commercial": commercial,
        "commercial_score": commercial["commercial_score"],
        "stage_times": res.stage_times, "elapsed_s": seconds, "peak_mem_gb": peak,
        "qa_s": qa_s, "bench_qa_s": bench_nums["stage_times"]["quality_assessment"],
        "qa_s_added": qa_s - bench_nums["stage_times"]["quality_assessment"],
        "launches": launches, "held_against_plain": held,
        "batch": {"jobs": 2, "max_concurrent": 2, "seconds": batch_s,
                  "launches": batch_launches,
                  "roi_job_stage_times": batch[1].stage_times},
    }


def library_blend(torch, K, tmp: str, image: np.ndarray) -> dict:
    """TilingModule's split and merge at block 512; the 6 tiles upscaled
    x9 by the SR module; every BlendingModule fusion into the 6480x11520
    output; seams and blend quality on the Laplacian result; the multigrid
    clone at full canvas size against the Jacobi one."""
    from srs_tpu_torch.blending import (BlendingModule, TileInfo, _layout_from_tiles,
                                        compute_blend_quality)
    from srs_tpu_torch.config import ModelConfig
    from srs_tpu_torch.models.sr_module import SuperResolutionModule
    from srs_tpu_torch.ops import blend as B
    from srs_tpu_torch.ops.weights import layout_weights
    from srs_tpu_torch.tiling.tiling import TilingModule

    out: dict = {}
    tm = TilingModule(block_size=LIBRARY_BLOCK, overlap_ratio=0.2,
                      cache_dir=os.path.join(tmp, "lib_tiles"), device="cuda")
    t0 = time.time()
    tiles = tm.split_image(image)
    out["split_s"] = time.time() - t0
    b = LIBRARY_BLOCK
    if len(tiles) != LIBRARY_TILES or tiles[0].data.shape != (b, b, 3):
        fail(f"library: split_image gave {len(tiles)} tiles of {tiles[0].data.shape}")
    t0 = time.time()
    merged = tm.merge_tiles(tiles, output_size=(MAIN_H, MAIN_W), scale=1)
    out["merge_s"] = time.time() - t0
    out["merge_max_abs_err"] = float(np.abs(merged - image).max())
    if merged.shape != image.shape or out["merge_max_abs_err"] > 1e-3:
        fail(f"library: merge_tiles {merged.shape}, max err {out['merge_max_abs_err']}")

    sr = SuperResolutionModule(ModelConfig(quality_model=LIBRARY_MODEL, auto_route=False,
                                           per_scale_selection=False), xl_weights(), "cuda")
    batch = torch.from_numpy(np.stack([t.data for t in tiles])).cuda()
    with torch.no_grad():
        sr.upscale_tiles(batch[:1], 3)  # build the nets and cuDNN's plans
        torch.cuda.synchronize()
        t0 = time.time()
        up = sr.upscale_tiles(sr.upscale_tiles(batch, 3), 3)
        torch.cuda.synchronize()
    out["upscale_s"] = time.time() - t0
    del batch
    if tuple(up.shape) != (LIBRARY_TILES, b * LIBRARY_SCALE, b * LIBRARY_SCALE, 3):
        fail(f"library: upscaled tiles {tuple(up.shape)}")
    infos = [TileInfo(up[i], t.metadata.global_x * LIBRARY_SCALE,
                      t.metadata.global_y * LIBRARY_SCALE, t.metadata.row, t.metadata.col)
             for i, t in enumerate(tiles)]
    bm = BlendingModule(device="cuda")
    t0 = time.time()
    layout_weights(_layout_from_tiles(infos, torch.device("cuda"))[0], kind="distance",
                   weight_type="cosine")
    out["dense_weights_s"] = time.time() - t0

    helds, launches, fusions, results = [], {"pyr_down": 0, "pyr_up": 0}, {}, {}
    mean_in = image.mean(axis=(0, 1))
    for name in LIBRARY_FUSIONS:
        res, seconds, n, held, peak = held_then_timed(
            torch, K, f"library_{name}",
            lambda name=name: getattr(bm, name)(infos, output_shape=LIBRARY_CANVAS),
            require_launch=name in ("laplacian_fusion", "multi_band_fusion"))
        # float64 sums: a float32 running sum of 75 M samples stalls at 2^32
        mean_out = res.mean(axis=(0, 1), dtype=np.float64)
        if res.shape != (*LIBRARY_CANVAS, 3) or not np.isfinite(res).all() \
                or np.abs(mean_out - mean_in).max() > 10.0:
            fail(f"library: {name} gave {res.shape}, means {mean_out} against the "
                 f"input's {mean_in}")
        fusions[name] = {"seconds": seconds, "peak_mem_gb": peak, "launches": n,
                         "launches_by_shape": launches_by_shape(held)}
        helds.append(held)
        for k in launches:
            launches[k] += n[k]
        if name == "laplacian_fusion":
            results[name] = res
        del res
    out["fusions"] = fusions

    lap = results["laplacian_fusion"]
    t0 = time.time()
    seams = bm.detect_seams(lap, infos)
    out["detect_seams_s"] = time.time() - t0
    t0 = time.time()
    repaired = bm.repair_seams(lap, seams, infos)
    out["repair_seams_s"] = time.time() - t0
    sev = [s.severity for s in seams]
    out["seams"] = {"count": len(seams), "high": sev.count("high"),
                    "medium": sev.count("medium"), "low": sev.count("low"),
                    "repaired_max_change": float(np.abs(repaired - lap).max())}
    del repaired
    t0 = time.time()
    out["blend_quality"] = compute_blend_quality(
        lap, [i.image for i in infos], [(i.y, i.x) for i in infos], device="cuda")
    out["blend_quality_s"] = time.time() - t0
    if not 0.0 < out["blend_quality"]["mean_ssim"] <= 1.0:
        fail(f"library: compute_blend_quality {out['blend_quality']}")
    del infos, up
    torch.cuda.empty_cache()

    # The clone: the Laplacian result as the base, its mirror image as the
    # overlay, a 2048-px square mask in the middle.
    h, w = LIBRARY_CANVAS
    base = lap
    overlay = np.ascontiguousarray(lap[:, ::-1])
    mask = np.zeros((h, w), np.float32)
    y0, x0 = (h - CLONE_MASK) // 2, (w - CLONE_MASK) // 2
    mask[y0 : y0 + CLONE_MASK, x0 : x0 + CLONE_MASK] = 1.0
    cut = {"near": 0, "coarse_masks": 0}

    def count_near_cut(name, x, o, _dst):
        if name == "pyr_down" and x.shape[-1] == 1:
            cut["coarse_masks"] += 1
            cut["near"] += int(((o - MASK_CUT).abs() < MASK_CUT_TOL).sum())

    dst_t, src_t, mask_t = (torch.from_numpy(a).cuda() for a in (base, overlay, mask))
    with torch.no_grad(), pyramid_calls(K, count_near_cut):
        u_mg = B.seamless_clone_multigrid(dst_t, src_t, mask_t)
    torch.cuda.synchronize()
    res, seconds, n, held, peak = held_then_timed(
        torch, K, "library_poisson",
        lambda: bm.poisson_fusion(base, overlay, mask, solver="multigrid"))
    if res.shape != (h, w, 3) or not np.isfinite(res).all():
        fail(f"library: poisson_fusion gave {res.shape}")
    if cut["near"]:
        fail(f"library: {cut['near']} coarse-mask samples within {MASK_CUT_TOL} of {MASK_CUT}")
    helds.append(held)
    for k in launches:
        launches[k] += n[k]
    _, m, div, u0 = B._clone_problem(dst_t, src_t, mask_t, "normal")

    def residual_of(u):  # max |lap(u) - div| over the mask
        return float(((B._laplace(u) - div).abs() * m).max())

    with torch.no_grad():
        t0 = time.time()
        u_j = B.seamless_clone(dst_t, src_t, mask_t)
        torch.cuda.synchronize()
        jacobi_s = time.time() - t0
    residual = {"multigrid": residual_of(u_mg), "jacobi_400": residual_of(u_j),
                "start": residual_of(u0)}
    if not residual["multigrid"] < residual["start"]:
        fail(f"library: the multigrid clone did not lower the residual: {residual}")
    out["poisson"] = {"canvas": [h, w, 3], "mask": CLONE_MASK, "seconds": seconds,
                      "jacobi_400_seconds": jacobi_s, "peak_mem_gb": peak, "launches": n,
                      "launches_by_shape": launches_by_shape(held),
                      "residual_max_in_mask": residual,
                      "coarse_mask_samples_near_cut": cut["near"],
                      "coarse_mask_launches": cut["coarse_masks"]}
    del dst_t, src_t, mask_t, div, m, u0, u_mg, u_j
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["held_against_plain"] = merge_held(*helds)
    return out


def library_examples() -> dict:
    """``python3 -m srs_tpu_torch.examples`` once in its own process."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch.examples"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    heads = [line[3:] for line in proc.stdout.splitlines() if line.startswith("== ")]
    if proc.returncode != 0 or tuple(heads) != EXAMPLE_SECTIONS:
        fail(f"library: python3 -m srs_tpu_torch.examples exited {proc.returncode}, "
             f"sections {heads}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    return {"seconds": time.time() - t0, "sections": heads,
            "lines": [line for line in lines if line.startswith(
                ("sr:", "tiling:", "merge", "laplacian", "seams", "PSNR", "MS-SSIM",
                 "pipeline:"))]}


def library(torch, K, tmp: str, image: np.ndarray, bench_pipe, bench_nums) -> dict:
    """Phase 17: the library API at full size (ROIs, tiling, every
    fusion, seams, the multigrid clone, the examples)."""
    roi = library_roi(torch, K, tmp, image, bench_pipe, bench_nums)
    blend = library_blend(torch, K, tmp, image)
    launches = {k: roi["launches"][k] + blend["launches"][k] for k in roi["launches"]}
    for kname, n in launches.items():
        if n <= 0:
            fail(f"library never launched kernel {kname}")
    return {"roi": roi, "blend": blend, "examples": library_examples(), "launches": launches,
            "held_against_plain": merge_held(roi["held_against_plain"],
                                             blend["held_against_plain"])}


def library_reference(torch, tmp: str) -> dict:
    """Phase 18: the library API card against CPU at the CPU tests' sizes,
    float32 with TF32 off: each fusion, the clones and the tiling merge
    within 1e-3 (the merge 1e-4), split tiles equal, Canny masks equal,
    commercial metrics (and a bicubic process() with ROIs) within
    relative 1e-4."""
    from srs_tpu_torch.blending import BlendingModule, PoissonMode, TileInfo
    from srs_tpu_torch.ops.colorspace import rgb_to_gray
    from srs_tpu_torch.ops.filters import canny_edges
    from srs_tpu_torch.ops.resize import resize_bicubic_up
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
    from srs_tpu_torch.qa.commercial import evaluate_commercial_arrays
    from srs_tpu_torch.tiling.tiling import TilingModule

    torch.backends.cudnn.allow_tf32 = False
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}
    scene = synthetic_image(112, 160, seed=8)
    step, block = 48, 64
    infos = [TileInfo(scene[r * step : r * step + block, c * step : c * step + block],
                      c * step, r * step, r, c) for r in range(2) for c in range(3)]
    rng = np.random.default_rng(9)
    dst = synthetic_image(96, 96, seed=10) * 0.3 + 20.0
    src = np.repeat((170 + 30 * np.sin(np.arange(96, dtype=np.float32) / 7))[None, :, None],
                    96, 0).repeat(3, 2) + rng.normal(0, 3, (96, 96, 3))
    src = src.astype(np.float32)
    mask = np.zeros((96, 96), np.float32)
    mask[10:84, 8:87] = 1.0
    got: dict = {}
    for device in ("cuda", "cpu"):
        bm = BlendingModule(device=device)
        r = {name: getattr(bm, name)(infos, output_shape=(112, 160)) for name in LIBRARY_FUSIONS}
        for mode in PoissonMode:
            for solver in ("multigrid", "jacobi"):
                r[f"poisson_{mode.value}_{solver}"] = bm.poisson_fusion(dst, src, mask, mode,
                                                                       solver)
        tm = TilingModule(block_size=64, overlap_ratio=0.2, device=device,
                          cache_dir=os.path.join(tmp, f"libref_{device}"))
        split = tm.split_image(scene)
        r["split"] = np.stack([t.data for t in split])
        r["merge"] = tm.merge_tiles(split, output_size=(112, 160), scale=1)
        for t in split:
            t.data = resize_bicubic_up(torch.from_numpy(t.data)[None].to(device), 2)[0].cpu().numpy()
        r["merge_x2"] = tm.merge_tiles(split)
        img = torch.from_numpy(synthetic_image(64, 80, seed=11)).to(device)
        r["canny"] = canny_edges(rgb_to_gray(img)).cpu().numpy()
        r["commercial"] = {k: float(v) for k, v in evaluate_commercial_arrays(
            img, LIBRARY_ROIS_SMALL).items()}
        cfg = PipelineConfig(block_size=64, target_resolution="384x288", provider="bicubic",
                             auto_route=False, per_scale_selection=False, device=device)
        res = SuperResolutionPipeline(cfg).process(
            synthetic_image(96, 128, seed=12), os.path.join(tmp, f"libref_{device}.tiff"),
            roi_regions=LIBRARY_ROIS_SMALL)
        if not res.success:
            fail(f"library_reference: process(roi_regions) on {device}: {res.error_message}")
        r["process_commercial"] = commercial_of(res.quality_report)
        got[device] = r
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    gpu, cpu = got["cuda"], got["cpu"]
    for name in [*LIBRARY_FUSIONS, *(k for k in cpu if k.startswith("poisson_")), "merge"]:
        err = float(np.abs(gpu[name] - cpu[name]).max())
        tol = 1e-4 if name.startswith("merge") else 1e-3
        out[name] = err
        if gpu[name].shape != cpu[name].shape or err > tol:
            fail(f"library_reference: {name}: card against CPU max abs err {err} > {tol}")
    out["merge_x2"] = float(np.abs(gpu["merge_x2"] - cpu["merge_x2"]).max())
    if out["merge_x2"] > 1e-3:
        fail(f"library_reference: merge_x2 {out['merge_x2']}")
    if not np.array_equal(gpu["split"], cpu["split"]):
        fail("library_reference: split_image tiles differ between card and CPU")
    out["canny_pixels_differing"] = int((gpu["canny"] != cpu["canny"]).sum())
    if out["canny_pixels_differing"]:
        fail(f"library_reference: Canny masks differ in {out['canny_pixels_differing']} px")
    for key in ("commercial", "process_commercial"):
        bad = commercial_mismatch(gpu[key], cpu[key])
        if bad or len(cpu[key]) < len(COMMERCIAL_KEYS):
            fail(f"library_reference: {key} card against CPU: {bad}")
        out[key] = {k: [gpu[key][k], cpu[key][k]] for k in cpu[key]}
    return out


# -- the operator subcommands and generation (phases 19-21) ---------------------

# Environment of the bench runs: no row in any log, the work directory in
# the smoke's temporary directory.
BENCH_ENV = {"SRS_BENCH_NO_LOG": "1"}
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "elapsed_s", "output_mp",
              "stage_times", "quality_score", "provider", "quality_model", "batch",
              "d2h_link_MBps", "save_link_MBps", "compute_stages_s", "value_compute_bound",
              "vs_baseline_compute_bound", "sr_tflops", "mfu_pct", "chip_kind",
              "routed_model", "step_models")
# The generator at the packaged model's width (srs_tpu/models/checkpoints/
# ark_meta.json: base 64, depth 2, 128 px), trained at the reference's
# batch on a small corpus: 200 steps in the reference's chunks of 100 (at
# 100 steps another class moved the 2K image by 0.012 LSB on average, too
# near GEN_CLASS_MIN_LSB to hold).
GEN = dict(base=64, depth=2, size=128, batch=64, n_per_class=8, steps=200, scan_chunk=100)
GEN_PROMPT, GEN_OTHER_PROMPT = "product shot of a watch", "a text poster page"
# A generator trained for 200 steps has learned little of its classes (the
# reference's slow test asks its packaged generator, trained by default for
# 30,000 steps, to move the image by over 1 LSB on average,
# tests/test_generative.py:171-176), so the smoke asks that another class
# move the image well above the same seed's reproduction noise.
GEN_CLASS_MOVES, GEN_CLASS_MIN_LSB = 10.0, 0.01
# Card against CPU (float32, TF32 off), the CPU tests' tolerances: the UNet
# within 1e-4, the sampler and the refinement within 1e-3 on [0, 255], the
# loss within relative 1e-5 and each gradient within relative 1e-4 of its
# largest entry; the bfloat16 sampler above a PSNR floor (both sides round
# every layer's output to bfloat16, in other summation orders, for 3 DDIM
# steps).
GEN_REF = dict(unet_atol=1e-4, sample_atol=1e-3, loss_rtol=1e-5, grad_rtol=1e-4)
SAMPLE_BF16_PSNR_FLOOR = 30.0


@contextlib.contextmanager
def environment(**env):
    """``os.environ`` with ``env`` set while open."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_json(args) -> tuple:
    """(exit code, stdout) of ``srs_tpu_torch.cli.main(args)`` in this
    process."""
    import io

    from srs_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    return rc, buf.getvalue()


def trace_kernels(trace_dir: str) -> dict:
    """The device kernels of the one ``torch.profiler`` trace file in
    ``trace_dir``: count and milliseconds of K1's and K2's (the device
    functions ``pyr_down_kernel`` and ``pyr_up_kernel`` that the C entry
    points ``srs_pyr_down_f32`` and ``srs_pyr_up_f32`` launch), and of all."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"subcommands: process --profile wrote {files} into {trace_dir}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {"file": files[0], "bytes": os.path.getsize(path), "kernel_events": len(kernels),
           "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3}
    for name in ("pyr_down", "pyr_up"):
        ks = [e for e in kernels if f"{name}_kernel" in e.get("name", "")]
        out[name] = {"launches": len(ks), "ms": sum(e.get("dur", 0) for e in ks) / 1e3,
                     "entry_point": f"srs_{name}_f32"}
        if not ks:
            fail(f"subcommands: the --profile trace names no {name}_kernel (srs_{name}_f32)")
    return out


def subcommands(torch, K, tmp: str) -> dict:
    """Phase 19: the operator subcommands on the bench configuration.
    ``python3 -m srs_tpu_torch bench`` once in a subprocess (exit 0, one
    JSON line, no row in the repository's BENCH_LOCAL.md); then the port's
    bench in this process on the input that run rendered (``bench_config``,
    a warm-up with every K1/K2 launch held against the plain version, then
    ``measure`` with the counts set to 0 just before its timed
    ``process()`` and read just after); ``info`` (backend cuda, the card
    among its devices); ``warmup`` at its defaults; ``process --profile
    DIR`` on the bench input (the trace names K1's and K2's device
    kernels)."""
    import srs_tpu_torch.bench as B
    from srs_tpu_torch.io.image import image_size
    from srs_tpu_torch.pipeline import SuperResolutionPipeline

    out: dict = {}
    workdir = os.path.join(tmp, "bench")
    repo_log = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_LOCAL.md")
    log_before = os.path.getsize(repo_log) if os.path.isfile(repo_log) else None
    torch.cuda.empty_cache()  # the subprocess needs the card's memory this process caches
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch", "bench"],
                          env={**os.environ, **BENCH_ENV, "SRS_BENCH_DIR": workdir},
                          capture_output=True, text=True, timeout=400)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"subcommands: python -m srs_tpu_torch bench exited {proc.returncode} with "
             f"{len(lines)} JSON lines: {proc.stderr[-2000:]}")
    sub_line = json.loads(lines[0])
    if sub_line.get("metric") != "720p_to_100MP_end_to_end" or not sub_line["value"] > 0:
        fail(f"subcommands: bench subprocess line {sub_line}")
    out["bench_subprocess"] = {"seconds": time.time() - t0, "line": sub_line}
    log_after = os.path.getsize(repo_log) if os.path.isfile(repo_log) else None
    if log_after != log_before:
        fail("subcommands: the bench wrote into the repository's BENCH_LOCAL.md")

    inp = os.path.join(workdir, "input_720p.png")
    outp = os.path.join(workdir, "output_100mp.tiff")
    with environment(**BENCH_ENV, SRS_BENCH_DIR=workdir):
        pipe = SuperResolutionPipeline(B.bench_config("cuda"))
        K.reset_launches()
        with held_against_plain(K) as records:
            warm = pipe.process(inp, outp)
        if not warm.success:
            fail(f"subcommands: bench warm-up failed: {warm.error_message}")
        held = check_held(K, "subcommands", records)
        launches: dict = {}
        real_process = pipe.process

        def counted(*args, **kwargs):
            K.reset_launches()
            res = real_process(*args, **kwargs)
            launches.update(K.LAUNCHES)
            return res

        pipe.process = counted
        t0 = time.time()
        line = B.measure(pipe, inp, outp, workdir)
        out["measure_s"] = time.time() - t0
        pipe.process = real_process
    for kname in K.LAUNCHES:
        if launches.get(kname, 0) <= 0:
            fail(f"subcommands: the bench's timed run never launched {kname}")
    missing = [k for k in BENCH_KEYS if k not in line]
    kind = torch.cuda.get_device_name(0).lower()
    if missing or not line["value"] > 0 or line["chip_kind"] != kind \
            or not 0 < line["mfu_pct"] < 100 or abs(line["output_mp"] - 84.3) > 0.05:
        fail(f"subcommands: bench line {line} (missing {missing})")
    out.update(bench=line, launches=launches, held_against_plain=held,
               launches_by_shape=launches_by_shape(held))

    t0 = time.time()
    rc, text = cli_json(["info"])
    info = json.loads(text)
    if rc != 0 or info["backend"] != "cuda" or torch.cuda.get_device_name(0) not in info["devices"]:
        fail(f"subcommands: info exited {rc}: backend {info.get('backend')}, devices "
             f"{info.get('devices')}")
    trained = {name: m["trained_scales"] for name, m in info["models"].items()}
    if trained["edsr_xl"] != [3, 4] or trained["espcn"] != [2, 3, 4] \
            or trained["edsr_l_robust"] != [2, 3]:
        fail(f"subcommands: info lists {trained}, not the store's nets")
    out["info"] = {"seconds": time.time() - t0, "backend": info["backend"],
                   "devices": info["devices"], "trained_scales": trained}

    t0 = time.time()
    rc, text = cli_json(["warmup"])
    if rc != 0 or not text.startswith("warmed 1280x720 -> 100MP"):
        fail(f"subcommands: warmup exited {rc}: {text[-500:]}")
    out["warmup"] = {"seconds": time.time() - t0, "stdout": text.strip()}

    t0 = time.time()
    trace_dir = os.path.join(tmp, "trace")
    prof_out = os.path.join(tmp, "out_profiled_cli.tiff")
    rc, text = cli_json(["process", inp, prof_out, "--profile", trace_dir])
    if rc != 0 or image_size(prof_out) != MAIN_OUT:
        fail(f"subcommands: process --profile exited {rc}: {text[-500:]}")
    os.remove(prof_out)
    out["process_profile"] = {"seconds": time.time() - t0, **trace_kernels(trace_dir)}
    shutil.rmtree(trace_dir, ignore_errors=True)
    return out


def unet_flops(torch, module, size: int) -> int:
    """FLOP (two per multiply-add) of one ``CondUNet`` forward pass on one
    size x size input: its convolutions and linear layers from the shapes
    they see, and each attention's two matrix products."""
    from srs_tpu_torch.models.generative import _Attn

    total = []

    def conv(mod, inp, out):
        kh, kw = mod.kernel_size
        total.append(2 * out.numel() * mod.in_channels // mod.groups * kh * kw)

    def linear(mod, inp, out):
        total.append(2 * out.numel() * mod.in_features)

    def attn(mod, inp, out):
        b, c, h, w = inp[0].shape
        total.append(2 * 2 * b * (h * w) ** 2 * c)

    kinds = ((torch.nn.Conv2d, conv), (torch.nn.Linear, linear), (_Attn, attn))
    hooks = [m.register_forward_hook(fn) for m in module.modules()
             for cls, fn in kinds if isinstance(m, cls)]
    dev = next(module.parameters()).device
    with torch.no_grad():
        module(torch.zeros(1, size, size, 3, device=dev), torch.zeros(1, device=dev),
               torch.zeros(1, dtype=torch.long, device=dev))
    for hk in hooks:
        hk.remove()
    return int(sum(total))


def generate_phase(torch, tmp: str) -> dict:
    """Phase 20: generation at the packaged width (``GEN``). ``train_ark``
    on the card (steps/s, TFLOP/s, first and last chunk loss, peak memory;
    the checkpoint and ``ark_meta.json`` reload equal); ``python3 -m
    srs_tpu_torch generate ... --size 2K --checkpoint-dir`` that directory
    in a subprocess (a 2048x2048 PNG from ``ark_gen-ddim`` at 50 steps);
    the same call in this process with the refinement, three times: the
    seconds of the sample, the SR ladder and the refinement, the tile
    count and peak memory, the same seed within 1 LSB, another class
    moving the image well above that (``GEN_CLASS_MOVES``)."""
    from srs_tpu_torch.io.image import image_size, load_image
    from srs_tpu_torch.models.generate import ARKImageConfig, ARKImageGenerator
    from srs_tpu_torch.models.generative import ark_meta, make_class_corpus, train_ark
    from srs_tpu_torch.models.registry import load_checkpoint
    from srs_tpu_torch.tiling.geometry import compute_layout

    ckpt = os.path.join(tmp, "ark")
    t0 = time.time()
    corpus = make_class_corpus(GEN["n_per_class"], GEN["size"], seed=0)
    corpus_s = time.time() - t0
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    module, ema, loss = train_ark(
        steps=GEN["steps"], size=GEN["size"], base=GEN["base"], depth=GEN["depth"],
        batch=GEN["batch"], scan_chunk=GEN["scan_chunk"], corpus=corpus, checkpoint_dir=ckpt,
        device="cuda", on_step=lambda i, v: losses.append(v))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = torch.stack(losses).float().cpu().numpy()
    chunk = GEN["scan_chunk"]
    first, last = float(per_step[:chunk].mean()), float(per_step[-chunk:].mean())
    if len(per_step) != GEN["steps"] or not np.isfinite(per_step).all() or not last < first:
        fail(f"generate: {len(per_step)} steps, first chunk {first}, last chunk {last}")
    if abs(loss - last) > 1e-5 * max(1.0, abs(last)):
        fail(f"generate: returned loss {loss} is not the last chunk's mean {last}")
    saved = load_checkpoint("ark_gen", 1, ckpt)
    meta = ark_meta(ckpt)
    if saved is None or any(not torch.equal(saved[k], v) for k, v in ema.items()) \
            or meta != {k: GEN[k] for k in ("size", "base", "depth")}:
        fail(f"generate: the checkpoint does not reload as the EMA weights (meta {meta})")
    flops = 3 * GEN["batch"] * unet_flops(torch, module, GEN["size"])
    del module
    train = {
        "config": GEN, "corpus_s": corpus_s, "train_s": train_s,
        "steps_per_s": GEN["steps"] / train_s, "step_tflop": flops / 1e12,
        "tflop_per_s": flops * GEN["steps"] / train_s / 1e12,
        "pct_of_bf16_peak": 100.0 * flops * GEN["steps"] / train_s / BF16_FLOPS,
        "first_chunk_loss": first, "last_chunk_loss": last, "peak_mem_gb": train_peak,
    }

    # the command line, once, in its own process
    png = os.path.join(tmp, "generated_2k.png")
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch", "generate", GEN_PROMPT, png,
                           "--size", "2K", "--checkpoint-dir", ckpt],
                          capture_output=True, text=True, timeout=300)
    cli_s = time.time() - t0
    if proc.returncode != 0 or "ark_gen-ddim" not in proc.stdout \
            or image_size(png) != (2048, 2048):
        fail(f"generate: the command line exited {proc.returncode}: {proc.stdout[-500:]} "
             f"{proc.stderr[-2000:]}")
    img = load_image(png)
    if not 5.0 < float(img.std()) or not np.isfinite(img).all():
        fail(f"generate: the 2K PNG is flat (std {img.std()})")
    cli = {"seconds": cli_s, "stdout": proc.stdout.strip().splitlines()[-1:],
           "png_bytes": os.path.getsize(png), "png_std": float(img.std())}
    os.remove(png)

    # in this process, with the refinement
    gen = ARKImageGenerator(checkpoint_dir=ckpt, device="cuda")

    def timed(prompt, seed=None):
        t0 = time.time()
        r = gen.generate(prompt, ARKImageConfig(size="2K", seed=seed, extra={"refine": True}))
        r.metadata["wall_s"] = time.time() - t0
        return r

    torch.cuda.reset_peak_memory_stats()
    runs = [timed(GEN_PROMPT), timed(GEN_PROMPT)]
    runs.append(timed(GEN_OTHER_PROMPT, seed=runs[0].seed))
    peak = torch.cuda.max_memory_allocated() / 1e9
    r1, r2, r3 = runs
    for r in runs:
        if r.metadata.get("model") != "ark_gen-ddim" or r.image.shape != (2048, 2048, 3) \
                or r.metadata["steps"] != 50 or not r.metadata["refined"] \
                or not np.isfinite(r.image).all():
            fail(f"generate: in-process run {r.metadata} {r.image.shape}")
    # The same seed reproduces the image within 1 LSB; another class moves
    # it, on average, by more than GEN_CLASS_MOVES times what the same seed
    # does and by at least GEN_CLASS_MIN_LSB.
    again = np.abs(r1.image - r2.image)
    same = {"max": float(again.max()), "mean": float(again.mean())}
    moved = np.abs(r3.image - r1.image)
    other = {"max": float(moved.max()), "mean": float(moved.mean()),
             "share_over_1_lsb": float((moved > 1.0).mean())}
    if same["max"] > 1.0 or r3.metadata["class"] == r1.metadata["class"] \
            or other["mean"] < max(GEN_CLASS_MOVES * same["mean"], GEN_CLASS_MIN_LSB):
        fail(f"generate: the same seed moves the image by {same}; another class "
             f"({r3.metadata['class']}) by {other}")
    tiles = compute_layout(2048, 2048, block_size=GEN["size"], overlap_ratio=0.25).num_tiles
    return {
        "train": train, "cli": cli,
        "in_process": {"metadata": [r.metadata for r in runs], "refine_tiles": tiles,
                       "peak_mem_gb": peak, "same_seed_abs": same,
                       "other_class_abs": other},
    }


def _seeded_unet_state(torch, base: int, depth: int, seed: int) -> dict:
    """A float32 ``CondUNet`` state dict with every entry random (the
    zero-initialised layers too, so every path carries signal)."""
    from srs_tpu_torch.models.generative import CondUNet

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, ref in CondUNet(base=base, depth=depth, dtype="float32").state_dict().items():
        fan_in = ref[0].numel() if ref.dim() > 1 else ref.shape[0]
        sd[k] = torch.randn(ref.shape, generator=gen) * (0.3 / fan_in ** 0.5) \
            + (1.0 if ".norm" in k and k.endswith("weight") else 0.0)
    return sd


def generate_reference(torch) -> dict:
    """Phase 21: the generator card against CPU at the CPU tests' sizes
    (``CondUNet(base=8, depth=2)`` at 16 px, seeded weights), float32 with
    TF32 off: the UNet's forward, ``sample_ark`` (3 steps, the noise handed
    in), ``refine_ark`` (the eps handed in), one ``train_ark`` batch's loss
    and gradients; and the bfloat16 sampler above its PSNR floor."""
    from srs_tpu_torch.models.generative import CondUNet, ark_loss, refine_ark, sample_ark
    from srs_tpu_torch.tiling.geometry import compute_layout

    torch.backends.cudnn.allow_tf32 = False
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = _seeded_unet_state(torch, 8, 2, seed=21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(1e-4, 1.0, 3).astype(np.float32)
    y = np.asarray([0, 4, 8])
    noise = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    img = np.clip(np.stack([yy * 6, xx * 4, yy * 3 + xx * 2], -1), 0, 255).astype(np.float32)
    n_tiles = compute_layout(56, 40, block_size=16, overlap_ratio=0.25).num_tiles
    eps = rng.normal(size=(n_tiles, 16, 16, 3)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    yb = np.asarray([1, 3, 8, 6])
    tb = rng.uniform(1e-4, 1.0, 4).astype(np.float32)
    eb = rng.normal(size=x0.shape).astype(np.float32)
    got: dict = {}
    for device in ("cuda", "cpu"):
        r: dict = {}
        for dtype in ("float32", "bfloat16"):
            m = CondUNet(base=8, depth=2, dtype=dtype)
            m.load_state_dict(sd)
            m = m.to(device).eval()
            r[f"sample_{dtype}"] = sample_ark(m, 2, size=16, steps=3, guidance=2.0,
                                              noise=noise).cpu().numpy()
            if dtype == "bfloat16":
                continue
            with torch.no_grad():
                r["unet"] = m(*(torch.from_numpy(a).to(device) for a in (x, t, y))).cpu().numpy()
            r["refine"] = refine_ark(m, img, 2, t0=0.08, steps=3, tile=16, chunk=8,
                                     eps=eps).cpu().numpy()
            m.requires_grad_(True)
            loss = ark_loss(m, *(torch.from_numpy(a).to(device) for a in (x0, yb, tb, eb)))
            loss.backward()
            r["loss"] = float(loss.detach())
            r["grads"] = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
        got[device] = r
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    gpu, cpu = got["cuda"], got["cpu"]
    out = {"tolerance": {**GEN_REF, "sample_bf16_psnr_floor_db": SAMPLE_BF16_PSNR_FLOOR}}
    for key, tol in (("unet", GEN_REF["unet_atol"]), ("sample_float32", GEN_REF["sample_atol"]),
                     ("refine", GEN_REF["sample_atol"])):
        out[key] = float(np.abs(gpu[key] - cpu[key]).max())
        if gpu[key].shape != cpu[key].shape or out[key] > tol:
            fail(f"generate_reference: {key}: card against CPU max abs err {out[key]} > {tol}")
    out["loss"] = [gpu["loss"], cpu["loss"]]
    if abs(gpu["loss"] - cpu["loss"]) > GEN_REF["loss_rtol"] * abs(cpu["loss"]):
        fail(f"generate_reference: loss card {gpu['loss']} CPU {cpu['loss']}")
    worst = 0.0
    for k, g in cpu["grads"].items():
        rel = float(np.abs(gpu["grads"][k] - g).max() / max(np.abs(g).max(), 1e-30))
        worst = max(worst, rel)
    out["grad_max_rel"] = worst
    if worst > GEN_REF["grad_rtol"]:
        fail(f"generate_reference: gradients card against CPU relative {worst}")
    a, b = gpu["sample_bfloat16"].astype(np.float64), cpu["sample_bfloat16"].astype(np.float64)
    out["sample_bf16_psnr_db"] = float(10 * np.log10(255.0**2 / max(np.mean((a - b) ** 2),
                                                                      1e-12)))
    if out["sample_bf16_psnr_db"] < SAMPLE_BF16_PSNR_FLOOR:
        fail(f"generate_reference: bf16 sample {out['sample_bf16_psnr_db']:.2f} dB < "
             f"{SAMPLE_BF16_PSNR_FLOOR}")
    return out


# The mesh phases: bench.py:69-83's configuration on a 2x2 virtual mesh of
# the one card (four shards on cuda:0, handed in as ``pipe.dispatcher``).
MESH_SHAPE = {"data": 2, "space": 2}
MESH_LSB_SHARE = 1e-3  # samples more than 0 LSB from the bench path's TIFF


def virtual_mesh(torch, shape: dict):
    """A ``MeshTileDispatcher`` over ``cuda:0`` repeated to the mesh's size."""
    from srs_tpu_torch.parallel import MeshTileDispatcher, make_mesh

    n = int(np.prod(list(shape.values())))
    return MeshTileDispatcher(make_mesh(shape, [torch.device("cuda", 0)] * n))


def lsb_apart(path: str, ref_path: str) -> tuple:
    """(max |difference| in LSB, share of samples that differ) of two TIFFs."""
    from srs_tpu_torch.io.native import read_tiff

    a, b = read_tiff(path).astype(np.int16), read_tiff(ref_path).astype(np.int16)
    if a.shape != b.shape:
        fail(f"{path}: shape {a.shape} != {b.shape}")
    d = np.abs(a - b)
    return int(d.max()), float((d > 0).mean())


def mesh_phase(torch, K, tmp: str, image: np.ndarray, bench_nums: dict) -> dict:
    """Phase 22: ``bench.py:69-83``'s configuration (the bench path's
    pipeline and seeded ``edsr_xl``, the store's ledger) with
    ``mesh_shape={"data": 2, "space": 2}`` on a virtual mesh of four
    shards on ``cuda:0``: a cold
    call with every K1/K2 launch held against its plain version, then two
    warm calls, each with the launch counts set to 0 just before it and
    read just after. The sharded blend must run without the finalize's
    gather fallback, the TIFF must be 12245x6887 and within 1 LSB of the
    bench path's on all but 1e-3 of samples, and the job must leave no
    more memory allocated than the bench path's did. Then ``python3 -m
    srs_tpu_torch process ... --mesh data=2`` on this one-card host must
    exit non-zero and write nothing: nothing fakes devices on the card."""
    from srs_tpu_torch.io.image import save_image
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    pipe = SuperResolutionPipeline(PipelineConfig(**QUALITY_PATH), xl_weights())
    pipe.config.mesh_shape = dict(MESH_SHAPE)
    pipe.dispatcher = virtual_mesh(torch, MESH_SHAPE)
    path = os.path.join(tmp, "out_mesh.tiff")
    bench_tiff = os.path.join(tmp, "out_bench_path.tiff")

    K.reset_launches()
    t0 = time.time()
    with held_against_plain(K) as records:
        cold = pipe.process(image, path)
    cold_s = time.time() - t0
    if not cold.success:
        fail(f"mesh: cold process() failed: {cold.error_message}")
    held = check_held(K, "mesh", records)
    os.remove(path)

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
        K.reset_launches()
        t0 = time.time()
        res = pipe.process(image, path)
        elapsed = time.time() - t0
        launches = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        if not res.success:
            fail(f"mesh: process() failed: {res.error_message}")
        for kname, n in launches.items():
            if n <= 0:
                fail(f"mesh never launched kernel {kname}")
        runs.append({"elapsed_s": elapsed, "stage_times": res.stage_times,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "memory_allocated_before_after": [mem_before, mem_after],
                     "launches": launches})
    info = pipe.last_run_info
    mesh = info["mesh"]
    if not mesh["sharded_blend"] or mesh["gather_fallback"] is not False \
            or mesh["shape"] != MESH_SHAPE or mesh["devices"] != 1:
        fail(f"mesh: {mesh}")
    w, h = MAIN_OUT
    out = read_tiff(path)
    if out.shape != (h, w, 3) or out.dtype != np.uint8:
        fail(f"mesh: output {out.shape} {out.dtype} != ({h}, {w}, 3) uint8")
    del out
    max_lsb_apart, share = lsb_apart(path, bench_tiff)
    if max_lsb_apart > 1 or share > MESH_LSB_SHARE:
        fail(f"mesh: {max_lsb_apart} LSB from the bench path's TIFF on {share} of samples")
    b_before, b_after = bench_nums["memory_allocated_before_after"]
    leaks = [r["memory_allocated_before_after"][1] - r["memory_allocated_before_after"][0]
             for r in runs]
    if max(leaks) > (b_after - b_before) + LEAK_TOL_BYTES:
        fail(f"mesh: {leaks} bytes left allocated, the bench path left {b_after - b_before}")
    if info["models"] != bench_nums["models"] or info["provider"] != bench_nums["provider"]:
        fail(f"mesh: served {info['provider']} {info['models']}, the bench path "
             f"{bench_nums['provider']} {bench_nums['models']}")

    # one card: a two-device mesh on the command line is refused
    t0 = time.time()
    png = os.path.join(tmp, "mesh_in.png")
    save_image(png, image.astype(np.uint8))
    refused = os.path.join(tmp, "out_mesh_refused.tiff")
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch", "process", png, refused,
                           "--mesh", "data=2"], capture_output=True, text=True, timeout=300)
    if proc.returncode == 0 or os.path.exists(refused) or "needs 2 devices" not in proc.stderr:
        fail(f"mesh: --mesh data=2 on one card exited {proc.returncode}, output written "
             f"{os.path.exists(refused)}: {proc.stderr[-1500:]}")
    refusal = {"seconds": time.time() - t0, "exit_code": proc.returncode,
               "error": proc.stderr.strip().splitlines()[-1]}
    os.remove(png)
    warm = runs[-1]
    nums = {
        "mesh_shape": mesh["shape"], "distinct_devices": mesh["devices"],
        "sharded_blend": mesh["sharded_blend"], "gather_fallback": mesh["gather_fallback"],
        "halo_bytes": mesh["halo_bytes"], "cold_s": cold_s, "cold_stage_times": cold.stage_times,
        "runs": runs, "elapsed_s": warm["elapsed_s"], "output_mp": w * h / 1e6,
        "mp_per_s": [w * h / 1e6 / r["elapsed_s"] for r in runs],
        "bench_path_mp_per_s": bench_nums["mp_per_s"],
        "peak_mem_gb": warm["peak_mem_gb"], "bench_path_peak_mem_gb": bench_nums["peak_mem_gb"],
        "launches": warm["launches"], "held_against_plain": held,
        "launches_by_shape": launches_by_shape(held),
        "max_lsb_vs_bench_path": max_lsb_apart, "share_differing_vs_bench_path": share,
        "leak_bytes": leaks, "provider": info["provider"], "models": info["models"],
        "save_breakdown": info["save_breakdown"], "cli_refusal": refusal,
    }
    os.remove(path)
    del pipe
    torch.cuda.empty_cache()
    return nums


def mesh_reference(torch, tmp: str) -> dict:
    """Phase 23: the 2x2 mesh's ``process()`` at small size (80x96 ->
    864x720, seeded ``edsr_m``, routing, selection and QA off, two tile
    rows), on the card (the virtual mesh of ``cuda:0``) and on the CPU (the
    CPU repeated, ``mesh_shape`` in the config), float32 with TF32 off: the
    sharded blend on both, TIFFs within 1 LSB."""
    from srs_tpu_torch.models.registry import seeded_params
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    torch.backends.cudnn.allow_tf32 = False
    image = synthetic_image(80, 96, seed=3)
    weights = {("edsr_m", s): seeded_params("edsr_m", s, seed=5 + s) for s in (2, 3, 4)}
    flags = dict(block_size=64, target_resolution="864x720", quality_model="edsr_m",
                 compute_dtype="float32", auto_route=False, per_scale_selection=False,
                 enable_qa=False)
    paths, infos = {}, {}
    for device in ("cuda", "cpu"):
        mesh_cfg = {"mesh_shape": dict(MESH_SHAPE)} if device == "cpu" else {}
        pipe = SuperResolutionPipeline(PipelineConfig(**flags, device=device, **mesh_cfg),
                                       weights)
        if device == "cuda":
            pipe.dispatcher = virtual_mesh(torch, MESH_SHAPE)
        paths[device] = os.path.join(tmp, f"mesh_ref_{device}.tiff")
        res = pipe.process(image, paths[device])
        if not res.success:
            fail(f"mesh_reference on {device} failed: {res.error_message}")
        infos[device] = pipe.last_run_info["mesh"]
        if not infos[device]["sharded_blend"]:
            fail(f"mesh_reference on {device}: the sharded blend did not run: {infos[device]}")
    torch.backends.cudnn.allow_tf32 = True
    worst, share = lsb_apart(paths["cuda"], paths["cpu"])
    if worst > 1:
        fail(f"mesh_reference: card and CPU {worst} LSB apart")
    for p in paths.values():
        os.remove(p)
    return {"shape": [720, 864, 3], "max_lsb": worst, "frac_differing": share,
            "mesh": {d: {k: v for k, v in m.items() if k != "shape"} for d, m in infos.items()}}


# -- the web UI, the sharded training step and the dry run (phases 24-28) ------

# The web UI's worker on the session's defaults: the bench configuration
# (routing, selection and QA on; 100MP; provider quality) at a block of
# min(tile 1024, 1024), with nothing handed in, so the store's trained nets
# serve and no IBP runs. Its peak must leave room for a second job
# (PERF.md §2).
WEBUI_PEAK_GB = 40.0
# The exports the smoke builds from the worker's TIFF: (format, colour
# space, bit depth).
WEBUI_EXPORTS = (("tiff", "sRGB", 8), ("tiff", "AdobeRGB", 16), ("png", "sRGB", 8))


@contextlib.contextmanager
def recorded_upscales(calls: list):
    """While open, every ``SuperResolutionModule.upscale_tiles`` call appends
    its (tiles, block, scale) to ``calls``: the SR chunking as it ran."""
    from srs_tpu_torch.models.sr_module import SuperResolutionModule

    orig = SuperResolutionModule.upscale_tiles

    def upscale(self, tiles, scale, *args, **kwargs):
        calls.append([int(tiles.shape[0]), int(tiles.shape[1]), int(scale)])
        return orig(self, tiles, scale, *args, **kwargs)

    SuperResolutionModule.upscale_tiles = upscale
    try:
        yield calls
    finally:
        SuperResolutionModule.upscale_tiles = orig


def webui_worker(monitor, image, cfg_state) -> float:
    """``start_worker`` and join the thread; returns its seconds."""
    t0 = time.time()
    monitor.start_worker(image, cfg_state)
    monitor._worker.join()
    return time.time() - t0


def export_check(tiff: np.ndarray, data: bytes, name: str, fmt: str, space: str,
                 bits: int, tmp: str) -> dict:
    """Decode one export and hold it within 1 LSB of the worker's TIFF
    after the same ``convert_profile``, at the export's bit depth."""
    from srs_tpu_torch.io.image import decode_png
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.ops.colorspace import convert_profile

    t0 = time.time()
    if fmt == "tiff":
        path = os.path.join(tmp, "export_" + name)
        with open(path, "wb") as f:
            f.write(data)
        got = read_tiff(path)
        os.remove(path)
    else:
        got = decode_png(data)
    decode_s = time.time() - t0
    want = tiff if space == "sRGB" else convert_profile(tiff, space)
    if bits == 16:
        want = (np.clip(want.astype(np.float64), 0, 255) / 255.0 * 65535.0 + 0.5).astype(np.uint16)
    else:
        want = np.clip(want, 0, 255).astype(np.uint8)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"webui: export {name}: {got.shape} {got.dtype}, want {want.shape} {want.dtype}")
    lsb = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    if lsb > 1:
        fail(f"webui: export {name} is {lsb} LSB from the worker's TIFF")
    return {"decode_s": decode_s, "max_lsb": lsb, "bytes": len(data)}


def webui_phase(torch, K, tmp: str, image: np.ndarray) -> dict:
    """Phase 24: the web UI's headless path on the card. The session at its
    defaults, ``extract_image_info`` of the input array, then
    ``monitor_page.start_worker`` (the Monitor page's worker thread) with
    the Configure page's state: a warm-up with every K1/K2 launch held
    against the plain version, then a run with the counts set to 0 just
    before and read just after. The worker's state must end ``done`` with
    a 12245x6887 TIFF and the bench path's report keys, its log buffer
    must hold the pipeline's records, and the TIFF must lie within 1 LSB
    of a direct ``process()`` with the same ``PipelineConfig``. Then a
    worker run that the Cancel button (``monitor_page.cancel``) stops
    mid-SR ends ``failed: ...cancelled`` with at most 4 MiB more memory
    allocated; ``result_page.build_export`` writes TIFF 8-bit sRGB, TIFF
    16-bit AdobeRGB and PNG sRGB, each within 1 LSB; a JPEG export without
    PIL raises; and ``python3 -m srs_tpu_torch webui`` without Streamlit
    exits non-zero."""
    import dataclasses
    import gc

    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import SuperResolutionPipeline
    from srs_tpu_torch.webui import session
    from srs_tpu_torch.webui.pages import monitor_page as monitor
    from srs_tpu_torch.webui.pages import result_page, upload_page

    session._fallback_state.clear()
    session.initialize_session_state()
    info = upload_page.extract_image_info(image, "input.png", image.nbytes)
    session.set_state("image_info", info)
    session.set_state("uploaded_image", image)
    cfg_state = dict(session.get_config_summary())
    cfg_state["self_ensemble"] = session.get_state("self_ensemble")
    path = os.path.join(tmp, "out_webui.tiff")
    cfg_state["output_path"] = path
    if cfg_state["model_version"] != "quality" or cfg_state["tile_size"] != 1024:
        fail(f"webui: session defaults {cfg_state}")

    K.reset_launches()
    with held_against_plain(K) as records:
        warm_s = webui_worker(monitor, image, cfg_state)
    if session.get_state("current_stage") != "done":
        fail(f"webui: warm-up worker ended {session.get_state('current_stage')!r}")
    held = check_held(K, "webui", records)
    os.remove(path)

    monitor._log_buffer.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls: list = []
    K.reset_launches()
    with recorded_upscales(calls), ibp_calls() as ibp:
        elapsed = webui_worker(monitor, image, cfg_state)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    stage = session.get_state("current_stage")
    pipe = session.get_state("_pipeline")
    report = session.get_state("qa_report") or {}
    if stage != "done" or session.get_state("result_path") != path or \
            session.get_state("processing") is not False:
        fail(f"webui: worker ended {stage!r}, result {session.get_state('result_path')}")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"webui never launched kernel {kname}")
    missing = [k for k in REPORT_KEYS if not np.isfinite(report.get(k, float("nan")))]
    if missing:
        fail(f"webui: qa_report lacks the reference's keys {missing}")
    logged = [m for _, _, m in monitor._log_buffer]
    if not any(m.startswith("Stage 1:") for m in logged):
        fail(f"webui: the log buffer holds no pipeline records: {logged[:5]}")
    if peak > WEBUI_PEAK_GB:
        fail(f"webui: peak {peak:.2f} GB leaves no room for a second job")
    run = pipe.last_run_info
    untrained = [m for m, s in zip(run["models"], run["ladder"])
                 if not pipe.sr_module.is_trained(m, s)]
    if untrained or ibp or pipe.quality_module._lpips.sources != {"vgg": "store",
                                                                   "alex": "store"}:
        fail(f"webui: the worker served untrained {untrained} with {len(ibp)} IBP calls, "
             f"LPIPS from {pipe.quality_module._lpips.sources}, not the store")
    tiff = read_tiff(path)
    w, h = MAIN_OUT
    if tiff.shape != (h, w, 3) or tiff.dtype != np.uint8:
        fail(f"webui: output {tiff.shape} {tiff.dtype} != ({h}, {w}, 3) uint8")
    cfg = pipe.config
    if (cfg.block_size, cfg.provider, cfg.target_resolution, cfg.enable_qa, cfg.auto_route,
            cfg.per_scale_selection) != (1024, "quality", "100MP", True, True, True):
        fail(f"webui: the worker ran {cfg}")

    # the same PipelineConfig through process() directly
    direct_path = os.path.join(tmp, "out_webui_direct.tiff")
    direct = SuperResolutionPipeline(dataclasses.replace(cfg))
    t0 = time.time()
    res = direct.process(image.astype(np.float32), direct_path)
    direct_s = time.time() - t0
    if not res.success:
        fail(f"webui: direct process() failed: {res.error_message}")
    direct_lsb, direct_share = lsb_apart(path, direct_path)
    if direct_lsb > 1:
        fail(f"webui: the worker's TIFF is {direct_lsb} LSB from process()'s")
    os.remove(direct_path)
    del direct, res, pipe  # the session keeps the worker's pipeline
    gc.collect()

    # the Cancel button, mid-SR
    cancel_path = os.path.join(tmp, "out_webui_cancel.tiff")
    orig = SuperResolutionPipeline._upscale_batch

    def cancel_during_sr(self, *args, **kwargs):
        monitor.cancel()
        return orig(self, *args, **kwargs)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    SuperResolutionPipeline._upscale_batch = cancel_during_sr
    K.reset_launches()
    try:
        cancel_s = webui_worker(monitor, image,
                                {**cfg_state, "output_path": cancel_path})
    finally:
        SuperResolutionPipeline._upscale_batch = orig
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    cancelled = session.get_state("current_stage")
    if not cancelled.startswith("failed: ") or "cancelled" not in cancelled \
            or os.path.exists(cancel_path) or after - before > LEAK_TOL_BYTES:
        fail(f"webui: cancel ended {cancelled!r}, output {os.path.exists(cancel_path)}, "
             f"{after - before} bytes left allocated")
    cancel_launches = dict(K.LAUNCHES)

    # the Result page's exports of the worker's TIFF
    exports = {}
    base = tiff.astype(np.float32)
    for fmt, space, bits in WEBUI_EXPORTS:
        t0 = time.time()
        data, name = result_page.build_export(path, fmt, space, bits)
        seconds = time.time() - t0
        exports[f"{fmt}_{space}_{bits}"] = {
            "name": name, "seconds": seconds,
            **export_check(base, data, name, fmt, space, bits, tmp)}
        del data
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # the card's machine has no PIL; hold that here too
    try:
        result_page.build_export(path, "jpeg", "sRGB", 8)
        fail("webui: a JPEG export without PIL did not raise")
    except RuntimeError as e:
        jpeg_error = str(e)
    finally:
        if saved is None:
            sys.modules.pop("PIL", None)
        else:
            sys.modules["PIL"] = saved

    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch", "webui"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode == 0 or "Streamlit" not in proc.stderr:
        fail(f"webui: the subcommand without Streamlit exited {proc.returncode}: "
             f"{proc.stderr[-500:]}")
    os.remove(path)
    session.set_state("_pipeline", None)
    del tiff, base
    gc.collect()
    torch.cuda.empty_cache()
    chunks = sorted({c[0] for c in calls})
    return {
        "image_info": info, "config": {"block_size": cfg.block_size, "provider": cfg.provider,
                                       "target_resolution": cfg.target_resolution,
                                       "ibp_steps": cfg.ibp_steps},
        "warmup_s": warm_s, "elapsed_s": elapsed, "output_mp": w * h / 1e6,
        "mp_per_s": w * h / 1e6 / elapsed, "peak_mem_gb": peak,
        "num_tiles": run["num_tiles"], "block": run["block"], "ladder": run["ladder"],
        "models": run["models"], "provider": run["provider"], "ibp_calls": len(ibp),
        "sr_chunk_tiles": chunks, "upscale_calls": calls,
        "routing": run.get("routing"), "save_breakdown": run.get("save_breakdown"),
        "sr_attempts": run.get("sr_attempts"),
        "launches": launches, "held_against_plain": held,
        "launches_by_shape": launches_by_shape(held),
        "log_records": len(logged), "first_log": logged[:2],
        "direct_process_s": direct_s, "direct_max_lsb": direct_lsb,
        "direct_share_differing": direct_share,
        "cancel": {"stage": cancelled, "seconds": cancel_s, "leak_bytes": after - before,
                   "launches": cancel_launches},
        "exports": exports, "jpeg_without_pil": jpeg_error,
        "webui_subcommand": {"exit_code": proc.returncode,
                             "error": proc.stderr.strip().splitlines()[-1:]},
        "quality_score": report.get("overall_score"),
    }


def webui_reference(torch, tmp: str) -> dict:
    """Phase 25: the worker's job at small size (60x80 -> 160x120, tile 64,
    provider quality, untrained nets with IBP, QA on), on the card and on
    the CPU (``cfg_state["device"]``), float32 convolutions with TF32 off:
    both ``done``, TIFFs within 1 LSB."""
    from srs_tpu_torch.webui import session
    from srs_tpu_torch.webui.pages import monitor_page as monitor

    torch.backends.cudnn.allow_tf32 = False
    image = synthetic_image(60, 80, seed=12)
    cfg = {"tile_size": 64, "overlap_ratio": 0.2, "target_resolution": "160x120",
           "model_version": "quality", "fusion_algorithm": "laplacian"}
    paths, seconds = {}, {}
    for device in ("cuda", "cpu"):
        paths[device] = os.path.join(tmp, f"webui_ref_{device}.tiff")
        t0 = time.time()
        monitor._run_pipeline(image, {**cfg, "device": device, "output_path": paths[device]})
        seconds[device] = time.time() - t0
        if session.get_state("current_stage") != "done":
            fail(f"webui_reference on {device}: {session.get_state('current_stage')!r}")
    torch.backends.cudnn.allow_tf32 = True
    session.set_state("_pipeline", None)
    worst, share = lsb_apart(paths["cuda"], paths["cpu"])
    if worst > 1:
        fail(f"webui_reference: card and CPU {worst} LSB apart")
    for p in paths.values():
        os.remove(p)
    return {"shape": [120, 160, 3], "max_lsb": worst, "frac_differing": share,
            "run_s": seconds}


# The sharded training step at the trainer's width: edsr_xl x3 (16 blocks,
# 128 features), batch 32 of 48-px patches, on a data=2, space=2, model=2
# virtual mesh of cuda:0, against the unsharded step from the same weights.
SHARDED_MESH = {"data": 2, "space": 2, "model": 2}
SHARDED_STEPS = 3
SHARDED_GRAD_ATOL = 1e-3  # step 1's gradients, of their largest entry


def sharded_batches(torch, steps: int, batch: int, patch: int, scale: int, device: str):
    """``steps`` (lr, hr) batches cut from one seeded synthetic photo."""
    from srs_tpu_torch.models.train import sample_patches

    rng = np.random.default_rng(14)
    img = torch.from_numpy(synthetic_image(480, 640, seed=15)).to(device)
    return [sample_patches(rng, img, batch, patch, scale) for _ in range(steps)]


def sharded_steps(torch, net, opt, batches, mesh=None, stats=None):
    """Run the steps (sharded on ``mesh``, else ``train_step``): per step
    (loss, grad norm, seconds), and step 1's gradients."""
    from srs_tpu_torch.models.train import train_step
    from srs_tpu_torch.parallel.train import sharded_train_step

    out, grads = [], None
    for lr_b, hr_b in batches:
        torch.cuda.synchronize()
        t0 = time.time()
        if mesh is None:
            m = train_step(net, opt, lr_b, hr_b)
        else:
            m = sharded_train_step(net, opt, lr_b, hr_b, mesh, stats=stats)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out.append((loss, norm, time.time() - t0))
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
    return out, grads


def sharded_train_phase(torch) -> dict:
    """Phase 26: three steps of ``parallel/train.sharded_train_step`` on
    ``edsr_xl`` x3 at full width, batch 32, patch 48, on a data=2,
    space=2, model=2 virtual mesh of ``cuda:0``, against three unsharded
    ``models/train.train_step`` steps from the same weights and batches,
    float32 with TF32 off: step 1's gradients within 1e-3 of their largest
    entry, every loss within relative 1e-3; steps/s of both and the halo
    bytes."""
    import copy

    from srs_tpu_torch.models.registry import build_model, seeded_params
    from srs_tpu_torch.models.train import init_train_state
    from srs_tpu_torch.parallel.mesh import make_mesh
    from srs_tpu_torch.parallel.train import receptive_radius, shard_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base, _ = build_model("edsr_xl", 3, seeded_params("edsr_xl", 3, seed=13), dtype="float32",
                          device="cuda", master_weights=True)
    batches = sharded_batches(torch, SHARDED_STEPS, TRAIN["batch"], TRAIN["patch"], 3, "cuda")
    ref, ref_opt = init_train_state(copy.deepcopy(base))
    got, got_opt = init_train_state(copy.deepcopy(base))
    del base
    n = int(np.prod(list(SHARDED_MESH.values())))
    mesh = make_mesh(SHARDED_MESH, [torch.device("cuda", 0)] * n)
    split = shard_params(got, mesh)
    radius = receptive_radius(got)
    torch.cuda.reset_peak_memory_stats()
    want, want_grads = sharded_steps(torch, ref, ref_opt, batches)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    have, have_grads = sharded_steps(torch, got, got_opt, batches, mesh, stats)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    gmax = max(float(g.abs().max()) for g in want_grads.values())
    gerr = max(float((have_grads[k] - g).abs().max()) for k, g in want_grads.items())
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(have, want))
    if gerr > SHARDED_GRAD_ATOL * gmax or rel > TRAIN_LOSS_RTOL \
            or not all(np.isfinite(a[:2]).all() for a in have):
        fail(f"sharded_train: step-1 gradients {gerr} apart (largest {gmax}), losses "
             f"{[a[0] for a in have]} against {[b[0] for b in want]}")
    del ref, got, want_grads, have_grads
    torch.cuda.empty_cache()
    return {
        "config": {"model": "edsr_xl", "scale": 3, "batch": TRAIN["batch"],
                   "patch": TRAIN["patch"], "mesh": SHARDED_MESH, "steps": SHARDED_STEPS},
        "receptive_radius": radius,
        "split_convs": len(split), "halo_bytes": stats.get("halo_bytes", 0),
        "sharded": {"loss_grad_norm_s": have,
                    "steps_per_s": len(have) / sum(a[2] for a in have),
                    "warm_steps_per_s": (len(have) - 1) / sum(a[2] for a in have[1:]),
                    "peak_mem_gb": peak},
        "unsharded": {"loss_grad_norm_s": want,
                      "steps_per_s": len(want) / sum(b[2] for b in want),
                      "warm_steps_per_s": (len(want) - 1) / sum(b[2] for b in want[1:]),
                      "peak_mem_gb": ref_peak},
        "step1_grad_err": gerr, "step1_grad_max": gmax, "max_rel_loss_diff": rel,
        "tolerance": {"grad_atol_of_max": SHARDED_GRAD_ATOL, "loss_rtol": TRAIN_LOSS_RTOL},
    }


def sharded_train_reference(torch) -> dict:
    """Phase 27: two sharded steps of a seeded ``edsr_m`` x2 (batch 4 of
    16-px patches) on a data=2, space=2, model=2 virtual mesh of the card
    and of the CPU, float32 with TF32 off: losses within relative 1e-3."""
    from srs_tpu_torch.models.registry import build_model, seeded_params
    from srs_tpu_torch.models.train import init_train_state
    from srs_tpu_torch.parallel.mesh import make_mesh
    from srs_tpu_torch.parallel.train import shard_params, sharded_train_step

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(16)
    batches = []
    for _ in range(2):
        hr = rng.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
        batches.append((hr.reshape(4, 16, 2, 16, 2, 3).mean(axis=(2, 4)), hr))
    losses = {}
    for device in ("cuda", "cpu"):
        net, _ = build_model("edsr_m", 2, seeded_params("edsr_m", 2, seed=6), dtype="float32",
                             device=device, master_weights=True)
        net, opt = init_train_state(net, 1e-3)
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
        mesh = make_mesh(SHARDED_MESH, [dev] * int(np.prod(list(SHARDED_MESH.values()))))
        shard_params(net, mesh)
        rec = []
        for lr_b, hr_b in batches:
            m = sharded_train_step(net, opt, torch.from_numpy(lr_b).to(device),
                                   torch.from_numpy(hr_b).to(device), mesh)
            rec.append((float(m["loss"]), float(m["grad_norm"])))
        losses[device] = rec
    torch.backends.cudnn.allow_tf32 = True
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(losses["cuda"], losses["cpu"]))
    if rel > TRAIN_LOSS_RTOL:
        fail(f"sharded_train_reference: losses card {losses['cuda']} CPU {losses['cpu']}")
    return {"loss_grad_norm": losses, "max_rel_loss_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL}


def dryrun_phase(torch, K) -> dict:
    """Phase 28: ``parallel/dryrun.dryrun_multichip(8)`` on a virtual mesh
    of ``cuda:0`` (data=2, space=2, model=2 for the step; space=8 for the
    merge, blend and finalize): once with every K1/K2 launch held against
    the plain version, then once with the counts set to 0 just before and
    read just after."""
    from srs_tpu_torch.parallel.dryrun import dryrun_multichip

    K.reset_launches()
    with held_against_plain(K) as records:
        dryrun_multichip(8)
    torch.cuda.synchronize()
    held = check_held(K, "dryrun", records)
    K.reset_launches()
    t0 = time.time()
    out = dryrun_multichip(8)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(K.LAUNCHES)
    for kname, n in launches.items():
        if n <= 0:
            fail(f"dryrun never launched kernel {kname}")
    return {**out, "timed_s": seconds, "launches": launches, "held_against_plain": held,
            "launches_by_shape": launches_by_shape(held)}


# -- the drivers under scripts/ (phases 29 and 30) ------------------------------

PROOF_OUT = (17320, 9742)  # (width, height) of the 200MP preset at 16:9
# The proof's input reads as blurred, so routing serves the store's
# edsr_l_robust, trained at x2 and x3, on [2, 2, 3] (the reference's
# packaged nets route it so too); with every net untrained (the store
# hidden) the ladder is [3, 4].
PROOF_LADDER = [2, 2, 3]
PROOF_REF_LADDER = [3, 4]
PROOF_PEAK_GB = 80.0
PROOF_READBACK_PSNR_DB = 30.0
# The largest K1/K2 launches of the proof: 6 tiles of 512 px x12.
PROOF_K1 = ([6, 6144, 6144, 3], [6, 3072, 3072, 3])
PROOF_K2_OUT = [6, 6144, 6144, 3]
# Card against CPU (phase 30): the proof's 16-bit TIFFs within 16 units,
# a sixteenth of one 8-bit LSB (257 units), so 8-bit pixels scaled to 16
# bits would fail; quality_bench's rows (bf16 nets) within 0.05 dB;
# pretrain from a seeded espcn x2 (float32, TF32 off), its loss within
# relative 1e-3 and its parameters' change within relative 1e-2 of the
# CPU's change.
PROOF_REF_UNITS = 16
QBENCH_REF_DB = 0.05
QBENCH_ROWS = 7
TRAIN_UPDATE_RTOL = 1e-2
# quality_bench's rows card against CPU in groups, each with a checkpoint
# directory of its own seeded nets (seeds 42, 43, ... in a group's order),
# so that every row serves the nets it names: the net rows with routing and
# per-scale selection off (else the SR-gain probe shrinks a random net to
# bicubic, and selection serves one net for all three quality rows); hybrid
# with the polish alone trained (it polishes only an untrained quality
# net); zssr tuning espcn x2 (tuned from the zero-tail untrained net,
# Adam's first steps scale rounding-level gradients up to the learning rate
# and the two devices drift apart, 0.06-0.07 dB even in float32; a seeded
# edsr_xl would take minutes to tune on the CPU).
QBENCH_GROUPS = (
    (("bicubic", "fast", "quality"),
     (("espcn", 2), ("edsr_xl", 2), ("rcan", 2), ("edsr_l", 2)),
     {"auto_route": False, "per_scale_selection": False}),
    (("hybrid",), (("espcn_polish", 1),), {"auto_route": False, "per_scale_selection": False}),
    (("zssr",), (("espcn", 2),), {}),
)


def proof_check(report: dict, name: str) -> None:
    """What the proof must show (the reference's proof row): the preset's
    size at 16 bits on ``PROOF_LADDER``, a whole file, one SR attempt and
    no degradation."""
    bad = []
    if (report["width"], report["height"]) != PROOF_OUT or report["bits_tag"] != 16:
        bad.append(f"{report['width']}x{report['height']} at {report['bits_tag']} bits")
    if report["ladder"] != PROOF_LADDER:
        bad.append(f"ladder {report['ladder']}")
    if report["sr_attempts"] != 1 or report["sr_degradations"] != 0:
        bad.append(f"sr_attempts {report['sr_attempts']}, "
                   f"sr_degradations {report['sr_degradations']}")
    if not report["header_ok"]:
        bad.append("header check failed")
    if bad:
        fail(f"drivers: {name}: {'; '.join(bad)}")


def proof_phase(torch, K, tmp: str) -> dict:
    """``proof_200mp`` at the 200MP preset, 16 bits: once as a user runs it
    (``python3 -m srs_tpu_torch.drivers.proof_200mp``, cold), then in this
    process with every K1/K2 launch held against the plain version, then
    timed with the launch counts set to 0 just before and read just after;
    the TIFF read back with ``read_tiff`` (outside the timing) and
    area-downscaled to the input's size, its PSNR against the input."""
    import torch.nn.functional as F

    from srs_tpu_torch.drivers import proof_200mp
    from srs_tpu_torch.io.image import load_image
    from srs_tpu_torch.io.native import read_tiff

    out_dir = os.path.join(tmp, "proof")
    args = ["--target", "200MP", "--bit-depth", "16", "--out", out_dir]
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch.drivers.proof_200mp", *args],
                          capture_output=True, text=True, timeout=600)
    cold_s = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or lines[-1] != "PROOF OK":
        fail(f"drivers: proof_200mp subprocess exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    cold = json.loads(lines[-2])
    proof_check(cold, "proof_200mp (subprocess)")
    os.remove(cold["output"])

    K.reset_launches()
    with held_against_plain(K) as records:
        warm = proof_200mp.main(args)
    torch.cuda.synchronize()
    held = check_held(K, "proof_200mp", records)
    proof_check(warm, "proof_200mp (held)")
    os.remove(warm["output"])
    shapes = {(kname, str(s_in), str(s_out)) for kname, s_in, s_out, _e in records}
    if ("pyr_down", str(PROOF_K1[0]), str(PROOF_K1[1])) not in shapes or \
            not any(k == "pyr_up" and s_out == str(PROOF_K2_OUT) for k, _i, s_out in shapes):
        fail(f"drivers: the proof never launched K1 {PROOF_K1} or K2 to {PROOF_K2_OUT}")
    torch.cuda.empty_cache()

    K.reset_launches()
    timed = proof_200mp.main(args)
    launches = dict(K.LAUNCHES)
    proof_check(timed, "proof_200mp (timed)")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"drivers: proof_200mp never launched kernel {kname}")
    if timed["peak_mem_gb"] >= PROOF_PEAK_GB:
        fail(f"drivers: proof peak memory {timed['peak_mem_gb']:.2f} GB >= {PROOF_PEAK_GB}")

    t0 = time.time()
    pixels = read_tiff(timed["output"])
    read_s = time.time() - t0
    h, w = PROOF_OUT[1], PROOF_OUT[0]
    if pixels.dtype != np.uint16 or pixels.shape != (h, w, 3):
        fail(f"drivers: proof read back {pixels.shape} {pixels.dtype}")
    inp = load_image(os.path.join(out_dir, "in.png"))
    with torch.no_grad():
        big = torch.from_numpy(pixels.view(np.int16)).cuda()
        del pixels
        big = (big.int() & 0xFFFF).float().div_(257.0)  # uint16 -> 8-bit scale
        small = F.interpolate(big.permute(2, 0, 1)[None], size=inp.shape[:2], mode="area")
        del big
        small = small[0].permute(1, 2, 0).cpu().numpy()
    torch.cuda.empty_cache()
    mse = float(np.mean((small.astype(np.float64) - inp) ** 2))
    readback_db = float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
    if readback_db < PROOF_READBACK_PSNR_DB:
        fail(f"drivers: the proof read back at {readback_db:.2f} dB against its input "
             f"(< {PROOF_READBACK_PSNR_DB})")
    os.remove(timed["output"])
    keep = ("file_bytes", "file_gb", "compression", "strip_count", "rows_per_strip",
            "stage_times", "elapsed_s_exact", "mp_per_s", "peak_mem_gb", "save_breakdown",
            "quality_score", "ladder", "sr_attempts", "sr_degradations")
    return {
        "output": list(PROOF_OUT), "bits": 16,
        "cold": {"command_s": cold_s, **{k: cold[k] for k in keep}},
        "held_run": {k: warm[k] for k in ("elapsed_s_exact", "peak_mem_gb", "stage_times")},
        "timed": {k: timed[k] for k in keep},
        "launches": launches, "held_against_plain": held,
        "launches_by_shape": launches_by_shape(held),
        "readback": {"read_tiff_s": read_s, "psnr_db_vs_input": readback_db,
                     "floor_db": PROOF_READBACK_PSNR_DB},
    }


def qbench_phase(torch, K) -> dict:
    """``quality_bench --n 2 --size 512 --no-photo`` (cut from six images):
    the seven provider rows, every K1/K2 launch held against its plain
    version."""
    from srs_tpu_torch.drivers import quality_bench

    K.reset_launches()
    t0 = time.time()
    with held_against_plain(K) as records:
        rows = quality_bench.main(["--n", "2", "--size", "512", "--no-photo"])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    held = check_held(K, "quality_bench", records)
    launches = dict(K.LAUNCHES)
    if len(rows) != QBENCH_ROWS or not all(np.isfinite(r["psnr_mean"]) for r in rows):
        fail(f"drivers: quality_bench rows {rows}")
    return {"rows": rows, "seconds": seconds, "launches": launches,
            "held_against_plain": held}


def photo_bound_drivers(tmp: str, ckdir: str) -> dict:
    """The drivers that need photographs raise ``PhotoDataMissing`` naming
    the missing packages where none is installed (as on the card)."""
    from srs_tpu_torch.drivers import (cond_panel, fit_fusion, fit_qa_models, photo_eval,
                                       quality_bench, routed_panel)
    from srs_tpu_torch.models.photo_data import (EVAL_HOLDOUT_SOURCES, PHOTO_SOURCES,
                                                 PhotoDataMissing, missing_packages)

    missing = {"panel": missing_packages(EVAL_HOLDOUT_SOURCES + [photo_eval.PORTRAIT]),
               "training": missing_packages(PHOTO_SOURCES)}
    calls = {
        "photo_eval": (photo_eval.main, ["--checkpoint-dir", ckdir], "panel"),
        "routed_panel": (routed_panel.main, ["--checkpoint-dir", ckdir], "panel"),
        "cond_panel": (cond_panel.main, ["--checkpoint-dir", ckdir], "panel"),
        "quality_bench_photo_row": (quality_bench.main, ["--n", "0"], "panel"),
        "fit_fusion": (fit_fusion.main, ["--checkpoint-dir", ckdir], "training"),
        "fit_qa_models": (fit_qa_models.main, ["--out", os.path.join(tmp, "qa_full")],
                          "training"),
    }
    out = {"missing_packages": missing}
    for name, (main, args, needs) in calls.items():
        if len(missing[needs]) == 0:
            out[name] = "photo packages installed: not applicable"
            continue
        try:
            main(args)
        except PhotoDataMissing as e:
            if not any(pkg in str(e) for pkg in missing[needs]):
                fail(f"drivers: {name}'s error names no missing package: {e}")
            out[name] = str(e)
            continue
        fail(f"drivers: {name} ran without its photographs")
    return out


def reloads_equal(torch, path: str, state: dict) -> bool:
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return set(saved) == set(state) and all(torch.equal(saved[k], state[k]) for k in state)


def training_drivers(torch, tmp: str, ckdir: str) -> dict:
    """The training drivers the card can run, for a few steps each into a
    temporary checkpoint directory: finite losses, each saved file reloads
    equal, the FiLM layer trains; then ``reeval`` on the net ``pretrain``
    wrote and ``eval_ark`` on the generator ``train_ark`` wrote."""
    from srs_tpu_torch.drivers import (eval_ark, fit_qa_models, pretrain, reeval, train_ark,
                                       train_cond, train_lpips, train_polish)

    out, seconds = {}, {}

    def run(name, fn, args):
        t0 = time.time()
        rep = fn(args)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        return rep

    rep = run("pretrain", pretrain.main, ["--only", "edsr_xl_x3", "--steps", "20", "--mix",
                                          "proc", "--corpus-n", "16", ckdir])
    entry = rep["eval"]["edsr_xl_x3"]
    if not np.isfinite(entry["final_loss"]) or not reloads_equal(
            torch, os.path.join(ckdir, "edsr_xl_x3.pt"), rep["states"]["edsr_xl_x3"]):
        fail(f"drivers: pretrain: loss {entry['final_loss']} or its checkpoint")
    out["pretrain"] = entry
    for name, fn, args in (
            ("train_polish", train_polish.main, ["--steps", "20", "--scan-chunk", "10"]),
            ("train_cond", train_cond.main, ["--steps", "20", "--scan-chunk", "10"])):
        rep = run(name, fn, [*args, "--mix", "proc", "--corpus-n", "16", "--out", ckdir])
        if not np.isfinite(rep["chunk_losses"]).all() or not reloads_equal(
                torch, rep["path"], rep["state"]):
            fail(f"drivers: {name}: losses {rep['chunk_losses']} or its checkpoint")
        out[name] = {"eval": rep["eval"], "chunk_losses": rep["chunk_losses"],
                     **({"film_weight_moved": rep["film_weight_moved"]}
                        if name == "train_cond" else {})}
    if not out["train_cond"]["film_weight_moved"] > 0:
        fail("drivers: train_cond did not train the FiLM layer")
    rep = run("train_lpips", train_lpips.main, ["--net", "alex", "--steps", "100", "--mix",
                                                "proc", "--pairs-n", "4", "--holdout-n", "2",
                                                "--out", ckdir])
    lp = rep["nets"]["alex"]
    if not np.isfinite(lp["chunk_losses"]).all() or not reloads_equal(torch, lp["path"],
                                                                       lp["state"]):
        fail(f"drivers: train_lpips: losses {lp['chunk_losses']} or its checkpoint")
    out["train_lpips"] = {k: lp[k] for k in ("rank_acc_random", "rank_acc_trained",
                                             "chunk_losses")}
    rep = run("fit_qa_models", fit_qa_models.main, ["--only", "lpips", "--out",
                                                    os.path.join(tmp, "qa"),
                                                    "--checkpoint-dir", ckdir])
    out["fit_qa_models_lpips"] = rep
    rep = run("train_ark", train_ark.main, ["--steps", "100", "--scan-chunk", "50",
                                            "--n-per-class", "8", "--size", "32", "--base",
                                            "32", "--depth", "1", "--batch", "16", "--out",
                                            ckdir])
    if not all(np.isfinite(loss) for _s, loss in rep["logged"]) or not reloads_equal(
            torch, rep["path"], rep["state"]):
        fail(f"drivers: train_ark: logged {rep['logged']} or its checkpoint")
    out["train_ark"] = {"eval": rep["eval"], "logged": rep["logged"]}

    # reeval scores every trained net, the store's too (as the reference's
    # scores its packaged ones): pretrain's alone is asked for
    rep = run("reeval", reeval.main, ["--only", "edsr_xl_x3", ckdir])
    if list(rep) != ["edsr_xl_x3"] or abs(rep["edsr_xl_x3"]["psnr_net"]
                                          - entry["psnr_net"]) > 1e-3:
        fail(f"drivers: reeval of pretrain's net: {rep} against {entry}")
    out["reeval"] = rep
    rep = run("eval_ark", eval_ark.main, ["--k", "2", "--real-n", "4", "--steps", "10",
                                          "--checkpoint-dir", ckdir])
    if not rep["ok"] or not 0.0 <= rep["class_accuracy"] <= 1.0:
        fail(f"drivers: eval_ark on train_ark's generator: {rep}")
    out["eval_ark"] = rep
    out["seconds"] = seconds
    return out


def drivers_phase(torch, K, tmp: str) -> dict:
    """Phase 29: the drivers of ``srs_tpu_torch/drivers/`` on the card."""
    t0 = time.time()
    proof = proof_phase(torch, K, tmp)
    proof_s = time.time() - t0
    qbench = qbench_phase(torch, K)
    ckdir = os.path.join(tmp, "driver_models")
    t0 = time.time()
    train = training_drivers(torch, tmp, ckdir)
    train_s = time.time() - t0
    t0 = time.time()
    photo = photo_bound_drivers(tmp, ckdir)
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"proof_200mp": proof, "quality_bench": qbench, "training_and_eval": train,
            "photo_bound": photo,
            "seconds": {"proof": proof_s, "quality_bench": qbench["seconds"],
                        "training_and_eval": train_s, "photo_bound": time.time() - t0}}


@contextlib.contextmanager
def batches_drawn_on_the_cpu():
    """``train_synthetic``'s batches drawn from a CPU generator and copied
    to the corpus's device, so a card run and a CPU run train on the same
    patches (the card's Philox generator and the CPU's Mersenne twister
    give different numbers for one seed)."""
    import torch

    import srs_tpu_torch.models.train as train_mod

    real = train_mod._train_batch
    gen = torch.Generator().manual_seed(1)

    def on_cpu(corpus, batch, hp, _gen, hr_grain):
        return real(corpus.cpu(), batch, hp, gen, hr_grain).to(corpus.device)

    train_mod._train_batch = on_cpu
    try:
        yield
    finally:
        train_mod._train_batch = real


@contextlib.contextmanager
def qbench_rows(rows):
    """``quality_bench`` runs only ``rows`` of its providers."""
    from srs_tpu_torch.drivers import quality_bench

    real = quality_bench.PROVIDERS
    quality_bench.PROVIDERS = rows
    try:
        yield
    finally:
        quality_bench.PROVIDERS = real


def drivers_reference(torch, tmp: str) -> dict:
    """Phase 30: the drivers card against CPU at a reduced size. The proof
    on a 32x18 input to 416x234 (13x, still the [3, 4] ladder), 16-bit
    TIFFs within ``PROOF_REF_UNITS``; ``quality_bench --n 1 --size 192``
    (192, not 128: zssr's 48-px LR patches need a 96-px input at x2) in
    the groups of ``QBENCH_GROUPS``, each row within ``QBENCH_REF_DB`` and
    no two rows alike; ``pretrain`` for 3 steps of espcn x2 from seeded
    weights, in float32 with TF32 off on the same batches, loss within
    ``TRAIN_LOSS_RTOL`` and the parameters' change within
    ``TRAIN_UPDATE_RTOL`` of the CPU's change."""
    from srs_tpu_torch.drivers import pretrain, proof_200mp, quality_bench
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.models.registry import seeded_params
    from srs_tpu_torch.models.train import save_checkpoint

    out = {}
    tiffs = {}
    for dev in ("cuda", "cpu"):
        rep = proof_200mp.main(["--device", dev, "--source", "32x18", "--target", "416x234",
                                "--block-size", "32", "--out", os.path.join(tmp, f"proof_{dev}")])
        if rep["ladder"] != PROOF_REF_LADDER:
            fail(f"drivers_reference: proof on {dev}: ladder {rep['ladder']}")
        tiffs[dev] = read_tiff(rep["output"]).astype(np.int32)
    units = int(np.abs(tiffs["cuda"] - tiffs["cpu"]).max())
    if units > PROOF_REF_UNITS:
        fail(f"drivers_reference: the proof's TIFFs differ by {units} > {PROOF_REF_UNITS}")
    out["proof_200mp"] = {"max_units": units, "tolerance": PROOF_REF_UNITS}

    rows = {"cuda": [], "cpu": []}
    for gi, (providers, nets, cfg) in enumerate(QBENCH_GROUPS):
        ck = os.path.join(tmp, f"qbench_{gi}")
        for seed, (name, scale) in enumerate(nets, 42):
            save_checkpoint(seeded_params(name, scale, seed=seed), name, scale, ck)
        # every group runs the bicubic row, which the bench's summary reads
        group = [(p, {**extra, **cfg}) for p, extra in quality_bench.PROVIDERS
                 if p in providers or p == "bicubic"]
        for dev in ("cuda", "cpu"):
            with qbench_rows(group):
                got = quality_bench.main(
                    ["--n", "1", "--size", "192", "--no-photo", "--checkpoint-dir", ck,
                     *(["--cpu"] if dev == "cpu" else [])])
            rows[dev] += [r for r in got if r["provider"] != "bicubic" or gi == 0]
    torch.backends.cudnn.allow_tf32 = False
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    init_dir = os.path.join(tmp, "pre_init")
    init = seeded_params("espcn", 2, seed=7)
    save_checkpoint(init, "espcn", 2, init_dir)
    losses, deltas = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            with batches_drawn_on_the_cpu():
                rep = pretrain.main(["--only", "espcn_x2", "--steps", "3", "--scan-chunk", "1",
                                     "--corpus-n", "4", "--mix", "proc", "--device", dev,
                                     "--dtype", "float32", "--init-from", init_dir,
                                     os.path.join(tmp, f"pre_{dev}")])
            losses[dev] = rep["eval"]["espcn_x2"]
            state = rep["states"]["espcn_x2"]
            deltas[dev] = torch.cat([(state[k] - init[k]).flatten() for k in sorted(init)])
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    diffs = {r["provider"]: abs(r["psnr_mean"] - c["psnr_mean"])
             for r, c in zip(rows["cuda"], rows["cpu"])}
    if len(diffs) != QBENCH_ROWS or max(diffs.values()) > QBENCH_REF_DB:
        fail(f"drivers_reference: quality_bench card {rows['cuda']} CPU {rows['cpu']}")
    served = [r["psnr_mean"] for r in rows["cuda"]]
    if len(set(served)) != len(served):
        fail(f"drivers_reference: quality_bench rows that serve different nets agree: "
             f"{rows['cuda']}")
    out["quality_bench"] = {"abs_db": diffs, "tolerance_db": QBENCH_REF_DB,
                            "psnr_card": {r["provider"]: r["psnr_mean"] for r in rows["cuda"]},
                            "seeded_nets": {",".join(p): [f"{n}_x{sc}" for n, sc in nets]
                                            for p, nets, _cfg in QBENCH_GROUPS}}
    a, b = losses["cuda"]["final_loss"], losses["cpu"]["final_loss"]
    rel = abs(a - b) / abs(b)
    moved = float(deltas["cpu"].norm())
    upd_rel = float((deltas["cuda"] - deltas["cpu"]).norm()) / max(moved, 1e-30)
    if rel > TRAIN_LOSS_RTOL or not moved > 0 or upd_rel > TRAIN_UPDATE_RTOL:
        fail(f"drivers_reference: pretrain loss card {a} CPU {b}; update {moved}, "
             f"card against CPU relative {upd_rel}")
    out["pretrain"] = {"final_loss": [a, b], "rel": rel, "tolerance": TRAIN_LOSS_RTOL,
                       "update_norm": moved, "update_rel": upd_rel,
                       "update_tolerance": TRAIN_UPDATE_RTOL,
                       "psnr_net": [losses["cuda"]["psnr_net"], losses["cpu"]["psnr_net"]]}
    return out


def self_dev_ms(e) -> float:
    """An op's own device milliseconds in ``key_averages()``, under either
    name the profiler has given it."""
    us = getattr(e, "self_device_time_total", None)
    return (us if us is not None else getattr(e, "self_cuda_time_total", 0)) / 1e3


def busy_intervals(spans) -> list:
    """The union of device (start, end) intervals, sorted."""
    busy = []
    for a, b in sorted(spans):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def profile_training(torch, image: np.ndarray) -> dict:
    """A zssr tune (seeded edsr_xl x3, 30 steps at batch 8, patch 48) and a
    trainer run (30 steps at batch 32 on a 4-image corpus) under
    torch.profiler, each after a warm-up: the device's busy share of the
    wall time, device launches a step, and the time by kernel and by op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from srs_tpu_torch.models.corpus import make_corpus
    from srs_tpu_torch.models.registry import build_model
    from srs_tpu_torch.models.train import train_synthetic, zssr_finetune

    net, _ = build_model("edsr_xl", 3, xl_weights()[("edsr_xl", 3)], device="cuda",
                         master_weights=True)
    corpus = make_corpus(4, TRAIN["corpus_size"], seed=0)
    runs = {
        "zssr": lambda steps: zssr_finetune(net, image, scale=3, steps=steps, patch=ZSSR_PATCH,
                                            batch=ZSSR_BATCH, lr=1e-4),
        "train": lambda steps: train_synthetic("edsr_xl", 3, steps=steps, scan_chunk=steps,
                                               patch=TRAIN["patch"], batch=TRAIN["batch"],
                                               corpus=corpus, device="cuda"),
    }
    out = {}
    for name, run in runs.items():
        run(5)
        torch.cuda.synchronize()
        steps = 30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            run(steps)
            torch.cuda.synchronize()
            wall = time.time() - t0
        spans, by_name = [], {}
        for e in prof.events():
            # the optimizer's range on the device timeline is no kernel
            if e.device_type != DeviceType.CUDA or e.name.startswith("Optimizer."):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy_us = sum(b - a for a, b in busy_intervals(spans))
        ops = sorted(((e.key, self_dev_ms(e), e.count) for e in prof.key_averages()
                      if e.key.startswith("aten::") and self_dev_ms(e) > 0),
                     key=lambda t: -t[1])[:10]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out[name] = {
            "steps": steps, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
            "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
            "device_events_per_step": len(spans) / steps,
            "top_device_ms": [[k[:120], round(ms, 3), n] for k, (ms, n) in top],
            "top_ops_self_device_ms": [[k, round(ms, 3), n] for k, ms, n in ops],
        }
    return out



def profile_generation(torch) -> dict:
    """The generator at the packaged width (``GEN``, seeded weights) under
    torch.profiler, each after a warm-up: 10 ``train_ark`` steps at batch
    64 (``ark_loss``, backward, the clip-then-Adam step and the EMA, on
    fixed draws), the 50-step DDIM sample at batch 2, and one refinement
    chunk (64 tiles, 8 steps: 8 UNet calls at batch 128). For each: the
    device's busy share of the wall time, device launches per UNet call or
    step, and the time by kernel and by op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from srs_tpu_torch.models.generative import (CondUNet, _ddim, _ema_update, _linspace,
                                                 ark_loss, sample_ark)
    from srs_tpu_torch.models.train import make_optimizer

    module = CondUNet(base=GEN["base"], depth=GEN["depth"])
    module.load_state_dict(_seeded_unet_state(torch, GEN["base"], GEN["depth"], seed=31))
    module = module.cuda()
    params = list(module.parameters())
    ema = [p.detach().clone() for p in params]
    opt = make_optimizer(params, 2e-4)
    gen = torch.Generator("cuda").manual_seed(0)
    size, b = GEN["size"], GEN["batch"]
    x0 = torch.rand((b, size, size, 3), generator=gen, device="cuda") * 2 - 1
    y = torch.randint(0, 9, (b,), generator=gen, device="cuda")
    t = torch.rand(b, generator=gen, device="cuda")
    eps = torch.randn(x0.shape, generator=gen, device="cuda")
    tiles = torch.rand((64, size, size, 3), generator=gen, device="cuda") * 2 - 1
    ts = _linspace(0.22, 0.0, 9, device=torch.device("cuda"))

    def train(n):
        module.requires_grad_(True).train()
        for _ in range(n):
            opt.zero_grad()
            ark_loss(module, x0, y, t, eps).backward()
            opt.step()
            _ema_update(ema, params, 0.999)

    def sample(n):
        module.eval().requires_grad_(False)
        for _ in range(n):
            sample_ark(module, 6, size=size, steps=50, guidance=2.625)

    def refine(n):
        module.eval().requires_grad_(False)
        with torch.no_grad():
            for _ in range(n):
                _ddim(module, tiles, 6, ts, 2.0)

    runs = {"train_step": (train, 10, 1), "sample_50_steps": (sample, 1, 50),
            "refine_chunk": (refine, 1, 8)}
    out = {}
    for name, (run, n, calls) in runs.items():
        run(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            run(n)
            torch.cuda.synchronize()
            wall = time.time() - t0
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name.startswith("Optimizer."):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
        busy_us = sum(hi - lo for lo, hi in busy_intervals(spans))
        ops = sorted(((e.key, self_dev_ms(e), e.count) for e in prof.key_averages()
                      if e.key.startswith("aten::") and self_dev_ms(e) > 0),
                     key=lambda r: -r[1])[:12]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        out[name] = {
            "runs": n, "wall_s": wall, "ms_per_run": wall / n * 1e3,
            "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
            "device_events_per_unet_call": len(spans) / n / calls,
            "top_device_ms": [[k[:120], round(ms, 3), c] for k, (ms, c) in top],
            "top_ops_self_device_ms": [[k, round(ms, 3), c] for k, ms, c in ops],
        }
    return out

def profile_main_path(torch, K, pipe, image, tmp: str) -> dict:
    """One more run of a path under torch.profiler: the device's busy share
    of the wall time, per pipeline stage and in all, and its time by kernel
    and by launching op; each K1/K2 launch's device time beside its shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tmp, "out_profiled.tiff")
    shapes = {"pyr_down": [], "pyr_up": []}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, recorded_shapes(K, shapes):
        t0 = time.time()
        res = pipe.process(image, path)
        wall = time.time() - t0
    if not res.success:
        fail(f"profiled process() failed: {res.error_message}")
    spans, by_name, windows = [], {}, {}
    launches = {"pyr_down": [], "pyr_up": []}  # (start, device ms) per launch
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("stage:"):  # the pipeline's ranges on the device timeline
            windows[e.name[6:]] = (e.time_range.start, e.time_range.end)
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for k, v in launches.items():
            if f"{k}_kernel" in e.name:
                v.append((e.time_range.start, e.time_range.elapsed_us() / 1e3))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = busy_intervals(spans)
    busy_us = sum(b - a for a, b in busy)
    stages = {
        name: {"window_ms": (w1 - w0) / 1e3,
               "busy_ms": sum(max(0, min(b, w1) - max(a, w0)) for a, b in busy) / 1e3}
        for name, (w0, w1) in windows.items()
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # K1/K2 in all, whether or not they are among the largest, and each
    # launch's device time in launch order (K1: levels 0-4).
    pyramid = {k: [sum(ms for _, ms in v), len(v)] for k, v in launches.items()}
    per_launch = {k: [[ms, *shapes[k][i]] if i < len(shapes[k]) else [ms]
                      for i, (_, ms) in enumerate(sorted(v))]
                  for k, v in launches.items()}

    ops = sorted(((e.key, self_dev_ms(e), e.count) for e in prof.key_averages()
                  if e.key.startswith("aten::") and self_dev_ms(e) > 0),
                 key=lambda t: -t[1])[:12]
    # In-place adds by input shapes: a [N, C, H, W] output beside a [C]
    # bias names the convolutions' bias add.
    adds = sorted(((str(e.input_shapes), self_dev_ms(e), e.count)
                   for e in prof.key_averages(group_by_input_shape=True)
                   if e.key == "aten::add_" and self_dev_ms(e) > 0),
                  key=lambda t: -t[1])[:6]
    return {
        "wall_s": wall,
        "stage_times": res.stage_times,
        "device_events": len(spans),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "stage_device": stages,
        "top_device_ms": [[name[:140], round(ms, 3), n] for name, (ms, n) in top],
        "pyramid_kernels_ms": pyramid,
        "pyramid_launch_ms": per_launch,
        "top_ops_self_device_ms": [[k, round(ms, 3), n] for k, ms, n in ops],
        "add_by_input_shapes": [[k[:200], round(ms, 3), n] for k, ms, n in adds],
    }


def main() -> int:
    t_start = time.time()
    want_profile = "--profile" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    try:
        import srs_tpu_torch.ops.cuda.pyramid as K
        from srs_tpu_torch.io import native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the root of "
              "a checkout", file=sys.stderr)
        return 2

    t0 = time.time()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", t0, nvidia_smi=smi, kind=kind, count=count,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(K.load_library), pool.submit(native.load_library)]
        for job in jobs:
            job.result()
    emit("build", t0, ptxas=ptxas_summary(K.load_library()._name + ".log"))

    tmp = tempfile.mkdtemp(prefix="srs_chip_smoke_")
    try:
        t0 = time.time()
        knums = check_kernels(torch, K)
        emit("kernels", t0, tolerance=KERNEL_ATOL, **knums)

        t0 = time.time()
        with store_masked(tmp):  # seeded edsr_m; selection finds no ledger
            emit("reference", t0, **reference_check(torch, tmp))

        image = synthetic_image(MAIN_H, MAIN_W, seed=7)
        t0 = time.time()
        main, main_pipe = main_path(torch, K, tmp, image)
        emit("main_path", t0, **main)

        t0 = time.time()
        bench, bench_pipe = bench_path(torch, K, tmp, image)
        emit("bench_path", t0, **bench)

        t0 = time.time()
        packaged = packaged_phase(torch, K, tmp, image, bench)
        emit("packaged", t0, **packaged)

        t0 = time.time()
        with store_masked(tmp):  # in this process: untrained nets with IBP
            cli = cli_path(torch, K, tmp, image)
        emit("cli_path", t0, **cli)

        t0 = time.time()
        emit("other_blends", t0, **other_blends(torch, tmp, image))

        t0 = time.time()
        with store_masked(tmp):  # untrained nets with IBP
            emit("blend_reference", t0, **blend_reference(torch, tmp))

        t0 = time.time()
        prov, prov_pipes = providers(torch, K, tmp, image,
                                     os.path.join(tmp, "out_main_path.tiff"))
        emit("providers", t0, **prov)

        t0 = time.time()
        emit("provider_reference", t0, **provider_reference(torch, tmp))

        t0 = time.time()
        job_nums = job_layer(torch, K, tmp, image, main_pipe,
                        os.path.join(tmp, "out_main_path.tiff"))
        emit("jobs", t0, **job_nums)

        t0 = time.time()
        zssr, _zssr_pipe = zssr_path(torch, K, tmp, image,
                                     os.path.join(tmp, "out_main_path.tiff"))
        emit("zssr", t0, **zssr)

        t0 = time.time()
        emit("train", t0, **train_phase(torch, tmp))

        t0 = time.time()
        emit("train_reference", t0, **train_reference(torch))

        t0 = time.time()
        lib = library(torch, K, tmp, image, bench_pipe, bench)
        emit("library", t0, **lib)

        t0 = time.time()
        emit("library_reference", t0, **library_reference(torch, tmp))

        t0 = time.time()
        sub = subcommands(torch, K, tmp)
        emit("subcommands", t0, **sub)

        t0 = time.time()
        emit("generate", t0, **generate_phase(torch, tmp))

        t0 = time.time()
        emit("generate_reference", t0, **generate_reference(torch))

        t0 = time.time()
        mesh = mesh_phase(torch, K, tmp, image, bench)
        emit("mesh", t0, **mesh)

        t0 = time.time()
        emit("mesh_reference", t0, **mesh_reference(torch, tmp))

        t0 = time.time()
        webui = webui_phase(torch, K, tmp, image)
        emit("webui", t0, **webui)

        t0 = time.time()
        with store_masked(tmp):  # untrained nets with IBP
            emit("webui_reference", t0, **webui_reference(torch, tmp))

        t0 = time.time()
        emit("sharded_train", t0, **sharded_train_phase(torch))

        t0 = time.time()
        emit("sharded_train_reference", t0, **sharded_train_reference(torch))

        t0 = time.time()
        dry = dryrun_phase(torch, K)
        emit("dryrun", t0, **dry)

        t0 = time.time()
        drv = drivers_phase(torch, K, tmp)
        emit("drivers", t0, **drv)

        t0 = time.time()
        with store_masked(tmp):  # the seeded nets each row names
            emit("drivers_reference", t0, **drivers_reference(torch, tmp))

        t0 = time.time()
        held = {"main_path": main["held_against_plain"], "zssr": zssr["held_against_plain"],
                "bench_path": bench["held_against_plain"],
                "packaged": packaged["held_against_plain"],
                "cli_path": cli["held_against_plain"],
                **{f"provider_{k}": v["held_against_plain"] for k, v in prov.items()},
                **{f"jobs_{k}": job_nums[k]["held_against_plain"] for k in JOB_CASES},
                "library": lib["held_against_plain"],
                "subcommands": sub["held_against_plain"],
                "mesh": mesh["held_against_plain"],
                "webui": webui["held_against_plain"], "dryrun": dry["held_against_plain"],
                "proof_200mp": drv["proof_200mp"]["held_against_plain"],
                "quality_bench": drv["quality_bench"]["held_against_plain"]}
        shapes = time_kernel_shapes(torch, K, held)
        emit("kernel_shapes", t0, **shapes)

        if want_profile:
            t0 = time.time()
            emit("profile", t0, **profile_main_path(torch, K, main_pipe, image, tmp))
            t0 = time.time()
            emit("profile_bench_path", t0,
                 **profile_main_path(torch, K, bench_pipe, image, tmp))
            t0 = time.time()
            emit("profile_fusion", t0,
                 **profile_main_path(torch, K, prov_pipes["fusion"], image, tmp))
            t0 = time.time()
            emit("profile_training", t0, **profile_training(torch, image))
            t0 = time.time()
            emit("profile_generation", t0, **profile_generation(torch))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, line in (("pyr_down", 71), ("pyr_up", 119)):
        d = knums[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "srs_tpu_torch/csrc/pyramid.cu",
            "replaces": f"srs_tpu/ops/pallas/pyramid_pallas.py:{line}",
            # the system's main path: bench.py:69-83's configuration with
            # nothing handed in, serving the store's trained nets
            "launches": packaged["launches"][name],
            "launches_by_path": {"packaged": packaged["launches"][name],
                                 "bench_path": bench["launches"][name],
                                 "main_path": main["launches"][name],
                                 "cli_path": cli["launches"][name],
                                 "zssr": zssr["launches"][name],
                                 **{f"provider_{k}": v["launches"][name]
                                    for k, v in prov.items()},
                                 **{f"jobs_{k}": job_nums[k]["launches"][name] for k in JOB_CASES},
                                 "library": lib["launches"][name],
                                 "subcommands": sub["launches"][name],
                                 "mesh": mesh["launches"][name],
                                 "webui": webui["launches"][name],
                                 "dryrun": dry["launches"][name],
                                 "proof_200mp": drv["proof_200mp"]["launches"][name],
                                 "quality_bench": drv["quality_bench"]["launches"][name]},
            "max_abs_err": max(d["max_abs_err"],
                               *(h[name]["max_abs_err"] for h in held.values())),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "shapes": [{k: r[k] for k in ("in", "out", "launches", "ms", "bound_ms",
                                          "pct_of_bound")} for r in shapes[name]],
        })
    emit("done", t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
