"""Command-line interface (port of ``srs_tpu/cli.py``).

    python -m srs_tpu_torch process in.png out.tiff [--target 100MP] [...]
    python -m srs_tpu_torch process in.png out.tiff --profile trace_dir
    python -m srs_tpu_torch train --synthetic [--model espcn --scale 2 ...]
    python -m srs_tpu_torch train hr1.png hr2.png [...]
    python -m srs_tpu_torch generate "a text poster" out.png [--size 2K ...]
    python -m srs_tpu_torch bench
    python -m srs_tpu_torch warmup [--source 1280x720 --target 100MP ...]
    python -m srs_tpu_torch info [--config]
    python -m srs_tpu_torch webui [--port 8501]

They take the reference's flags. ``--device`` (``cuda`` by default,
``cpu`` for the plain PyTorch versions) is the port's own, and so is
``--checkpoint-dir`` on ``process``, ``generate``, ``warmup`` and
``info``. ``train`` saves the net's state dict to ``{checkpoint
dir}/{model}_x{scale}.pt``; ``process`` counts the nets saved in its
checkpoint directory as trained, and ``generate`` reads the generator
there (``ark_gen_x1.pt``, as ``models/generative.train_ark`` saves it).
All default to ``~/.cache/srs_tpu_torch/models``. ``--checkpoint``
keeps the upscaled tiles in the port's tile store
(``~/.cache/srs_tpu_torch/tiling``) and resumes a re-run of the same job
from them. ``--profile DIR`` writes a ``torch.profiler`` trace of the
job into DIR (``utils/profiling.device_trace``). ``bench`` is
``srs_tpu_torch/bench.py`` (its row goes to
``~/.cache/srs_tpu_torch/BENCH_LOCAL.md``). ``--mesh data=4,space=2``
runs ``process`` on a device mesh (``parallel/``): over the CUDA devices
torch sees, where a mesh that needs more of them raises ``ValueError`` as
in the reference, or with ``--device cpu`` over the CPU repeated to the
mesh's size. ``webui`` starts the Streamlit app (``webui/app.py``) and
exits non-zero with a message where Streamlit is not installed.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

def _cmd_process(args: argparse.Namespace) -> int:
    from .pipeline import PipelineConfig, SuperResolutionPipeline

    mesh_shape = None
    if args.mesh:
        # "data=4,space=2" -> {"data": 4, "space": 2}
        mesh_shape = {
            k.strip(): int(v)
            for k, v in (part.split("=") for part in args.mesh.split(","))
        }
    try:
        cfg = PipelineConfig(
            block_size=args.block_size,
            overlap_ratio=args.overlap,
            target_resolution=args.target,
            provider=args.provider,
            quality_model=args.quality_model,
            blend_method=args.blend,
            enable_qa=not args.no_qa,
            ibp_steps=args.steps,
            bit_depth=args.bit_depth,
            enable_seam_repair=args.seam_repair,
            enable_color_correction=args.color_correction,
            content_aware=args.content_aware,
            per_scale_selection=not args.pin_quality_model,
            self_ensemble=args.self_ensemble,
            enable_checkpoint=args.checkpoint,
            zssr_steps=args.zssr_steps,
            checkpoint_dir=os.path.expanduser(args.checkpoint_dir),
            device=args.device,
            mesh_shape=mesh_shape,
        )
    except NotImplementedError as e:
        print(f"NotImplementedError: {e}", file=sys.stderr)
        return 2
    pipe = SuperResolutionPipeline(cfg)
    if args.profile:
        from .utils.profiling import device_trace

        with device_trace(args.profile):
            result = pipe.process(args.input, args.output, prompt=args.prompt)
        print(f"profiler trace written to {args.profile} (a Chrome trace: Perfetto, "
              "chrome://tracing or TensorBoard)")
    else:
        result = pipe.process(args.input, args.output, prompt=args.prompt)
    if result.success:
        print(f"OK {result.output_path} ({result.processing_time:.1f}s, "
              f"{result.total_blocks} tiles)")
        if result.quality_score is not None:
            print(f"quality score: {result.quality_score:.1f}/100")
        for k, v in result.stage_times.items():
            print(f"  {k}: {v:.2f}s")
        return 0
    print(f"FAILED: {result.error_message}", file=sys.stderr)
    return 1


def _cmd_train(args: argparse.Namespace) -> int:
    from .models.train import train_from_images, train_synthetic

    common = dict(steps=args.steps, patch=args.patch, batch=args.batch, lr=args.lr,
                  checkpoint_dir=os.path.expanduser(args.checkpoint_dir), device=args.device)
    if args.synthetic:
        _, loss = train_synthetic(args.model, args.scale, corpus_n=args.corpus_n, **common)
    elif args.images:
        _, loss = train_from_images(args.images, args.model, args.scale, **common)
    else:
        print("provide HR image files or --synthetic", file=sys.stderr)
        return 2
    print(f"trained {args.model} x{args.scale}: final loss {loss:.4f}; "
          f"checkpoint in {args.checkpoint_dir}")
    return 0


def _cmd_bench(args: argparse.Namespace) -> int:
    from .bench import main as bench_main

    return bench_main()


def _cmd_warmup(args: argparse.Namespace) -> int:
    """Build the CUDA kernels and the TIFF writer into ``_build/`` and run
    one job of the configuration, so that the next job starts warm (the
    reference fills its XLA compile cache here; the port has none)."""
    import tempfile
    import time

    import numpy as np

    from .pipeline import PipelineConfig, SuperResolutionPipeline

    w, h = map(int, args.source.lower().split("x"))
    rng = np.random.default_rng(0)
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    cfg = PipelineConfig(
        block_size=args.block_size,
        target_resolution=args.target,
        provider=args.provider,
        quality_model=args.quality_model,
        bit_depth=args.bit_depth,
        enable_qa=True,
        checkpoint_dir=os.path.expanduser(args.checkpoint_dir),
        device=args.device,
    )
    t0 = time.time()
    pipe = SuperResolutionPipeline(cfg)  # raises here when device="cuda" finds no card
    built = ""
    if args.device == "cuda":
        from .io import native
        from .ops.cuda import pyramid
        from .utils.build import build_dir

        pyramid.load_library()
        native.load_library()
        built = f"; the CUDA kernels and the TIFF writer are built in {build_dir()}"
    with tempfile.TemporaryDirectory() as td:
        r = pipe.process(img, os.path.join(td, "warmup.tiff"))
    if not r.success:
        print(f"warmup FAILED: {r.error_message}", file=sys.stderr)
        return 1
    print(f"warmed {args.source} -> {args.target} ({args.provider}/"
          f"{args.quality_model}, block {args.block_size}, {args.bit_depth}-bit) "
          f"on {args.device} in {time.time() - t0:.1f}s{built}, so the next job starts warm")
    return 0


def _cmd_generate(args: argparse.Namespace) -> int:
    """Text-to-image through the learned generator (``ark_gen_x1.pt`` in
    ``--checkpoint-dir``), or the procedural synthesizer when none is
    trained there."""
    import numpy as np

    from .models.generate import ARKImageConfig, ARKImageGenerator

    cfg = ARKImageConfig(
        size=args.size,
        watermark=args.watermark,
        seed=args.seed,
        guidance_scale=args.guidance,
        extra={"steps": args.steps,
               **({"category": args.category} if args.category else {})},
    )
    gen = ARKImageGenerator(checkpoint_dir=args.checkpoint_dir, device=args.device)
    r = gen.generate(args.prompt, cfg)
    if args.output.lower().endswith(".png"):
        from .io.image import save_image

        save_image(args.output, r.image.astype(np.uint8))
    else:  # as the reference without PIL: the float32 array
        np.save(args.output, r.image)
    print(f"OK {args.output} {r.size[0]}x{r.size[1]} "
          f"({r.metadata.get('model')}, class={r.metadata.get('class', '-')}, "
          f"seed={r.seed}, {r.processing_time:.1f}s)")
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    """The reference's keys: ``backend`` is "cuda" or "cpu", ``devices``
    the torch device names, and a net's ``trained_scales`` the scales of
    its ``.pt`` state dicts in the store (as the reference lists its
    packaged ones) and under ``--checkpoint-dir``."""
    import json
    import re

    import torch

    from . import __version__
    from .config import SystemConfig
    from .models.registry import MODEL_REGISTRY, store_manifest

    ckpt = os.path.expanduser(args.checkpoint_dir)
    saved = [*store_manifest(), *(os.listdir(ckpt) if os.path.isdir(ckpt) else [])]
    models = {}
    for name, spec in MODEL_REGISTRY.items():
        trained = sorted({int(m[2]) for m in (re.fullmatch(r"(.+)_x(\d+)\.pt", f) for f in saved)
                          if m is not None and m[1] == name})
        models[name] = {
            "description": spec.description,
            "trained_scales": trained or "untrained (bicubic floor + IBP)",
        }
    cuda = torch.cuda.is_available()
    info = {
        "version": __version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "models": models,
        "config": SystemConfig.from_env().to_dict() if args.config else "use --config",
    }
    print(json.dumps(info, indent=2, default=str))
    return 0


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; needs a card) or cpu (the plain PyTorch versions)")


def _cmd_webui(args: argparse.Namespace) -> int:
    """``streamlit run webui/app.py`` (reference cli.py:74-80)."""
    import importlib.util
    import subprocess

    if importlib.util.find_spec("streamlit") is None:
        print("webui: Streamlit is not installed; the web UI needs it "
              "(pip install streamlit)", file=sys.stderr)
        return 1
    from .webui import app

    return subprocess.call([sys.executable, "-m", "streamlit", "run", app.__file__,
                            "--server.port", str(args.port)])


def build_parser() -> argparse.ArgumentParser:
    from .models.train import DEFAULT_CHECKPOINT_DIR

    p = argparse.ArgumentParser(prog="srs-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("process", help="super-resolve an image")
    pp.add_argument("input")
    pp.add_argument("output")
    pp.add_argument("--target", default="100MP", help="100MP|150MP|200MP|WxH")
    pp.add_argument("--block-size", type=int, default=512)
    pp.add_argument("--overlap", type=float, default=0.2)
    pp.add_argument("--provider", default="quality",
                    choices=["quality", "fast", "hybrid", "bicubic", "zssr", "fusion"])
    pp.add_argument("--blend", default="laplacian",
                    choices=["laplacian", "multi_band", "weighted", "feather",
                             "gradient_domain", "poisson"])
    pp.add_argument("--quality-model", default="edsr_xl",
                    choices=["edsr_m", "edsr_l", "edsr_xl", "edsr_l_robust", "rcan", "espcn"],
                    help="registry net for the quality tier (the fallback when per-scale "
                         "selection has no panel evidence)")
    pp.add_argument("--pin-quality-model", action="store_true",
                    help="disable per-scale panel-best selection and serve --quality-model "
                         "for every ladder step")
    pp.add_argument("--steps", type=int, default=8, help="back-projection steps")
    pp.add_argument("--zssr-steps", type=int, default=150,
                    help="self-supervised fine-tune steps for --provider zssr")
    pp.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                    help="directory of trained nets ({model}_x{scale}.pt, as train saves "
                         "them) and of EVAL.json / FUSION.json")
    pp.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=4,space=2: the cards torch sees (a mesh "
                         "larger than that fails), or with --device cpu the CPU repeated")
    pp.add_argument("--bit-depth", type=int, default=8, choices=[8, 16],
                    help="output bit depth (16 requires TIFF output)")
    pp.add_argument("--seam-repair", action="store_true",
                    help="post-blend seam detection and repair pass")
    pp.add_argument("--color-correction", action="store_true",
                    help="histogram-match output colors to the source")
    pp.add_argument("--checkpoint", action="store_true",
                    help="persist upscaled tiles in the tile store and resume a killed job "
                         "from them")
    pp.add_argument("--content-aware", action="store_true",
                    help="seam placement avoids faces/text/salient regions")
    pp.add_argument("--self-ensemble", action="store_true",
                    help="average the net over the 8 dihedral tile transforms (EDSR '+', "
                         "8x SR compute)")
    pp.add_argument("--prompt", default=None,
                    help="prompt text; a template category name (beauty, 3c, food, ...) "
                         "steers the conditioned polish")
    pp.add_argument("--no-qa", action="store_true")
    pp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (CPU ops, and the card's kernels) "
                         "into DIR")
    _add_device(pp)
    pp.set_defaults(fn=_cmd_process)

    pt = sub.add_parser("train", help="train an SR model on HR images")
    pt.add_argument("images", nargs="*", help="HR image files")
    pt.add_argument("--synthetic", action="store_true",
                    help="train on the procedural corpus (no images needed)")
    pt.add_argument("--corpus-n", type=int, default=256,
                    help="procedural corpus size for --synthetic")
    pt.add_argument("--model", default="espcn", help="registry model name")
    pt.add_argument("--scale", type=int, default=2)
    pt.add_argument("--steps", type=int, default=2000)
    pt.add_argument("--patch", type=int, default=48)
    pt.add_argument("--batch", type=int, default=32)
    pt.add_argument("--lr", type=float, default=2e-4)
    pt.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                    help=f"where {{model}}_x{{scale}}.pt goes (default {DEFAULT_CHECKPOINT_DIR})")
    _add_device(pt)
    pt.set_defaults(fn=_cmd_train)

    pb = sub.add_parser("bench", help="run the 720p->100MP benchmark (srs_tpu_torch/bench.py)")
    pb.set_defaults(fn=_cmd_bench)

    pwu = sub.add_parser("warmup", help="build the kernels and run one job of a configuration")
    pwu.add_argument("--source", default="1280x720", help="input WxH")
    pwu.add_argument("--target", default="100MP")
    pwu.add_argument("--block-size", type=int, default=512)
    pwu.add_argument("--provider", default="quality")
    pwu.add_argument("--quality-model", default="edsr_xl")
    pwu.add_argument("--bit-depth", type=int, default=8, choices=[8, 16])
    pwu.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                     help="directory of trained nets, as for process")
    _add_device(pwu)
    pwu.set_defaults(fn=_cmd_warmup)

    pw = sub.add_parser("webui", help="launch the Streamlit UI (needs Streamlit)")
    pw.add_argument("--port", type=int, default=8501)
    pw.set_defaults(fn=_cmd_webui)

    pg = sub.add_parser("generate", help="text-to-image (the learned generator)")
    pg.add_argument("prompt")
    pg.add_argument("output", help=".png, or anything else for the float32 array (np.save)")
    pg.add_argument("--size", default="2K", help="1K|2K|4K|WxH")
    pg.add_argument("--seed", type=int, default=None)
    pg.add_argument("--guidance", type=float, default=7.5,
                    help="classifier-free guidance (reference-scale default)")
    pg.add_argument("--steps", type=int, default=50, help="DDIM steps")
    pg.add_argument("--category", default=None,
                    help="industry template category conditioning the class")
    pg.add_argument("--watermark", action="store_true")
    pg.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                    help="where ark_gen_x1.pt (and trained SR nets) are read")
    _add_device(pg)
    pg.set_defaults(fn=_cmd_generate)

    pi = sub.add_parser("info", help="environment and config info")
    pi.add_argument("--config", action="store_true")
    pi.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                    help="where trained nets ({model}_x{scale}.pt) are counted")
    pi.set_defaults(fn=_cmd_info)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
