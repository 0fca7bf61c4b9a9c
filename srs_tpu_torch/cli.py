"""Command-line interface (port of the ``process`` and ``train``
subcommands of ``srs_tpu/cli.py:17-64,84-106,203-283``).

    python -m srs_tpu_torch process in.png out.tiff [--target 100MP] [...]
    python -m srs_tpu_torch train --synthetic [--model espcn --scale 2 ...]
    python -m srs_tpu_torch train hr1.png hr2.png [...]

They take the reference's flags. ``--device`` (``cuda`` by default,
``cpu`` for the plain PyTorch versions) is the port's own, and so is
``process --checkpoint-dir``. ``train`` saves the net's state dict to
``{checkpoint dir}/{model}_x{scale}.pt``; ``process`` counts the nets
saved in its checkpoint directory as trained. Both default to
``~/.cache/srs_tpu_torch/models``. ``--checkpoint`` keeps the upscaled
tiles in the port's tile store (``~/.cache/srs_tpu_torch/tiling``) and
resumes a re-run of the same job from them. Flags whose feature is not
ported (``--mesh``, ``--profile``) exit with code 2 and say which ROADMAP
item holds it. The other subcommands of the reference (bench, warmup,
webui, generate, info) are not ported (ROADMAP Queue 1: items 4, 5 and 7).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

# Flags of the reference whose feature the port has not yet: (the
# attribute, the value that means "not asked for", what holds it).
_UNPORTED_FLAGS = (
    ("mesh", None, "--mesh: the parallel/ mesh (ROADMAP Queue 1, item 6: parallel/ on "
                   "torch.distributed)"),
    ("profile", None, "--profile: the device trace (ROADMAP Queue 1, item 4: the other "
                      "subcommands and the device trace)"),
)


def _cmd_process(args: argparse.Namespace) -> int:
    for attr, default, what in _UNPORTED_FLAGS:
        if getattr(args, attr) != default:
            print(f"NotImplementedError: {what} is not ported yet", file=sys.stderr)
            return 2
    from .pipeline import PipelineConfig, SuperResolutionPipeline

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
        )
    except NotImplementedError as e:
        print(f"NotImplementedError: {e}", file=sys.stderr)
        return 2
    result = SuperResolutionPipeline(cfg).process(args.input, args.output, prompt=args.prompt)
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


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; needs a card) or cpu (the plain PyTorch versions)")


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
    pp.add_argument("--mesh", default=None, help="device mesh (not ported)")
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
    pp.add_argument("--profile", default=None, metavar="DIR", help="device trace (not ported)")
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
