"""Generated-image naturalness: calibrated NIQE of ARK 2K samples (port of
``scripts/gen_quality.py``).

1. A 2K sample per prompt (the learned backend; ``--refine`` scores the
   SDEdit-refined variant too).
2. Calibrated NIQE on random 512-px crops of each image.
3. The reference row: the held-out real portrait's NIQE on the same scale.

    python -m srs_tpu_torch.drivers.gen_quality [--prompts a,b] [--refine]
        [--crops 4] [--steps 50] [--size 2K] [--cpu] [--no-write]
        [--checkpoint-dir DIR]

Reads the generator (and SR nets) from ``--checkpoint-dir`` (default
``~/.cache/srs_tpu_torch/models``) and records ``gen2k_niqe[_refined]``
under ``ark_gen_x1`` in the EVAL.json there. The portrait needs
matplotlib and PIL (``PhotoDataMissing`` without them). ``main`` returns
the report.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of

PROMPTS = [
    "misty mountain landscape photo",
    "product shot of a leather bag",
    "woven fabric texture",
    "studio gradient with glossy highlights",
]


def niqe_of(img: np.ndarray, crops: int, rng: np.random.Generator,
            device: str = "cpu") -> Optional[float]:
    """Mean calibrated NIQE of ``crops`` random squares (512 px, or the
    image's short side) of ``img``."""
    import torch

    from ..qa.niqe import niqe_scores

    h, w = img.shape[:2]
    side = min(512, h, w)
    vals = []
    for _ in range(crops):
        y = int(rng.integers(0, h - side + 1))
        x = int(rng.integers(0, w - side + 1))
        crop = torch.from_numpy(np.ascontiguousarray(img[y:y + side, x:x + side], np.float32))
        v = niqe_scores(crop[None].to(device))
        if v and v[0] is not None:
            vals.append(float(v[0]))
    return float(np.mean(vals)) if vals else None


def portrait() -> np.ndarray:
    """The held-out real portrait, whole (``PhotoDataMissing`` without
    matplotlib or PIL)."""
    from ..io.image import load_image
    from ..models.photo_data import PhotoDataMissing, _package_dir, missing_packages
    from .photo_eval import PORTRAIT

    missing = missing_packages([PORTRAIT])
    if missing:
        raise PhotoDataMissing(f"the real-photo reference row (the portrait): "
                               f"{', '.join(missing)} not installed")
    return load_image(os.path.join(_package_dir(PORTRAIT[0]), PORTRAIT[1]))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.gen_quality")
    ap.add_argument("--prompts", default=None)
    ap.add_argument("--refine", action="store_true",
                    help="also score the SDEdit-refined variant (A/B)")
    ap.add_argument("--crops", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", default="2K")
    add_device_args(ap)
    ap.add_argument("--no-write", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    from ..models.generate import ARKImageConfig, ARKImageGenerator

    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    prompts = args.prompts.split(",") if args.prompts else PROMPTS
    real = portrait()  # fail before minutes of sampling
    rng = np.random.default_rng(11)
    gen = ARKImageGenerator(checkpoint_dir=ckdir, device=device)

    def run(refine: bool):
        vals = []
        for p in prompts:
            cfg = ARKImageConfig(size=args.size, seed=1234,
                                 extra={"steps": args.steps, **({"refine": True} if refine
                                                                else {})})
            r = gen.generate(p, cfg)
            if r.metadata.get("model") == "procedural-v1":
                raise RuntimeError("learned backend unavailable")
            v = niqe_of(np.asarray(r.image, np.float32), args.crops, rng, device)
            print(f"{'refined ' if refine else ''}{p!r}: niqe {v and round(v, 2)}"
                  f" (base {r.metadata.get('base_size')},"
                  f" ladder {r.metadata.get('sr_ladder')})", flush=True)
            if v is not None:
                vals.append(v)
        return float(np.mean(vals)) if vals else None

    base_niqe = run(False)
    refined_niqe = run(True) if args.refine else None
    real_niqe = niqe_of(real, min(args.crops, 2), rng, device)
    out = {"gen2k_niqe": base_niqe, "real_photo_niqe": real_niqe,
           "gen2k_prompts": len(prompts), "gen2k_crops": args.crops}
    if refined_niqe is not None:
        out["gen2k_niqe_refined"] = refined_niqe
    print(json.dumps(out))
    if not args.no_write:
        from ..models.evaljson import update_eval

        update_eval(ckdir, "ark_gen_x1", {k: v for k, v in out.items() if v is not None})
        print("EVAL.json updated")
    return out


if __name__ == "__main__":
    main()
