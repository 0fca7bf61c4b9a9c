"""Quantitative eval of the ARK conditional generator (port of
``scripts/eval_ark.py``): does the class conditioning steer the sampled
distribution?

1. Per-class feature centroids of REAL renders (``render_class``) from
   simple image statistics (colour moments, gradient energy, radial
   spectral bands, histogram entropy), z-scored over the real pool.
2. K samples per class from the trained generator (DDIM, guidance).
3. Class accuracy: the share of samples whose nearest centroid is their
   class (chance 1/8); and the within-class diversity of the samples
   against the real renders' (mode collapse).

    python -m srs_tpu_torch.drivers.eval_ark [--k 8] [--real-n 24]
        [--steps 50] [--guidance 2.0] [--checkpoint-dir DIR] [--size S]
        [--cpu] [--no-write]

Reads ``ark_gen_x1.pt`` from ``--checkpoint-dir`` (default
``~/.cache/srs_tpu_torch/models``) and records the numbers under
``ark_gen_x1`` in the EVAL.json there. ``main`` returns the report;
``ok`` is false, and the command exits 1, without a trained generator.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of


def features(img: np.ndarray) -> np.ndarray:
    """13 statistics of a [S, S, 3] float image in [0, 255]."""
    g = img.mean(-1)
    gy, gx = np.gradient(g)
    gm = np.hypot(gx, gy)
    f = np.fft.rfft2(g - g.mean())
    p = np.abs(f) ** 2
    h, w = p.shape
    yy = np.minimum(np.arange(h), h - np.arange(h))[:, None] / (h / 2)
    xx = (np.arange(w) / w)[None, :]
    r = np.hypot(yy, xx)
    bands = [np.log1p(p[(r >= lo) & (r < hi)].mean() + 1e-9)
             for lo, hi in ((0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 2.0))]
    hist, _ = np.histogram(g, 32, (0, 255))
    q = hist / max(hist.sum(), 1)
    ent = -(q[q > 0] * np.log(q[q > 0])).sum()
    return np.array([*img.mean((0, 1)), *img.std((0, 1)), gm.mean(), gm.std(), *bands, ent],
                    np.float64)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.eval_ark")
    ap.add_argument("--k", type=int, default=8, help="samples per class")
    ap.add_argument("--real-n", type=int, default=24, help="real renders per class")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance", type=float, default=2.0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--size", type=int, default=None,
                    help="sample size (default: the checkpoint's trained size, ark_meta.json)")
    add_device_args(ap)
    ap.add_argument("--no-write", action="store_true")
    args = ap.parse_args(argv)

    from ..models.generative import (ARK_CLASSES, ark_meta, build_ark, is_ark_trained,
                                     render_class, sample_ark)

    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    if not is_ark_trained(ckdir):
        # never a fallback: an old model must not be graded after a failed train
        print(f"no ark_gen_x1.pt in {ckdir}", file=sys.stderr)
        return {"ok": False}
    module, _params, _trained = build_ark(ckdir, device=device)
    size = args.size or ark_meta(ckdir)["size"]
    print(f"eval at {size}px (native trained size)")

    ncls = len(ARK_CLASSES)
    real = np.stack([features(render_class(1000 + i, c, size))
                     for c in range(ncls) for i in range(args.real_n)]
                    ).reshape(ncls, args.real_n, -1)
    mu = real.reshape(-1, real.shape[-1]).mean(0)
    sd = real.reshape(-1, real.shape[-1]).std(0) + 1e-9
    realz = (real - mu) / sd
    cent = realz.mean(1)  # [ncls, D]

    def spread(z) -> float:
        return float(np.mean([np.linalg.norm(a - b) for i, a in enumerate(z) for b in z[i + 1:]]))

    correct, div_s, div_r, per_class = 0, [], [], {}
    for c in range(ncls):
        s = sample_ark(module, c, seed=7000 + c, size=size, steps=args.steps,
                       guidance=args.guidance, batch=args.k).float().cpu().numpy()
        fz = (np.stack([features(x) for x in s]) - mu) / sd
        pred = np.argmin(((fz[:, None] - cent[None]) ** 2).sum(-1), axis=1)
        hits = int((pred == c).sum())
        correct += hits
        div_s.append(spread(fz))
        div_r.append(spread(realz[c][: args.k]))
        per_class[ARK_CLASSES[c]] = hits
        print(f"{ARK_CLASSES[c]:9s} acc {hits}/{args.k}  "
              f"diversity {div_s[-1]:.2f} (real {div_r[-1]:.2f})")
    acc = correct / (ncls * args.k)
    div_ratio = float(np.mean(div_s) / max(np.mean(div_r), 1e-9))
    print(f"class accuracy {acc:.3f} (chance {1 / ncls:.3f}); "
          f"within-class diversity ratio vs real {div_ratio:.2f}")
    fields = {"class_accuracy": acc, "chance": 1 / ncls, "diversity_ratio_vs_real": div_ratio,
              "eval_k": args.k, "eval_steps": args.steps, "eval_guidance": args.guidance,
              "eval_size": size}
    if not args.no_write:
        from ..models.evaljson import update_eval

        update_eval(ckdir, "ark_gen_x1", fields)
        print("EVAL.json updated")
    return {"ok": True, "hits_per_class": per_class, **fields}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
