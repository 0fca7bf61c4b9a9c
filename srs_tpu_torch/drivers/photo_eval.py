"""The held-out REAL-PHOTOGRAPH eval panel, the generalization oracle (port
of ``scripts/photo_eval.py``).

Every quality number in EVAL.json and ``quality_bench`` lives on the
procedural corpus; this scores the nets on real photographs that no
training or fitting path reads (``models/photo_data.py``): matplotlib's
portrait and the three ``EVAL_HOLDOUT_SOURCES`` (a macro flower, two wood
textures), centre-cropped to one 420x504 shape and degraded with the
corpus protocol (cv2 INTER_AREA). Per net: the per-image delta against
bicubic, and the panel mean, min and max.

    python -m srs_tpu_torch.drivers.photo_eval [--cpu] [--scale 2]
        [--models a,b,c] [--images portrait,flower,wood,darkwood]
        [--checkpoint-dir DIR] [--write-eval]

Prints one JSON line per net plus a summary table; ``main`` returns the
rows. Nets are read from ``--checkpoint-dir`` (default
``~/.cache/srs_tpu_torch/models``), where ``--write-eval`` also merges the
``photo_panel`` blocks into EVAL.json. The panel needs matplotlib, PIL,
sklearn and gymnasium_robotics; without one of them :func:`load_panel`
raises ``PhotoDataMissing`` naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, load_net, out_dir_of, psnr, trained_params

# matplotlib's sample portrait, a strict holdout (tests/test_photo_holdout.py)
PORTRAIT = ("matplotlib", "mpl-data/sample_data/grace_hopper.jpg")

# Common eval shape: fits the smallest panel image (flower, 427x640) with
# h, w multiples of 12 (divisible by every eval scale 2/3/4).
PANEL_H, PANEL_W = 420, 504


def _center_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    y, x = max((ih - h) // 2, 0), max((iw - w) // 2, 0)
    return img[y : y + h, x : x + w]


def _tag_of(path: str) -> str:
    base = os.path.basename(path).lower()
    return ("flower" if "flower" in base
            else "darkwood" if "darkwood" in base
            else "wood" if "wood" in base else os.path.splitext(base)[0])


def load_panel(names=None) -> List:
    """[(name, HR 420x504x3 float32)], the 4-image held-out panel (or the
    images ``names`` picks, in panel order). Raises ``PhotoDataMissing``
    naming the packages when a picked image is not installed: the panel is
    never silently shorter."""
    from ..io.image import load_image
    from ..models.photo_data import (EVAL_HOLDOUT_SOURCES, PhotoDataMissing,
                                     _package_dir, missing_packages)

    sources = [("portrait", PORTRAIT)] + [(_tag_of(rel), (pkg, rel))
                                          for pkg, rel in EVAL_HOLDOUT_SOURCES]
    wanted = [(tag, src) for tag, src in sources if not names or tag in names]
    missing = missing_packages([src for _, src in wanted])
    if missing:
        raise PhotoDataMissing(
            f"the held-out photo panel ({', '.join(t for t, _ in wanted)}): "
            f"{', '.join(missing)} not installed")
    out = []
    for tag, (pkg, rel) in wanted:
        img = load_image(os.path.join(_package_dir(pkg), rel))
        out.append((tag, np.ascontiguousarray(_center_crop(img, PANEL_H, PANEL_W), np.float32)))
    return out


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.photo_eval")
    add_device_args(ap)
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--models", type=str, default="espcn,edsr_m,rcan,edsr_l,edsr_l_robust")
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--zssr-steps", type=int, default=150)
    ap.add_argument("--images", type=str, default=None,
                    help="comma-set of panel image names (portrait,flower,wood,darkwood); "
                    "default all")
    ap.add_argument("--degrade", choices=["none", "noise", "blur"], default="none",
                    help="damage the LR input like real capture defects (the degradation "
                    "router's triggers)")
    ap.add_argument("--write-eval", action="store_true",
                    help="record per-net photo_panel blocks into EVAL.json in the "
                    "checkpoint directory (requires the full default panel)")
    args = ap.parse_args(argv)

    import torch

    from ..models.corpus import _cv2
    from ..models.nets import back_project
    from ..models.registry import build_model
    from ..models.sr_module import _dihedral_ensemble
    from ..ops.resize import resize_bicubic_up

    cv2 = _cv2()
    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    s = args.scale
    names = set(args.images.split(",")) if args.images else None
    panel = load_panel(names)
    if not panel:
        raise ValueError(f"no panel images match {args.images!r}")

    lrs, bases = {}, {}
    for tag, hr in panel:
        lr = cv2.resize(hr, (hr.shape[1] // s, hr.shape[0] // s), interpolation=cv2.INTER_AREA)
        if args.degrade == "noise":  # sensor-noise level that trips the router
            lr = np.clip(lr + np.random.default_rng(0).normal(0, 6, lr.shape), 0, 255
                         ).astype(np.float32)
        elif args.degrade == "blur":
            lr = cv2.GaussianBlur(lr, (0, 0), 1.2)
        lrs[tag] = torch.from_numpy(np.asarray(lr, np.float32))[None].to(device)
        bases[tag] = psnr(np.clip(resize_bicubic_up(lrs[tag], s)[0].cpu().numpy(), 0, 255), hr)

    rows: List[Dict[str, Any]] = [{
        "model": "bicubic", "mean_delta": 0.0,
        "per_image": {t: {"psnr": round(b, 3), "delta": 0.0} for t, b in bases.items()},
    }]
    print(json.dumps(rows[0]), flush=True)

    @torch.no_grad()
    def apply_row(name: str, lr_b):
        """One provider row on one LR input -> (out batch, trained)."""
        ibp = name.endswith(":ibp")
        stem = name[: -len(":ibp")] if ibp else name
        ensemble = stem.endswith("+")  # "edsr_l+" = geometric self-ensemble
        bare = stem[:-1] if ensemble else stem
        if bare == "fusion":
            from ..models.fusion import load_fusion

            loaded = load_fusion(s, ckdir)
            if loaded is None:
                return None, False
            out_b = None
            for m, w in zip(*loaded):
                m_ens = ensemble or m.endswith("+")
                bare_m = m.rstrip("+")
                if bare_m == "bicubic":
                    y = resize_bicubic_up(lr_b, s)
                else:
                    net, _ = load_net(bare_m, s, ckdir, device)
                    y = _dihedral_ensemble(net, lr_b) if m_ens else net(lr_b)
                out_b = y * w if out_b is None else out_b + y * w
            trained = True
        elif bare == "zssr":
            # the per-image adaptation ceiling: the quality prior tuned on
            # the LR input itself (never on the HR truth)
            from ..models.train import zssr_finetune

            prior = next((m for m in ("edsr_xl", "edsr_l")
                          if trained_params(m, s, ckdir) is not None), "espcn")
            net, _ = build_model(prior, s, trained_params(prior, s, ckdir), device=device,
                                 master_weights=True)
            tuned = zssr_finetune(net, lr_b[0], scale=s, steps=args.zssr_steps, lr=1e-4)
            out_b = _dihedral_ensemble(tuned, lr_b) if ensemble else tuned(lr_b)
            trained = True
        else:
            net, trained = load_net(bare, s, ckdir, device)
            out_b = _dihedral_ensemble(net, lr_b) if ensemble else net(lr_b)
        if ibp:
            out_b = back_project(out_b, lr_b, s, steps=8, degradation="area")
        return out_b, trained

    for name in args.models.split(","):
        name = name.strip()
        if not name:
            continue
        per_image, trained, skipped = {}, False, None
        for tag, hr in panel:
            out_b, trained = apply_row(name, lrs[tag])
            if out_b is None:
                skipped = "no FUSION.json"
                break
            p = psnr(np.clip(out_b[0].float().cpu().numpy(), 0, 255), hr)
            per_image[tag] = {"psnr": round(p, 3), "delta": round(p - bases[tag], 3)}
        if skipped:
            print(json.dumps({"model": name, "skipped": skipped}), flush=True)
            continue
        deltas = [v["delta"] for v in per_image.values()]
        row = {
            "model": name,
            "mean_delta": round(float(np.mean(deltas)), 3),
            "min_delta": round(float(np.min(deltas)), 3),
            "max_delta": round(float(np.max(deltas)), 3),
            "per_image": per_image,
            "trained": bool(trained),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

        if args.write_eval and names is None and ":ibp" not in name:
            from ..models.evaljson import update_eval

            ens = name.endswith("+")
            bare = name[:-1] if ens else name
            field = "photo_panel" + ("_ensemble" if ens else "")
            if args.degrade != "none":
                field += f"_{args.degrade}"
            block = {k: row[k] for k in ("mean_delta", "min_delta", "max_delta", "per_image")}
            block["measured_utc"] = time.strftime("%Y-%m-%d")
            update_eval(ckdir, f"{bare}_x{s}", {field: block})

    tag = "" if args.degrade == "none" else f" + {args.degrade}"
    img_names = [t for t, _ in panel]
    print(f"\nheld-out photo panel x{s} (INTER_AREA degradation{tag}), delta dB vs bicubic")
    print(f"{'model':<16} " + " ".join(f"{n:>9}" for n in img_names) + "      mean [min, max]")
    for r in rows:
        cells = " ".join(f"{r['per_image'][n]['delta']:+9.2f}" if n in r["per_image"]
                         else " " * 9 for n in img_names)
        mn, mx = r.get("min_delta", 0.0), r.get("max_delta", 0.0)
        print(f"{r['model']:<16} {cells}    {r['mean_delta']:+6.2f} [{mn:+.2f}, {mx:+.2f}]")
    return rows


if __name__ == "__main__":
    main()
