"""Fit the fusion provider's member weights on the training photographs
(port of ``scripts/fit_fusion.py``).

The ``fusion`` quality mode (``models/fusion.py``) is an affine
least-squares blend of the trained nets; this fits its per-scale weights
on crops of the bundled photographs (``models/photo_data.py``) degraded
with the corpus protocol (cv2 INTER_AREA). The held-out portrait is never
loaded here.

    python -m srs_tpu_torch.drivers.fit_fusion [--cpu] [--scales 2,3]
        [--members a,b,...] [--checkpoint-dir DIR]

Reads the nets from ``--checkpoint-dir`` (default
``~/.cache/srs_tpu_torch/models``; an untrained member is dropped) and
writes FUSION.json there; prints, per scale, each member's fit-set PSNR
against the fused blend's. ``main`` returns {scale: (members, weights,
meta)}. Without the photo packages it raises ``PhotoDataMissing``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of, psnr, trained_params

DEFAULT_MEMBERS = ["edsr_l", "rcan", "edsr_m", "espcn", "bicubic"]


def crops_of(img: np.ndarray, size: int, per_photo: int, rng: np.random.Generator) -> list:
    """Deterministic ``size``-square HR crops of one photo."""
    h, w = img.shape[:2]
    if min(h, w) < size:
        return []
    out = []
    for _ in range(per_photo):
        y = int(rng.integers(0, h - size + 1))
        x = int(rng.integers(0, w - size + 1))
        out.append(img[y : y + size, x : x + size])
    return out


def main(argv: Optional[List[str]] = None) -> Dict[int, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.fit_fusion")
    add_device_args(ap)
    ap.add_argument("--scales", default="2,3")
    ap.add_argument("--members", default=",".join(DEFAULT_MEMBERS))
    ap.add_argument("--crop", type=int, default=312, help="HR crop (multiple of 12)")
    ap.add_argument("--per-photo", type=int, default=2)
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..models.corpus import _cv2
    from ..models.fusion import fit_affine_weights, save_fusion
    from ..models.photo_data import load_photos, require_photo_paths
    from ..models.registry import build_model
    from ..models.sr_module import _dihedral_ensemble
    from ..ops.resize import resize_bicubic_up
    from ..utils.device import resolve_device

    device = resolve_device(device_of(args))
    ckdir = out_dir_of(args.checkpoint_dir)
    require_photo_paths("the fusion fit")
    cv2 = _cv2()
    photos = load_photos()
    members = [m for m in args.members.split(",") if m]
    rng = np.random.default_rng(7)
    per_scale = {}
    for scale in (int(s) for s in args.scales.split(",")):
        crop = args.crop - args.crop % (2 * scale * 3)
        hrs = []
        for img in photos:
            hrs.extend(crops_of(img, crop, args.per_photo, rng))
        if not hrs:
            print(f"x{scale}: photos smaller than crop; skipped")
            continue
        hr = np.stack(hrs)  # [N, crop, crop, 3]
        lr = np.stack([cv2.resize(h, (crop // scale, crop // scale),
                                  interpolation=cv2.INTER_AREA) for h in hr])
        lr_d = torch.from_numpy(np.ascontiguousarray(lr, np.float32)).to(device)
        outs, kept = [], []
        for m in members:
            # "edsr_l+" = edsr_l's geometric self-ensemble as a member
            ens = m.endswith("+")
            bare = m[:-1] if ens else m
            with torch.no_grad():
                if bare == "bicubic":
                    y = resize_bicubic_up(lr_d, scale)
                else:
                    params = trained_params(bare, scale, ckdir)
                    if params is None:
                        print(f"x{scale}: {m} untrained; dropped from fit")
                        continue
                    net, _ = build_model(bare, scale, params, device=device)
                    apply = (lambda x, f=net: _dihedral_ensemble(f, x)) if ens else net
                    y = torch.cat([apply(lr_d[i : i + 1]) for i in range(len(lr_d))])
            outs.append(np.clip(y.float().cpu().numpy(), 0, 255))
            kept.append(m)
        if sum(1 for m in kept if m != "bicubic") < 2:
            print(f"x{scale}: fewer than 2 trained members; skipped")
            continue
        w = fit_affine_weights(outs, hr)
        fused = np.clip(sum(wi * o for wi, o in zip(w, outs)), 0, 255)
        scores = {m: round(psnr(o, hr), 3) for m, o in zip(kept, outs)}
        p_f = round(psnr(fused, hr), 3)
        print(f"x{scale}: members {scores}  fusion {p_f}  weights "
              f"{[round(float(x), 4) for x in w]}")
        per_scale[scale] = (kept, [float(x) for x in w], {
            "fitted_on": "bundled_photos",
            "n_crops": int(len(hr)),
            "crop": int(crop),
            "psnr_members": scores,
            "psnr_fusion": p_f,
        })
    if per_scale:
        print("wrote", save_fusion(per_scale, ckdir))
    return per_scale


if __name__ == "__main__":
    main()
