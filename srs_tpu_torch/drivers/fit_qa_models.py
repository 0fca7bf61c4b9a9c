"""Fit the no-reference QA models (port of ``scripts/fit_qa_models.py``):

- NIQE's pristine Gaussian (mu, cov of the 36 NSS features) on the
  training photographs at five scales and the crisp half of
  ``render_photo`` renders -> ``niqe_pristine.npz``, calibrated onto the
  published NIQE scale;
- BRISQUE's ridge regressor on a blur / noise / JPEG / upscale ladder with
  severity pseudo-DMOS -> ``brisque_model.npz``;
- the LPIPS level cut-offs, the median distance at severities 1-3 ->
  ``lpips_calib.json``.

    python -m srs_tpu_torch.drivers.fit_qa_models [--only lpips]
        [--out DIR] [--checkpoint-dir DIR] [--device cuda|cpu]

The files keep the reference's npz keys and go to ``--out`` (default
``~/.cache/srs_tpu_torch/qa``), never into the JAX package. The features
run on ``--device`` (the card by default). The pristine pool needs the
photo packages and raises ``PhotoDataMissing`` without them; ``--only
lpips`` needs none. The LPIPS features are ``lpips_{vgg,alex}.pt`` from
``--checkpoint-dir`` where ``train_lpips`` saved them, else the seeded
ones. The JPEG rung encodes with PIL, as the reference's.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import QA_DATA_DIR, add_device_args, device_of, out_dir_of

N_BRISQUE = 90
SEED0 = 500_000  # disjoint from every training/eval corpus seed range
# Renders drawn for the pristine pool (its crisp half kept), the held-out
# calibration renders (likewise), and the LPIPS calibration images.
PRISTINE_RENDERS = 60
HOLDOUT_RENDERS = 24
LPIPS_IMAGES = 16


def distort(img: np.ndarray, kind: str, level: int) -> np.ndarray:
    """``img`` distorted by ``kind`` at ``level`` 1..5 (increasing
    severity)."""
    from ..models.corpus import _cv2

    cv2 = _cv2()
    # crc32, not hash(): str hash is salted per process
    rng = np.random.default_rng(level * 1000 + zlib.crc32(kind.encode()) % 1000)
    if kind == "blur":
        sigma = [0.6, 1.0, 1.6, 2.4, 3.5][level - 1]
        return cv2.GaussianBlur(img, (0, 0), sigma)
    if kind == "noise":
        sigma = [3, 7, 13, 21, 32][level - 1]
        return np.clip(img + rng.normal(0, sigma, img.shape), 0, 255).astype(np.float32)
    if kind == "jpeg":
        from PIL import Image

        q = [80, 55, 35, 20, 10][level - 1]
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG", quality=q)
        return np.asarray(Image.open(buf)).astype(np.float32)
    if kind == "upscale":
        # bicubic down-then-up: what an upscaling pipeline produces
        s = [1.25, 1.6, 2.0, 2.7, 3.5][level - 1]
        h, w = img.shape[:2]
        small = cv2.resize(img, (max(int(w / s), 8), max(int(h / s), 8)),
                           interpolation=cv2.INTER_AREA)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    raise ValueError(kind)


def _sharpness(img: np.ndarray, device: str = "cpu") -> float:
    """Mean local contrast (the NIQE sigma field) of the luma channel."""
    import torch

    from ..models.corpus import _cv2
    from ..qa.niqe import _sigma_field

    cv2 = _cv2()
    g = torch.from_numpy(cv2.cvtColor(img.astype(np.float32), cv2.COLOR_RGB2GRAY)).to(device)
    return float(_sigma_field(g).mean())


def _features(img: np.ndarray, device: str) -> np.ndarray:
    import torch

    from ..qa.niqe import niqe_features

    return np.asarray(niqe_features(torch.from_numpy(np.asarray(img, np.float32)).to(device)),
                      np.float64)


def pristine_pool(device: str = "cpu") -> np.ndarray:
    """NIQE's pristine feature pool: the training photographs at 5 scales,
    and the crisp half of ``render_photo`` renders (the soft ones overlap
    Gaussian blur and would collapse NIQE's blur sensitivity). Raises
    ``PhotoDataMissing`` without the photo packages."""
    from ..models.corpus import _cv2, render_photo
    from ..models.photo_data import load_photos, require_photo_paths

    require_photo_paths("the NIQE pristine pool")
    cv2 = _cv2()
    feats = []
    for p in load_photos():
        for s in (1.0, 0.85, 0.7, 0.6, 0.5):
            v = p if s == 1.0 else cv2.resize(p, None, fx=s, fy=s,
                                              interpolation=cv2.INTER_AREA)
            feats.append(_features(v, device))
    cands = [render_photo(SEED0 + i, 320) for i in range(PRISTINE_RENDERS)]
    cands.sort(key=lambda im: _sharpness(im, device), reverse=True)
    for im in cands[: PRISTINE_RENDERS // 2]:
        feats.append(_features(im, device))
    return np.concatenate(feats, axis=0)


def fit_lpips_calib(out_dir: str, lpips_params, device: str) -> Dict[str, Any]:
    """The LPIPS level cut-offs: the median distance at severities 1/2/3 of
    the ladder, so the levels keep their meaning under this metric."""
    import torch

    from ..models.corpus import render_image, render_natural, render_photo
    from ..models.lpips import LPIPSMetric

    lp = LPIPSMetric(params=lpips_params, device=device)
    per_level: Dict[int, list] = {1: [], 2: [], 3: [], 4: [], 5: []}
    for i in range(LPIPS_IMAGES):
        render = (render_photo, render_natural, render_image)[i % 3]
        img = render(SEED0 + 20_000 + i, 192)
        a = torch.from_numpy(img)
        for kind in ("blur", "noise", "jpeg", "upscale"):
            for level in (1, 2, 3, 4, 5):
                d = float(lp(a, torch.from_numpy(distort(img, kind, level))))
                per_level[level].append(d)
    med = {lv: float(np.median(v)) for lv, v in per_level.items()}
    calib = {
        "lpips_excellent": round(med[1], 4),
        "lpips_good": round(med[2], 4),
        "lpips_acceptable": round(med[3], 4),
        "medians_by_severity": med,
    }
    with open(os.path.join(out_dir, "lpips_calib.json"), "w") as f:
        json.dump(calib, f, indent=2)
    print("lpips calibration:", json.dumps(calib))
    return calib


def _lpips_params(checkpoint_dir: str):
    """The trained LPIPS features ``train_lpips`` saved, by net."""
    import torch

    out = {}
    for net in ("vgg", "alex"):
        path = os.path.join(checkpoint_dir, f"lpips_{net}.pt")
        if os.path.isfile(path):
            out[net] = torch.load(path, map_location="cpu", weights_only=True)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.fit_qa_models")
    ap.add_argument("--only", default=None, help="lpips: refit only the LPIPS calibration")
    ap.add_argument("--out", default=None, help="default ~/.cache/srs_tpu_torch/qa")
    ap.add_argument("--checkpoint-dir", default=None)
    add_device_args(ap, cpu_flag=False)
    args = ap.parse_args(argv)

    from ..models.corpus import render_image, render_natural, render_photo
    from ..models.photo_data import load_photos, photo_mosaic
    from ..qa.niqe import _mahalanobis_score, brisque_expand, brisque_features
    from ..utils.device import resolve_device

    device = str(resolve_device(device_of(args)))
    out_dir = os.path.expanduser(args.out or QA_DATA_DIR)
    os.makedirs(out_dir, exist_ok=True)
    lp_params = _lpips_params(out_dir_of(args.checkpoint_dir))
    report: Dict[str, Any] = {"out": out_dir, "device": device}
    if args.only == "lpips":
        report["lpips_calib"] = fit_lpips_calib(out_dir, lp_params, device)
        print("DONE")
        return report

    import torch

    # NIQE's pristine model: shrinkage 0.1 toward the diagonal, so held-out
    # clean images are not swamped by small-sample covariance noise
    print("building pristine feature pool...", flush=True)
    f = pristine_pool(device)
    f = f[np.all(np.isfinite(f), axis=1)]
    print(f"fitting NIQE pristine MVG on {f.shape[0]} patches...", flush=True)
    cov = np.cov(f, rowvar=False)
    model = {"mu": f.mean(axis=0).astype(np.float64),
             "cov": (0.9 * cov + 0.1 * np.diag(np.diag(cov))).astype(np.float64)}

    # calibration onto the published NIQE scale: the held-out pristine
    # median -> 2.5, the median over blur and noise at severity 3 -> 7.0,
    # the slope capped at 3.0
    print("calibrating NIQE scale...", flush=True)

    def raw_niqe(img, m):
        return _mahalanobis_score(_features(img, device), m["mu"], m["cov"])

    hcands = [render_photo(SEED0 + 50_000 + i, 320) for i in range(HOLDOUT_RENDERS)]
    hcands.sort(key=lambda im: _sharpness(im, device), reverse=True)
    hold = hcands[: HOLDOUT_RENDERS // 2]
    # the sharpest REAL crops too (from the training pool, never the panel)
    real_crops = []
    rng = np.random.default_rng(SEED0)
    for p in load_photos():
        h, w = p.shape[:2]
        if min(h, w) < 320:
            continue
        for _ in range(3):
            yy = int(rng.integers(0, h - 320 + 1))
            xx = int(rng.integers(0, w - 320 + 1))
            real_crops.append(np.ascontiguousarray(p[yy:yy + 320, xx:xx + 320], np.float32))
    real_crops.sort(key=lambda im: _sharpness(im, device), reverse=True)
    hold = hold + real_crops[: max(len(real_crops) // 2, 8)]
    raw_clean = [raw_niqe(im, model) for im in hold]
    raw_sev = [raw_niqe(distort(im, "blur", 3), model) for im in hold]
    raw_sev += [raw_niqe(distort(im, "noise", 3), model) for im in hold]
    raw_clean = [v for v in raw_clean if v is not None]
    raw_sev = [v for v in raw_sev if v is not None]
    m_c, m_s = float(np.median(raw_clean)), float(np.median(raw_sev))
    a = float(np.clip((7.0 - 2.5) / max(m_s - m_c, 1e-6), 0.75, 3.0))
    b = 2.5 - a * m_c
    model["scale_a"] = np.float64(a)
    model["scale_b"] = np.float64(b)
    np.savez(os.path.join(out_dir, "niqe_pristine.npz"), **model)
    print(f"niqe_pristine: mu[{model['mu'].shape}] cov[{model['cov'].shape}] "
          f"calib a={a:.4f} b={b:.4f} (raw clean {m_c:.2f}, sev3 {m_s:.2f})")
    report["niqe"] = {"patches": int(f.shape[0]), "scale_a": a, "scale_b": b,
                      "raw_clean": m_c, "raw_sev3": m_s}

    # BRISQUE: photo mosaics and the three render families in rotation
    print("building distortion ladder...", flush=True)

    def bfeat(img):
        t = torch.from_numpy(np.asarray(img, np.float32)).to(device)
        return np.asarray(brisque_features(t).cpu().numpy(), np.float64)

    X, y = [], []
    for i in range(N_BRISQUE):
        img = photo_mosaic(SEED0 + 10_000 + i, 256) if i % 4 == 0 else None
        if img is None:
            render = (render_photo, render_natural, render_image)[i % 3]
            img = render(SEED0 + 10_000 + i, 256)
        X.append(bfeat(img))
        y.append(2.0)  # pristine pseudo-DMOS
        for kind in ("blur", "noise", "jpeg", "upscale"):
            for level in (1, 2, 3, 4, 5):
                X.append(bfeat(distort(img, kind, level)))
                y.append(level * 18.0)  # 18..90, monotone in severity
    X = np.stack(X)
    y = np.asarray(y)
    keep = np.all(np.isfinite(X), axis=1)
    X, y = X[keep], y[keep]
    mu, sd = X.mean(0), X.std(0) + 1e-8
    Z = brisque_expand((X - mu) / sd)
    w = np.linalg.solve(Z.T @ Z + 1.0 * np.eye(Z.shape[1]), Z.T @ (y - y.mean()))
    b = y.mean()
    pred = np.clip(Z @ w + b, 0, 100)
    corr = float(np.corrcoef(pred, y)[0, 1])
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    np.savez(os.path.join(out_dir, "brisque_model.npz"), w=w, b=b, mu=mu, sd=sd)
    print(f"brisque: corr={corr:.3f} rmse={rmse:.1f} over {len(y)} samples")
    report["brisque"] = {"corr": corr, "rmse": rmse, "samples": int(len(y))}

    report["lpips_calib"] = fit_lpips_calib(out_dir, lp_params, device)
    print("DONE")
    return report


if __name__ == "__main__":
    main()
