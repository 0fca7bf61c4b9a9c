"""Full NIQE and the trained BRISQUE (port of ``srs_tpu/qa/niqe.py``).

Per-patch natural-scene-statistics features (a GGD fit of the MSCN
coefficients and AGGD fits of their four orientation products, at two
scales: 36 values) run batched over patches on the device; the scores
(NIQE's distance to the packaged pristine Gaussian, BRISQUE's ridge
regressor) run on the host in float64, as in the reference.

The G/AGGD shape parameter is the entry of a moment-ratio table (alpha
from 0.2 to 10 in steps of 0.001) nearest the sample ratio, as the
reference picks it; the table is built from ``math.lgamma`` in float64
and rounded to float32. ``niqe_features`` and ``fit_pristine_model`` fit
a pristine model of one's own from a set of images. The packaged models
are read from ``data/`` beside this module (``DATA_DIR``): byte-equal
copies of the reference's ``srs_tpu/qa/data``.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.filters import gaussian_blur
from .noref import _gray, mscn

__all__ = [
    "DATA_DIR",
    "niqe_scores",
    "niqe_score",
    "brisque_scores",
    "brisque_score",
    "brisque_features",
    "brisque_expand",
    "image_features36",
    "niqe_features",
    "fit_pristine_model",
]

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

_ALPHA_GRID = np.arange(0.2, 10.001, 0.001)


@lru_cache(maxsize=1)
def _ggd_table() -> Tuple[np.ndarray, np.ndarray]:
    """(alpha, rho(alpha) = G(1/a) G(3/a) / G(2/a)^2) as float32."""
    lg = np.vectorize(math.lgamma)
    a = _ALPHA_GRID
    rho = np.exp(lg(1.0 / a) + lg(3.0 / a) - 2.0 * lg(2.0 / a))
    return a.astype(np.float32), rho.astype(np.float32)


_TABLES: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


def _table(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = str(device)
    if key not in _TABLES:
        a, rho = _ggd_table()
        _TABLES[key] = (torch.from_numpy(a).to(device), torch.from_numpy(rho).to(device))
    return _TABLES[key]


def _nearest_alpha(rho: torch.Tensor) -> torch.Tensor:
    """Table alpha whose ratio is nearest ``rho`` (first of equals), per entry."""
    alphas, rho_tab = _table(rho.device)
    idx = torch.argmin((rho_tab[None, :] - rho[:, None]).abs(), dim=1)
    return alphas[idx]


def _fit_ggd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """GGD (alpha, sigma^2) per row of [N, M] by moment matching."""
    sig_sq = (x * x).mean(dim=1)
    e_abs = x.abs().mean(dim=1)
    rho = sig_sq / torch.clamp(e_abs * e_abs, min=1e-12)
    return _nearest_alpha(rho), sig_sq


def _fit_aggd(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """AGGD (alpha, mean, left var, right var) per row of [N, M]."""
    neg = torch.where(x < 0, x, 0.0)
    pos = torch.where(x > 0, x, 0.0)
    n_neg = torch.clamp((x < 0).sum(dim=1), min=1)
    n_pos = torch.clamp((x > 0).sum(dim=1), min=1)
    l_sq = (neg * neg).sum(dim=1) / n_neg
    r_sq = (pos * pos).sum(dim=1) / n_pos
    g = torch.sqrt(l_sq) / torch.clamp(torch.sqrt(r_sq), min=1e-12)
    e_abs = x.abs().mean(dim=1)
    rho_hat = (x * x).mean(dim=1) / torch.clamp(e_abs * e_abs, min=1e-12)
    rho_norm = rho_hat * (g**3 + 1.0) * (g + 1.0) / torch.clamp((g * g + 1.0) ** 2, min=1e-12)
    # The mean feature is the empirical mean of the products (reference
    # niqe.py:106-117).
    return _nearest_alpha(rho_norm), x.mean(dim=1), l_sq, r_sq


def _paired_products(m: torch.Tensor):
    h = m[:, :, :-1] * m[:, :, 1:]
    v = m[:, :-1, :] * m[:, 1:, :]
    d1 = m[:, :-1, :-1] * m[:, 1:, 1:]
    d2 = m[:, :-1, 1:] * m[:, 1:, :-1]
    return h, v, d1, d2


def _scale_features(gray: torch.Tensor) -> torch.Tensor:
    """[N, 18] features of one scale of [N, H, W]."""
    n = gray.shape[0]
    m = mscn(gray)
    a, s = _fit_ggd(m.reshape(n, -1))
    feats = [a, s]
    for prod in _paired_products(m):
        feats.extend(_fit_aggd(prod.reshape(n, -1)))
    return torch.stack(feats, dim=1)


def _half_scale(gray: torch.Tensor) -> torch.Tensor:
    """Low-pass and 2x decimation (NIQE's second scale)."""
    return gaussian_blur(gray, 7, 7.0 / 6.0)[:, ::2, ::2]


def image_features36(gray: torch.Tensor) -> torch.Tensor:
    """[N, 36] NSS features of [N, H, W] grey images at two scales."""
    return torch.cat([_scale_features(gray), _scale_features(_half_scale(gray))], dim=1)


def _sigma_field(gray: torch.Tensor) -> torch.Tensor:
    """Local contrast field of (..., H, W) grey images: the sigma of the
    MSCN normalization (reference qa/niqe.py:152)."""
    g = gray.float()
    mu = gaussian_blur(g, 7, 7.0 / 6.0)
    sigma_sq = gaussian_blur(g * g, 7, 7.0 / 6.0) - mu * mu
    return torch.sqrt(torch.clamp(sigma_sq, min=0.0))


def _sharp(patches: torch.Tensor) -> torch.Tensor:
    """Mean local contrast (the MSCN sigma field) of each [N, h, w] patch."""
    return _sigma_field(patches).mean(dim=(-2, -1))


def niqe_features(image: torch.Tensor, patch: int = 96, select: float = 0.75) -> np.ndarray:
    """[P, 36] features of one (H, W, C) image over its non-overlapping
    patch grid, keeping the patches whose mean local contrast reaches
    ``select`` x the sharpest one's (all of them with ``select <= 0``);
    one whole-image vector when the image is smaller than a patch."""
    g = _gray(torch.as_tensor(image)[None]).float()[0]
    h, w = g.shape[-2], g.shape[-1]
    ph, pw = h // patch, w // patch
    if ph == 0 or pw == 0:
        return image_features36(g[None]).cpu().numpy()
    g = g[: ph * patch, : pw * patch]
    patches = g.reshape(ph, patch, pw, patch).permute(0, 2, 1, 3).reshape(-1, patch, patch)
    feats = image_features36(patches).cpu().numpy()
    if select <= 0.0:
        return feats
    sharp = _sharp(patches).cpu().numpy()
    keep = sharp >= select * float(sharp.max())
    return feats[keep] if keep.any() else feats


def fit_pristine_model(images, patch: int = 96, shrink: float = 0.0) -> Dict[str, np.ndarray]:
    """The pristine Gaussian (``mu``, ``cov``, float64) of the feature
    vectors of ``images`` (each (H, W, C) in [0, 255]; rows with a
    non-finite value dropped). ``shrink`` pulls the covariance toward its
    diagonal, ``(1 - s) cov + s diag(cov)``; the packaged model used 0.1."""
    f = np.concatenate([niqe_features(torch.as_tensor(np.asarray(im, np.float32))
                                      if not isinstance(im, torch.Tensor) else im.float(), patch)
                        for im in images], axis=0)
    f = f[np.all(np.isfinite(f), axis=1)]
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    if shrink > 0.0:
        cov = (1.0 - shrink) * cov + shrink * np.diag(np.diag(cov))
    return {"mu": mu.astype(np.float64), "cov": cov.astype(np.float64)}


@lru_cache(maxsize=1)
def _load_pristine() -> Optional[Tuple[np.ndarray, np.ndarray, float, float]]:
    """(mu, cov, scale_a, scale_b) of the packaged pristine model."""
    path = os.path.join(DATA_DIR, "niqe_pristine.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    a = float(z["scale_a"]) if "scale_a" in z else 1.0
    b = float(z["scale_b"]) if "scale_b" in z else 0.0
    return z["mu"], z["cov"], a, b


@lru_cache(maxsize=1)
def _load_brisque() -> Optional[Tuple[np.ndarray, ...]]:
    path = os.path.join(DATA_DIR, "brisque_model.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return z["w"], z["b"], z["mu"], z["sd"]


def _mahalanobis_score(f: np.ndarray, mu_p: np.ndarray, cov_p: np.ndarray) -> Optional[float]:
    f = f[np.all(np.isfinite(f), axis=1)]
    if f.shape[0] == 0:
        return None
    mu_t = f.mean(axis=0)
    cov_t = np.cov(f, rowvar=False) if f.shape[0] > 1 else np.zeros_like(cov_p)
    d = mu_p - mu_t
    s = (cov_p + cov_t) / 2.0 + 1e-8 * np.eye(len(mu_p))
    try:
        return float(np.sqrt(max(d @ np.linalg.solve(s, d), 0.0)))
    except np.linalg.LinAlgError:
        return None


def brisque_features(image: torch.Tensor) -> torch.Tensor:
    """BRISQUE's 36 features of one (H, W, C) image: 18 NSS features at
    two scales over the whole image (reference qa/niqe.py:312)."""
    return image_features36(_gray(image[None]).float())[0]


def brisque_expand(z: np.ndarray) -> np.ndarray:
    """The quadratic map [z, z^2, |z|] the BRISQUE regressor reads
    (reference qa/niqe.py:328)."""
    return np.concatenate([z, z * z, np.abs(z)], axis=-1)


def niqe_scores(images: torch.Tensor, patch: int = 96, select: float = 0.75) -> List[Optional[float]]:
    """NIQE of each image of [N, H, W, C]: features of every patch of the
    non-overlapping grid, the patches whose mean local contrast reaches
    ``select`` x the image's sharpest kept, then the calibrated distance
    to the pristine model. Images smaller than one patch score on one
    whole-image feature vector."""
    model = _load_pristine()
    n = int(images.shape[0])
    if model is None:
        return [None] * n
    mu_p, cov_p, sa, sb = model

    def cal(v):
        return None if v is None else max(sa * v + sb, 0.0)

    g = _gray(images).float()
    h, w = g.shape[-2], g.shape[-1]
    ph, pw = h // patch, w // patch
    if ph == 0 or pw == 0:
        feats = image_features36(g).cpu().numpy().astype(np.float64)
        return [cal(_mahalanobis_score(feats[i : i + 1], mu_p, cov_p)) for i in range(n)]
    g = g[:, : ph * patch, : pw * patch]
    patches = g.reshape(n, ph, patch, pw, patch).permute(0, 1, 3, 2, 4).reshape(
        n * ph * pw, patch, patch)
    feats = image_features36(patches).cpu().numpy().astype(np.float64).reshape(n, ph * pw, 36)
    sharp = _sharp(patches).cpu().numpy().reshape(n, ph * pw)
    out = []
    for i in range(n):
        keep = sharp[i] >= select * float(sharp[i].max())
        f = feats[i][keep] if keep.any() and select > 0 else feats[i]
        out.append(cal(_mahalanobis_score(f, mu_p, cov_p)))
    return out


def brisque_scores(images: torch.Tensor) -> List[Optional[float]]:
    """Trained BRISQUE of each image of [N, H, W, C] in [0, 100] (higher is
    worse): whole-image features, the packaged ridge regressor on
    [z, z^2, |z|]."""
    model = _load_brisque()
    n = int(images.shape[0])
    if model is None:
        return [None] * n
    w, b, mu, sd = model
    feats = image_features36(_gray(images).float()).cpu().numpy().astype(np.float64)
    out = []
    for f in feats:
        if not np.all(np.isfinite(f)):
            out.append(None)
            continue
        z = brisque_expand((f - mu) / sd)
        out.append(float(np.clip(z @ w + b, 0.0, 100.0)))
    return out


def niqe_score(image: torch.Tensor, patch: int = 96) -> Optional[float]:
    """NIQE of one (H, W, C) image; None without the packaged model."""
    return niqe_scores(image[None], patch)[0]


def brisque_score(image: torch.Tensor) -> Optional[float]:
    """Trained BRISQUE of one (H, W, C) image; None without the model."""
    return brisque_scores(image[None])[0]
