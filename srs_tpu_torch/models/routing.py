"""Degradation-aware routing and the SR-gain probe (port of
``srs_tpu/models/routing.py:47-337``).

- :func:`estimate_degradation` measures the input's noise floor (the
  Immerkaer residual on low-gradient pixels) and its HF/MF band ratio
  (blur), on the tensor's device. The statistics are numpy's: the median
  of an even count averages the two middle values and the percentile
  interpolates linearly, both taken from sorted values; ``std`` has no
  Bessel correction.
- :func:`probe_sr_gain` / :func:`probe_sr_alpha` reconstruct five crops
  of the input, downscaled by the serving scale (a box mean, cv2
  INTER_AREA), through the net in bfloat16 (the reference's
  ``build_model`` default) and through bicubic: the median gain in dB and
  the residual-shrinkage coefficient alpha.
- :func:`best_shrink_candidate` and :func:`route_quality_model` pick a
  net from those statistics.

A net counts as trained at a scale when ``weights`` holds its state dict
for ``(name, scale)``; the probe builds its bfloat16 nets from those.
Images are (H, W, 3) float32 in [0, 255]: a tensor stays on its device, a
numpy array goes to ``device`` (the card by default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.filters import gaussian_blur
from ..ops.resize import resize_area_int, resize_bicubic_up
from ..utils.device import resolve_device
from .registry import build_model

__all__ = [
    "DegradationEstimate",
    "estimate_degradation",
    "route_quality_model",
    "probe_sr_gain",
    "probe_sr_alpha",
    "best_shrink_candidate",
]

NOISE_SIGMA_THRESHOLD = 2.5
BAND_RATIO_FLOOR = 0.75

# Descending probe-crop ladder: the probe uses the largest rung that fits.
_PROBE_CROP_LADDER = (192, 128, 96)

Weights = Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]
Image = Union[np.ndarray, torch.Tensor]


@dataclass
class DegradationEstimate:
    noise_sigma: float  # estimated gaussian noise std (0-255 domain)
    band_ratio: float  # HF/MF energy ratio (~>=1 clean, <<1 blurred)
    degraded: bool
    reason: str  # "clean" | "noise" | "blur"


def _as_image(image: Image, device: Union[str, torch.device]) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.float()
    return torch.from_numpy(np.asarray(image, np.float32)).to(resolve_device(device))


def _np_percentile(sorted_vals: torch.Tensor, q: float) -> float:
    """numpy's default (linear) percentile of ascending values."""
    n = int(sorted_vals.numel())
    pos = q / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    t = pos - lo
    a, b = float(sorted_vals[lo]), float(sorted_vals[hi])
    return b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t


def _np_median(vals: torch.Tensor) -> float:
    """numpy's median: the mean of the two middle values of an even count."""
    s = torch.sort(vals.reshape(-1)).values
    n = int(s.numel())
    if n % 2:
        return float(s[n // 2])
    return float((s[n // 2 - 1] + s[n // 2]) / 2)


def estimate_degradation(
    image: Image,
    noise_threshold: float = NOISE_SIGMA_THRESHOLD,
    band_ratio_floor: float = BAND_RATIO_FLOOR,
    device: Union[str, torch.device] = "cuda",
) -> DegradationEstimate:
    """Probe an RGB [0, 255] image for capture damage (reference
    routing.py:47-97): noise from the median absolute Immerkaer residual
    over the 60% flattest pixels, blur from ``std(L - G1(L)) / std(G1(L)
    - G2(L))`` with Gaussian sigmas 1 and 2 (cv2's kernel sizes for
    float input: 9 and 17)."""
    img = _as_image(image, device)
    if img.dim() == 3:
        luma = img @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    else:
        luma = img
    h, w = luma.shape
    if h < 16 or w < 16:
        return DegradationEstimate(0.0, 1.0, False, "clean")

    c = luma[1:-1, 1:-1]
    resp = (
        4 * c
        - 2 * (luma[:-2, 1:-1] + luma[2:, 1:-1] + luma[1:-1, :-2] + luma[1:-1, 2:])
        + luma[:-2, :-2] + luma[:-2, 2:] + luma[2:, :-2] + luma[2:, 2:]
    )
    gy = luma[2:, 1:-1] - luma[:-2, 1:-1]
    gx = luma[1:-1, 2:] - luma[1:-1, :-2]
    gmag = gx.abs() + gy.abs()
    thresh = _np_percentile(torch.sort(gmag.reshape(-1)).values, 60)
    flat = gmag <= thresh
    med = _np_median(resp.abs()[flat]) if bool(flat.any()) else _np_median(resp.abs())
    # |N(0, 6 sigma)| has median 6 * 0.6745 * sigma
    noise_sigma = med / (6.0 * 0.6745)

    b1 = gaussian_blur(luma, 9, 1.0)
    b2 = gaussian_blur(luma, 17, 2.0)
    band_ratio = float(torch.std(luma - b1, correction=0)) / max(
        float(torch.std(b1 - b2, correction=0)), 1e-6
    )

    if noise_sigma >= noise_threshold:
        return DegradationEstimate(noise_sigma, band_ratio, True, "noise")
    if band_ratio <= band_ratio_floor:
        return DegradationEstimate(noise_sigma, band_ratio, True, "blur")
    return DegradationEstimate(noise_sigma, band_ratio, False, "clean")


def _fit_crop(h: int, w: int, scale: int, crop: int) -> Optional[int]:
    """Largest ladder rung <= ``crop`` (made scale-divisible) that fits an
    h x w input; an explicit ``crop`` below the smallest rung is its own
    single rung. None when nothing fits."""
    rungs = (crop,) + tuple(r for r in _PROBE_CROP_LADDER if r < crop)
    for c in rungs:
        c -= c % scale
        if c > 0 and h >= c and w >= c:
            return c
    return None


def _probe_net(name: str, scale: int, weights: Weights, device: torch.device,
               nets: Optional[Dict]) -> torch.nn.Module:
    key = (name, scale, str(device))
    if nets is not None and key in nets:
        return nets[key]
    net, _ = build_model(name, scale, weights[(name, scale)], dtype="bfloat16",
                         params_dtype="float32", device=device)
    if nets is not None:
        nets[key] = net
    return net


def _probe_stats(
    image: Image,
    model_name: str,
    scale: int,
    weights: Weights,
    crop: int,
    device: Union[str, torch.device] = "cuda",
    nets: Optional[Dict] = None,
):
    """Per-crop (mse_net, mse_bic, mean((y-b)(n-b)), mean((n-b)^2)) as
    float64 numpy arrays (y = crop, b = bicubic, n = net; per-pixel
    means), or None when the probe declines (reference routing.py:248-317)."""
    img = _as_image(image, device)
    if img.dim() != 3 or img.shape[2] != 3:
        return None
    h, w = int(img.shape[0]), int(img.shape[1])
    fitted = _fit_crop(h, w, scale, crop)
    if fitted is None or (model_name, scale) not in weights:
        return None
    crop = fitted
    pos = [
        ((h - crop) // 4, (w - crop) // 4),
        ((h - crop) // 4, (3 * (w - crop)) // 4),
        ((3 * (h - crop)) // 4, (w - crop) // 4),
        ((3 * (h - crop)) // 4, (3 * (w - crop)) // 4),
        ((h - crop) // 2, (w - crop) // 2),
    ]
    with torch.inference_mode():
        hr = torch.stack([img[y : y + crop, x : x + crop] for y, x in pos])
        lr = resize_area_int(hr, scale)
        net = _probe_net(model_name, scale, weights, img.device, nets)
        out = net(lr).clamp(0, 255)
        bic = resize_bicubic_up(lr, scale).clamp(0, 255)
        m_net = ((out - hr) ** 2).mean(dim=(1, 2, 3))
        m_bic = ((bic - hr) ** 2).mean(dim=(1, 2, 3))
        d = out - bic
        num = ((hr - bic) * d).mean(dim=(1, 2, 3))
        den = (d * d).mean(dim=(1, 2, 3))
        stats = torch.stack([m_net, m_bic, num, den]).cpu().numpy().astype(np.float64)
    return (np.maximum(stats[0], 1e-12), np.maximum(stats[1], 1e-12), stats[2], stats[3])


def probe_sr_gain(
    image: Image,
    model_name: str,
    scale: int = 2,
    weights: Optional[Weights] = None,
    crop: int = 192,
    device: Union[str, torch.device] = "cuda",
    nets: Optional[Dict] = None,
) -> Optional[float]:
    """Median per-crop gain in dB of ``model_name`` over bicubic on this
    image's own statistics, or None when the image is smaller than every
    rung of the crop ladder or the net is untrained."""
    stats = _probe_stats(image, model_name, scale, weights or {}, crop, device, nets)
    if stats is None:
        return None
    m_net, m_bic, _num, _den = stats
    return float(np.median(10.0 * np.log10(m_bic / m_net)))


def probe_sr_alpha(
    image: Image,
    model_name: str,
    scale: int = 2,
    weights: Optional[Weights] = None,
    crop: int = 192,
    device: Union[str, torch.device] = "cuda",
    nets: Optional[Dict] = None,
) -> Optional[Tuple[float, float]]:
    """``(gain_db, alpha)``: the probe's gain and the pooled least-squares
    shrinkage ``alpha = <y - b, n - b> / ||n - b||^2`` clipped to [0, 1],
    or None where :func:`probe_sr_gain` declines."""
    stats = _probe_stats(image, model_name, scale, weights or {}, crop, device, nets)
    if stats is None:
        return None
    m_net, m_bic, num, den = stats
    gain = float(np.median(10.0 * np.log10(m_bic / m_net)))
    alpha = float(np.clip(num.sum() / max(den.sum(), 1e-9), 0.0, 1.0))
    return gain, alpha


def best_shrink_candidate(
    image: Image,
    models,
    scale: int = 2,
    weights: Optional[Weights] = None,
    crop: int = 192,
    device: Union[str, torch.device] = "cuda",
    nets: Optional[Dict] = None,
) -> Optional[Tuple[str, float, float, float]]:
    """``(model, raw_gain_db, alpha, loo_gain_db)`` of the candidate whose
    alpha-shrunk ladder predicts the best median leave-one-out gain on
    this input's crops, or None when no candidate can be probed
    (reference routing.py:198-245)."""
    best = None
    for name in models:
        stats = _probe_stats(image, name, scale, weights or {}, crop, device, nets)
        if stats is None:
            continue
        m_net, m_bic, num, den = stats
        raw_gain = float(np.median(10.0 * np.log10(m_bic / m_net)))
        alpha = float(np.clip(num.sum() / max(den.sum(), 1e-9), 0.0, 1.0))
        a_loo = np.clip((num.sum() - num) / np.maximum(den.sum() - den, 1e-9), 0.0, 1.0)
        m_loo = np.maximum(m_bic - 2.0 * a_loo * num + a_loo * a_loo * den, 1e-12)
        loo_gain = float(np.median(10.0 * np.log10(m_bic / m_loo)))
        if best is None or loo_gain > best[3]:
            best = (name, raw_gain, alpha, loo_gain)
    return best


def route_quality_model(
    image: Image,
    clean_model: str,
    robust_model: str = "edsr_l_robust",
    is_trained: Callable[[str, int], bool] = lambda name, scale: False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[str, DegradationEstimate]:
    """The quality net for this input: ``robust_model`` only when the
    input is damaged and the robust net is trained at x2."""
    est = estimate_degradation(image, device=device)
    if est.degraded and is_trained(robust_model, 2):
        return robust_model, est
    return clean_model, est
