"""Full-reference quality metrics (port of ``srs_tpu/qa/metrics.py:42-183``):
PSNR, Gaussian-windowed SSIM, the simple (uncropped) and global-statistics
SSIM, multi-scale SSIM and the multiscale downsample comparison, on tensors in the [0, 255] float domain on any
device. Each returns a 0-d float32 tensor (the caller fetches them
together).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.colorspace import rgb_to_gray
from ..ops.filters import gaussian_blur
from ..ops.resize import resize_bicubic

__all__ = ["psnr", "ssim", "ssim_simple", "ssim_global", "ms_ssim", "downsample_comparison"]

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2
# Wang et al. MS-SSIM weights (5 scales).
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    if x.dim() >= 3 and x.shape[-1] == 3:
        return rgb_to_gray(x)
    if x.dim() >= 3 and x.shape[-1] == 1:
        return x[..., 0]
    return x


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """10 log10(range^2 / MSE), clamped to 100 dB as MSE -> 0."""
    mse = ((img1.float() - img2.float()) ** 2).mean()
    val = 10.0 * torch.log10((data_range**2) / torch.clamp(mse, min=1e-10))
    return torch.clamp(val, max=100.0)


def _ssim_stats(x, y, blur) -> Tuple[torch.Tensor, ...]:
    mu1, mu2 = blur(x), blur(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x * x) - mu1_sq
    s2 = blur(y * y) - mu2_sq
    s12 = blur(x * y) - mu12
    return mu1_sq, mu2_sq, mu12, s1, s2, s12


def _ssim_map(x, y, blur):
    mu1_sq, mu2_sq, mu12, s1, s2, s12 = _ssim_stats(x, y, blur)
    return ((2 * mu12 + _C1) * (2 * s12 + _C2)) / ((mu1_sq + mu2_sq + _C1) * (s1 + s2 + _C2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, sigma: float = 1.5, win: int = 11,
         crop: bool = True) -> torch.Tensor:
    """Gaussian-windowed SSIM on grey (skimage ``gaussian_weights=True``
    semantics): 11x11 window, border crop of win // 2."""
    x = _to_gray(img1).float()
    y = _to_gray(img2).float()
    m = _ssim_map(x, y, lambda a: gaussian_blur(a, win, sigma))
    if crop:
        r = win // 2
        m = m[..., r:-r, r:-r]
    return m.mean()


def ssim_simple(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM from cv2.GaussianBlur(11, 1.5) local statistics, the mean of
    the whole map (no border crop)."""
    x = _to_gray(img1).float()
    y = _to_gray(img2).float()
    return _ssim_map(x, y, lambda a: gaussian_blur(a, 11, 1.5)).mean()


def ssim_global(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of one window over the whole image (population statistics)."""
    x = _to_gray(img1).float()
    y = _to_gray(img2).float()
    mu1, mu2 = x.mean(), y.mean()
    v1, v2 = torch.var(x, correction=0), torch.var(y, correction=0)
    cov = ((x - mu1) * (y - mu2)).mean()
    return ((2 * mu1 * mu2 + _C1) * (2 * cov + _C2)) / (
        (mu1**2 + mu2**2 + _C1) * (v1 + v2 + _C2))


def _pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    return x[..., :h, :w].reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003) with 2x mean-pool decimation."""
    x = _to_gray(img1).float()
    y = _to_gray(img2).float()
    blur = lambda a: gaussian_blur(a, 11, 1.5)  # noqa: E731
    vals = []
    for lv in range(levels):
        mu1_sq, mu2_sq, mu12, s1, s2, s12 = _ssim_stats(x, y, blur)
        if lv == levels - 1:
            ssim_l = (((2 * mu12 + _C1) * (2 * s12 + _C2))
                      / ((mu1_sq + mu2_sq + _C1) * (s1 + s2 + _C2))).mean()
            vals.append(torch.clamp(ssim_l, min=0.0))
        else:
            cs = ((2 * s12 + _C2) / (s1 + s2 + _C2)).mean()
            vals.append(torch.clamp(cs, min=0.0))
            x, y = _pool2(x), _pool2(y)
    out = torch.ones((), dtype=torch.float32, device=x.device)
    for v, wgt in zip(vals, _MSSSIM_WEIGHTS[:levels]):
        out = out * v**wgt
    return out


def downsample_comparison(
    original: torch.Tensor,
    upscaled: torch.Tensor,
    scale_factors: Sequence[float] = (0.1, 0.2, 0.4),
    scale_names: Optional[Dict[float, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Bicubic-downsample both images to each scale of their own size (cv2
    INTER_CUBIC, no antialias), crop to the common size, and score PSNR
    and SSIM."""
    if scale_names is None:
        scale_names = {0.1: "structure_color", 0.2: "mid_frequency", 0.4: "high_frequency"}
    oh, ow = original.shape[-3], original.shape[-2]
    uh, uw = upscaled.shape[-3], upscaled.shape[-2]
    out: Dict[str, torch.Tensor] = {}
    for s in scale_factors:
        name = scale_names.get(s, f"scale_{s}")
        d_hr = resize_bicubic(original, int(oh * s), int(ow * s))
        d_sr = resize_bicubic(upscaled, int(uh * s), int(uw * s))
        mh = min(d_hr.shape[-3], d_sr.shape[-3])
        mw = min(d_hr.shape[-2], d_sr.shape[-2])
        d_hr, d_sr = d_hr[..., :mh, :mw, :], d_sr[..., :mh, :mw, :]
        out[f"psnr_{name}"] = psnr(d_hr, d_sr)
        out[f"ssim_{name}"] = ssim(d_hr, d_sr)
    return out
