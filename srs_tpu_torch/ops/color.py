"""Colour-consistency correction (port of ``srs_tpu/ops/color.py``):
256-bin histogram CDF matching, mean-std matching and the box-filter
guided filter (He et al. 2013), on tensors on any device.
"""

from __future__ import annotations

import torch

from .filters import box_blur

__all__ = ["histogram_matching", "mean_std_matching", "guided_filter", "color_correction"]


def _bins(channel: torch.Tensor) -> torch.Tensor:
    """Bin of each sample: truncated toward zero, clipped to [0, 255]."""
    return torch.clamp(channel.to(torch.int32), 0, 255).reshape(-1).long()


def _cdf256(channel: torch.Tensor) -> torch.Tensor:
    """Normalized-to-255 float32 CDF of a [0, 255] float channel, 256 bins
    (exact integer counts, summed in float32 as the reference does)."""
    hist = torch.bincount(_bins(channel), minlength=256).float()
    cdf = torch.cumsum(hist, 0)
    return cdf / cdf[-1] * 255.0


def histogram_matching(source: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per-channel histogram matching: LUT[i] = argmin_j |ref_cdf[j] -
    src_cdf[i]| (the lowest j on a tie), applied to the source's bins.
    Returns float32 in [0, 255]."""
    src = source.float()
    ref = reference.float()

    def one_channel(s, r):
        scdf = _cdf256(s)
        rcdf = _cdf256(r)
        lut = torch.argmin(torch.abs(rcdf[None, :] - scdf[:, None]), dim=1).float()
        return lut[_bins(s)].reshape(s.shape)

    if src.dim() == 2:
        return one_channel(src, ref)
    return torch.stack([one_channel(src[..., c], ref[..., c]) for c in range(src.shape[-1])],
                       dim=-1)


def mean_std_matching(source: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """(src - mu_s) * sigma_r / (sigma_s + 1e-6) + mu_r per channel
    (population standard deviations)."""
    src = source.float()
    ref = reference.float()
    dims = tuple(range(src.dim() - 1)) if src.dim() == 3 else tuple(range(src.dim()))
    sm, ss = src.mean(dim=dims), src.std(dim=dims, correction=0)
    rm, rs = ref.mean(dim=dims), ref.std(dim=dims, correction=0)
    return (src - sm) * (rs / (ss + 1e-6)) + rm


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 0.01) -> torch.Tensor:
    """Box-filter guided filter on (H, W[, C]) arrays; ``radius`` is the
    box's side, as in the reference's cv2.blur chain."""
    g = guide.float()
    s = src.float()
    if g.dim() == 3:
        gm, sm = g.permute(2, 0, 1), s.permute(2, 0, 1)
    else:
        gm, sm = g[None], s[None]
    mean_g = box_blur(gm, radius)
    mean_s = box_blur(sm, radius)
    cov = box_blur(gm * sm, radius) - mean_g * mean_s
    var = box_blur(gm * gm, radius) - mean_g * mean_g
    a = cov / (var + eps)
    b = mean_s - a * mean_g
    out = box_blur(a, radius) * gm + box_blur(b, radius)
    return out.permute(1, 2, 0) if g.dim() == 3 else out[0]


def color_correction(
    image: torch.Tensor,
    reference_tile: torch.Tensor,
    method: str = "histogram",
    local_filter: bool = True,
) -> torch.Tensor:
    """Match ``image`` to ``reference_tile`` ("histogram", "mean_std" or
    "none"), optionally guided-filter the result against the original,
    and clip to [0, 255]."""
    img = image.float()
    if method == "none":
        return img
    if method == "histogram":
        corrected = histogram_matching(img, reference_tile)
    elif method == "mean_std":
        corrected = mean_std_matching(img, reference_tile)
    else:
        corrected = img
    if local_filter:
        corrected = guided_filter(corrected, img, radius=8, eps=0.01)
    return torch.clamp(corrected, 0.0, 255.0)
