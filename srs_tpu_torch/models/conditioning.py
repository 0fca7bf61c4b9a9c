"""Prompt-conditioned polish (port of ``srs_tpu/models/conditioning.py``).

A prompt category maps to a conditioning vector ``c = (denoise, deblur,
deblock)`` in [0, 1] (``CATEGORY_CONDITIONING``). ``CondPolish`` is a
scale-1 restoration net whose first feature map is FiLM-modulated by
``c`` (Perez et al. 2018): one set of conv weights serves every point of
the conditioning space. It is the identity with a zero ``conv_out``, so
an untrained polish changes nothing. The polish counts as trained when
``("cond_polish", 1)`` weights were handed in
(``models/registry.convert_flax_params`` or ``seeded_params``), saved in
the checkpoint directory, or stored (``registry.PACKAGED_CHECKPOINT_DIR``).

The training half makes the polish's (distorted, c) pairs
(``degrade_conditioned``): per image each axis of ``c`` is zero with
probability ``zero_frac`` or uniform in [0.1, 1], and the distortion
applied is what ``c`` says: a Gaussian blur of sigma 1.6 c1, a JPEG-luma
model of table scale 2.5 c2 (``jpeg_blockiness``: 8x8 blockwise DCT,
quantization rounding half to even), and Gaussian noise of sigma 25 c0.
The draws come from a ``torch.Generator``; ``conditioned_distort`` is the
arm given them.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .nets import Conv2d, Linear, _residual

__all__ = [
    "COND_DIM",
    "CATEGORY_CONDITIONING",
    "CondPolish",
    "cond_vector",
    "build_cond_polish",
    "apply_cond_polish",
    "is_cond_polish_trained",
    "clear_cond_cache",
    "jpeg_blockiness",
    "conditioned_draws",
    "conditioned_distort",
    "degrade_conditioned",
]

COND_DIM = 3  # (denoise, deblur, deblock)

# Per category, from the template strings in prompts.py: denoise where the
# negative prompt names noise or artifacts, deblur for "soft focus" or
# "crisp edges", deblock for banding. Detail-critical categories (food,
# fashion, jewelry) keep denoise low.
CATEGORY_CONDITIONING: Dict[str, Tuple[float, float, float]] = {
    "beauty": (0.30, 0.25, 0.15),
    "3c": (0.40, 0.45, 0.30),
    "food": (0.10, 0.25, 0.15),
    "fashion": (0.10, 0.30, 0.10),
    "jewelry": (0.15, 0.50, 0.10),
    "furniture": (0.20, 0.25, 0.15),
    "automotive": (0.25, 0.40, 0.25),
    "general": (0.20, 0.25, 0.15),
}


def cond_vector(category: str, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(COND_DIM,) float32 conditioning of a prompt category; unknown
    categories take 'general', as ``PromptTemplateManager`` does."""
    c = CATEGORY_CONDITIONING.get(category, CATEGORY_CONDITIONING["general"])
    return torch.tensor(c, dtype=torch.float32, device=device)


class CondPolish(nn.Module):
    """FiLM-conditioned scale-1 restoration net. ``forward(x, c)``: x an
    NHWC [0, 255] batch, c of shape (COND_DIM,) or (N, COND_DIM). FiLM,
    ``h * (1 + gamma) + beta``, runs in ``dtype``."""

    def __init__(self, features: int = 48, channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(channels, features, 5, padding=2)
        self.film = Linear(COND_DIM, 2 * features)
        self.conv_mid = Conv2d(features, features, 3, padding=1)
        self.conv_out = Conv2d(features, channels, 3, padding=1)
        self.to(dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        xf, h = _residual(x, 1, self.dtype)
        h = self.conv_in(h)
        gamma, beta = self.film(c.to(self.dtype)).chunk(2, dim=-1)
        # (F,) or (N, F) against NCHW feature maps
        gamma = gamma.reshape(-1, gamma.shape[-1], 1, 1)
        beta = beta.reshape(-1, beta.shape[-1], 1, 1)
        if h.requires_grad or gamma.requires_grad:
            # training: autograd needs conv_in's output intact for the FiLM
            # layer's gradient, so the same ops run out of place
            h = F.relu(h * (1.0 + gamma) + beta)
        else:
            # in place, each op rounded to ``dtype`` as the reference's: at
            # the 100MP preset a map is 12 GB
            h = F.relu(h.mul_(1.0 + gamma).add_(beta), inplace=True)
        h = F.relu(self.conv_mid(h), inplace=True)
        return xf + self.conv_out(h).permute(0, 2, 3, 1).float() * 255.0


def build_cond_polish(
    params: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
    params_dtype: Union[str, torch.dtype] = "float32",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[CondPolish, bool]:
    """(net in eval mode on ``device``, trained): ``params`` count as
    trained; without them the net is the identity init."""
    from .registry import build_model  # the registry builds CondPolish too

    return build_model("cond_polish", 1, params, dtype, params_dtype, device)


# checkpoint_dir -> what is_cond_polish_trained found
_CACHE: Dict[Tuple[Optional[str], str], bool] = {}


def clear_cond_cache() -> None:
    """Forget what :func:`is_cond_polish_trained` found (reference
    conditioning.py:123)."""
    _CACHE.clear()


def is_cond_polish_trained(checkpoint_dir: Optional[str] = None) -> bool:
    """Whether the port has trained polish weights: ``cond_polish_x1.pt`` in
    ``checkpoint_dir``, else in the store (reference conditioning.py:158,
    which looks in the same two places), kept per directory and store
    until :func:`clear_cond_cache`."""
    from . import registry

    key = (checkpoint_dir, registry.PACKAGED_CHECKPOINT_DIR)
    if key not in _CACHE:
        saved = registry.checkpoint_path("cond_polish", 1, checkpoint_dir) if checkpoint_dir else ""
        _CACHE[key] = os.path.isfile(saved) or bool(registry.packaged_file("cond_polish_x1.pt"))
    return _CACHE[key]


def apply_cond_polish(
    img: torch.Tensor,
    category: str = "general",
    params: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> torch.Tensor:
    """The conditioned polish of an NHWC [0, 255] batch for ``category``, on
    the batch's device; the identity without ``params``."""
    net, _ = build_cond_polish(params, dtype, device=img.device)
    return net(img, cond_vector(category, img.device))


# The standard JPEG luminance quantization table (quality 50).
_JPEG_Q50 = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99),
)


def _dct8_matrix(device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Orthonormal 8-point DCT-II matrix (rows are the basis), float32."""
    k = torch.arange(8, dtype=torch.float32, device=device)
    mat = torch.cos(math.pi * (2 * k[None, :] + 1) * k[:, None] / 16.0)
    scale = torch.where(k == 0, math.sqrt(1.0 / 8.0), math.sqrt(2.0 / 8.0))
    return mat * scale[:, None]


def jpeg_blockiness(x: torch.Tensor, strength: Union[float, torch.Tensor]) -> torch.Tensor:
    """JPEG-luma-model compression of (..., H, W, C) per channel, H and W
    multiples of 8: 8x8 blockwise orthonormal DCT, quantization by the
    luminance table times ``strength`` (a scalar, or one per leading
    index: ~0 lossless, 1 ~ quality 50), inverse DCT, clipped to
    [0, 255]. Rounds half to even, as the reference's ``jnp.round``."""
    d = _dct8_matrix(x.device)
    h, w = x.shape[-3], x.shape[-2]
    b = x.reshape(*x.shape[:-3], h // 8, 8, w // 8, 8, x.shape[-1]) - 128.0
    coef = torch.einsum("ai,...hiwjc,bj->...hawbc", d, b, d)
    s = torch.as_tensor(strength, dtype=torch.float32, device=x.device)
    s = s.reshape(s.shape + (1,) * 5)  # over (hb, a, wb, b, c)
    q50 = torch.tensor(_JPEG_Q50, dtype=torch.float32, device=x.device).reshape(8, 1, 8, 1)
    q = torch.clamp(q50 * torch.clamp(s, min=1e-4), min=1e-4)
    qc = torch.where(s > 1e-3, torch.round(coef / q) * q, coef)
    out = torch.einsum("ai,...hawbc,bj->...hiwjc", d, qc, d)
    return torch.clamp(out.reshape(x.shape) + 128.0, 0.0, 255.0)


def conditioned_draws(n: int, patch_shape: Tuple[int, int, int], generator: torch.Generator,
                      zero_frac: float = 0.3, device: Union[str, torch.device] = "cpu"
                      ) -> Dict[str, torch.Tensor]:
    """Per image: ``c`` [n, COND_DIM] (each axis zero with probability
    ``zero_frac``, else uniform in [0.1, 1]) and a standard normal field
    of the patch shape."""
    kw = dict(generator=generator, device=device)
    draw = 0.1 + 0.9 * torch.rand((n, COND_DIM), **kw)
    on = torch.rand((n, COND_DIM), **kw) >= zero_frac
    c = torch.where(on, draw, 0.0)
    return {"c": c, "noise": torch.randn((n,) + tuple(patch_shape), **kw)}


def conditioned_distort(hr: torch.Tensor, c: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The distortion ``c`` [n, 3] reports on hr [n, P, P, 3]: a 7-tap
    Gaussian blur of sigma max(1.6 c1, 1e-3), JPEG blockiness at 2.5 c2,
    then ``noise`` times 25 c0, clipped to [0, 255]."""
    from .train import _gauss7, _sep_blur7

    out = _sep_blur7(hr, _gauss7(torch.clamp(1.6 * c[:, 1], min=1e-3)))
    out = jpeg_blockiness(out, 2.5 * c[:, 2])
    return torch.clamp(out + noise * (25.0 * c[:, 0]).reshape(-1, 1, 1, 1), 0.0, 255.0)


def degrade_conditioned(hr: torch.Tensor, generator: torch.Generator,
                        zero_frac: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distorted, c) training pairs for the conditioned polish from hr
    [n, P, P, 3] float32 in [0, 255], P a multiple of 8; draws from
    ``generator`` (on hr's device)."""
    draws = conditioned_draws(hr.shape[0], tuple(hr.shape[1:]), generator, zero_frac,
                              hr.device)
    return conditioned_distort(hr, **draws), draws["c"]
