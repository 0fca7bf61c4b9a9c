"""Prompt-conditioned polish, serving half (port of
``srs_tpu/models/conditioning.py:49-120,250-260``).

A prompt category maps to a conditioning vector ``c = (denoise, deblur,
deblock)`` in [0, 1] (``CATEGORY_CONDITIONING``). ``CondPolish`` is a
scale-1 restoration net whose first feature map is FiLM-modulated by
``c`` (Perez et al. 2018): one set of conv weights serves every point of
the conditioning space. It is the identity with a zero ``conv_out``, so
an untrained polish changes nothing. The polish counts as trained when
``("cond_polish", 1)`` weights were handed in
(``models/registry.convert_flax_params`` or ``seeded_params``).

The training half (``jpeg_blockiness``, ``degrade_conditioned``) waits
for the training slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .nets import _residual

__all__ = [
    "COND_DIM",
    "CATEGORY_CONDITIONING",
    "CondPolish",
    "cond_vector",
    "build_cond_polish",
    "apply_cond_polish",
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
        self.conv_in = nn.Conv2d(channels, features, 5, padding=2)
        self.film = nn.Linear(COND_DIM, 2 * features)
        self.conv_mid = nn.Conv2d(features, features, 3, padding=1)
        self.conv_out = nn.Conv2d(features, channels, 3, padding=1)
        self.to(dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        xf, h = _residual(x, 1, self.dtype)
        h = self.conv_in(h)
        gamma, beta = self.film(c.to(self.dtype)).chunk(2, dim=-1)
        # (F,) or (N, F) against NCHW feature maps
        gamma = gamma.reshape(-1, gamma.shape[-1], 1, 1)
        beta = beta.reshape(-1, beta.shape[-1], 1, 1)
        # in place, each op rounded to ``dtype`` as the reference's: at the
        # 100MP preset a map is 12 GB
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
