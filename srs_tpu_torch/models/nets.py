"""The SR nets and back-projection (port of ``srs_tpu/models/nets.py``):
ESPCN, the fast net and, at ``scale=1``, the hybrid ladder's polish
(97-147); EDSR, the quality net (150-214); RCAN, EDSR with
channel-attention blocks (217-292); and ``back_project`` (295-337).

Every net is bicubic-residual: the output is bicubic upsampling plus the
net's residual, so a zero last conv reproduces bicubic exactly. Inputs
and outputs are NHWC float32 in [0, 255], as in the reference. The
convolutions run in ``dtype``. Their parameters are held in that type for
serving, or in float32 for training (``registry.build_model(...,
master_weights=True)``): each conv casts its weight and bias to the type
of its input, as flax's ``nn.Conv(dtype=...)`` casts float32 parameters,
so autograd carries the cast and the gradients reach float32 master
weights. A cast to the type a parameter already has is free.

Two layout rules hold against the flax reference (handled by
``registry.convert_flax_params``):

- flax kernels are HWIO, torch's are OIHW;
- the reference's ``depth_to_space`` orders channels as (s1, s2, c) and
  ``F.pixel_shuffle`` as (c, s1, s2): the output channels of every conv
  that feeds a shuffle are permuted when converting.

Inside the net the activations are NCHW views of NHWC memory (torch's
channels_last), which cuDNN runs directly. Each conv ends in its epilogue
(``ops/cuda/epilogue.py``): the bias, and the ReLU or the scaled residual
that follows it in the net, as one kernel where that applies, else as the
plain ops; both routes give the same bits.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import epilogue
from ..ops.resize import resize_area_int, resize_bicubic, resize_bicubic_up

__all__ = ["ESPCN", "EDSR", "RCAN", "Conv2d", "Linear", "back_project", "depth_to_space",
           "shuffle_channel_order", "_shuffle_factors"]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the type of its input, casting its
    parameters to it, and ends in its epilogue: the bias, then a ReLU
    (``relu``) or ``residual + res_scale * y`` (``residual``).

    On a card with autograd off (serving) the epilogue is one kernel
    (``epilogue.conv_epilogue``), which raises on what it does not take;
    on the CPU and under autograd (training, zssr's tuning) the plain ops,
    as PyTorch runs them (``epilogue.conv_epilogue_plain``). Both routes
    give the same bits."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None, res_scale: float = 1.0) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if x.is_cuda and not torch.is_grad_enabled():
            return epilogue.conv_epilogue(self._conv_forward(x, w, None), b, relu, residual,
                                          res_scale)
        return epilogue.conv_epilogue_plain(self._conv_forward(x, w, b), None, relu, residual,
                                            res_scale)


class Linear(nn.Linear):
    """``nn.Linear`` that runs in the type of its input, casting its
    parameters to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def depth_to_space(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Reference pixel shuffle on NHWC: [N, H, W, C*s^2] -> [N, H*s, W*s, C]
    with channels ordered (s1, s2, c)."""
    n, h, w, cc = x.shape
    c = cc // (scale * scale)
    x = x.reshape(n, h, w, scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * scale, w * scale, c)


def shuffle_channel_order(c: int, s: int) -> torch.Tensor:
    """Index ``p`` with ``torch_channel[k] = flax_channel[p[k]]``: torch's
    channel ``ch*s*s + i*s + j`` is the reference's ``(i*s + j)*c + ch``."""
    k = torch.arange(c * s * s)
    ch, rem = k // (s * s), k % (s * s)
    return rem * c + ch


def _shuffle_factors(scale: int) -> List[int]:
    """Decompose a scale into {2, 3} pixel-shuffle stages (4 -> 2x2)."""
    factors = []
    s = scale
    while s % 2 == 0 and s > 1:
        factors.append(2)
        s //= 2
    while s % 3 == 0 and s > 1:
        factors.append(3)
        s //= 3
    if s != 1:
        raise ValueError(f"unsupported scale {scale}: must factor into 2s and 3s")
    return factors


def _residual(x: torch.Tensor, scale: int, dtype: torch.dtype):
    """(bicubic base in float32, normalised NCHW input in ``dtype``) of an
    NHWC [0, 255] batch."""
    x = x.float()
    base = resize_bicubic_up(x, scale) if scale > 1 else x
    return base, (x / 255.0 - 0.5).to(dtype).permute(0, 3, 1, 2)


def _add_residual(base: torch.Tensor, r: torch.Tensor, factors: List[int]) -> torch.Tensor:
    if factors:
        r = F.pixel_shuffle(r, factors[-1])
    return base + r.permute(0, 2, 3, 1).float() * 255.0


class ESPCN(nn.Module):
    """Efficient sub-pixel CNN (Shi et al. 2016 family): the fast net.
    ``scale=1`` is the polish pass of the hybrid ladder."""

    def __init__(
        self,
        scale: int = 2,
        features: int = 64,
        channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        half = features // 2
        self.conv_in = Conv2d(channels, features, 5, padding=2)
        self.conv_mid = Conv2d(features, half, 3, padding=1)
        self.factors = _shuffle_factors(scale) if scale > 1 else []
        self.up_convs = nn.ModuleList(
            Conv2d(half, half * f * f, 3, padding=1) for f in self.factors[:-1]
        )
        out = channels * self.factors[-1] ** 2 if self.factors else channels
        self.conv_out = Conv2d(half, out, 3, padding=1)
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base, h = _residual(x, self.scale, self.dtype)
        h = self.conv_mid(self.conv_in(h, relu=True), relu=True)
        for conv, f in zip(self.up_convs, self.factors[:-1]):
            h = F.relu(F.pixel_shuffle(conv(h), f))
        return _add_residual(base, self.conv_out(h), self.factors)


class _ResBlock(nn.Module):
    def __init__(self, features: int, res_scale: float):
        super().__init__()
        self.conv0 = Conv2d(features, features, 3, padding=1)
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(self.conv0(x, relu=True), residual=x, res_scale=self.res_scale)


class _CABlock(nn.Module):
    """Residual channel-attention block: conv-relu-conv, gated per channel
    by a squeeze-excite of its mean. The mean is taken in float32 and cast
    back before the 1x1 convs, as the reference does."""

    def __init__(self, features: int, reduction: int, res_scale: float):
        super().__init__()
        self.conv0 = Conv2d(features, features, 3, padding=1)
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.att0 = Conv2d(features, features // reduction, 1)
        self.att1 = Conv2d(features // reduction, features, 1)
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.conv0(x, relu=True))
        s = h.float().mean(dim=(2, 3), keepdim=True).to(h.dtype)
        s = torch.sigmoid(self.att1(F.relu(self.att0(s))))
        return x + h * s * self.res_scale


class EDSR(nn.Module):
    """EDSR-style quality net (Lim et al. 2017 architecture family).
    ``block`` builds each body block (RCAN passes its attention block)."""

    def __init__(
        self,
        scale: int = 2,
        features: int = 64,
        num_blocks: int = 8,
        channels: int = 3,
        res_scale: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
        block: Optional[Callable[[], nn.Module]] = None,
    ):
        super().__init__()
        self.scale = scale
        self.features = features
        self.channels = channels
        self.dtype = dtype
        block = block or (lambda: _ResBlock(features, res_scale))
        self.head = Conv2d(channels, features, 3, padding=1)
        self.blocks = nn.ModuleList(block() for _ in range(num_blocks))
        self.body_out = Conv2d(features, features, 3, padding=1)
        factors = _shuffle_factors(scale) if scale > 1 else []
        self.factors = factors
        self.up_convs = nn.ModuleList(
            Conv2d(features, features * f * f, 3, padding=1) for f in factors[:-1]
        )
        tail_out = channels * factors[-1] ** 2 if factors else channels
        self.tail = Conv2d(features, tail_out, 3, padding=1)
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base, h = _residual(x, self.scale, self.dtype)
        h0 = self.head(h)
        h = h0
        for block in self.blocks:
            h = block(h)
        h = self.body_out(h, residual=h0)
        for conv, f in zip(self.up_convs, self.factors[:-1]):
            h = F.pixel_shuffle(conv(h), f)
        return _add_residual(base, self.tail(h), self.factors)


class RCAN(EDSR):
    """Channel-attention quality net (Zhang et al. 2018 RCAN family,
    single-group variant): EDSR's layout with ``_CABlock`` blocks."""

    def __init__(
        self,
        scale: int = 2,
        features: int = 64,
        num_blocks: int = 10,
        reduction: int = 8,
        channels: int = 3,
        res_scale: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__(scale, features, num_blocks, channels, res_scale, dtype,
                         block=lambda: _CABlock(features, reduction, res_scale))


def back_project(
    sr: torch.Tensor,
    lr: torch.Tensor,
    scale: int,
    steps: int = 10,
    strength: float = 0.5,
    degradation: str = "bicubic",
) -> torch.Tensor:
    """Iterative back-projection (Irani & Peleg 1991) on NHWC float32:
    ``steps`` times ``sr <- sr + strength * Up(lr - Down(sr))``, with Up
    the integer-factor bicubic. ``degradation`` is the Down operator the
    fixed point enforces: "bicubic" (cv2 INTER_CUBIC, no antialiasing) or
    "area" (the ``scale`` x ``scale`` box mean, cv2 INTER_AREA)."""
    lh, lw = lr.shape[-3], lr.shape[-2]
    if degradation == "area":
        def down(u):
            return resize_area_int(u, scale)
    elif degradation == "bicubic":
        def down(u):
            return resize_bicubic(u, lh, lw)
    else:
        raise ValueError(f"unknown IBP degradation {degradation!r}")
    lr = lr.float()
    u = sr.float()
    for _ in range(steps):
        u = u + strength * resize_bicubic_up(lr - down(u), scale)
    return u
