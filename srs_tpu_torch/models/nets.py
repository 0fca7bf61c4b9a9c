"""The SR nets and back-projection (port of ``srs_tpu/models/nets.py``):
ESPCN, the fast net and, at ``scale=1``, the hybrid ladder's polish
(97-147); EDSR, the quality net (150-214); RCAN, EDSR with
channel-attention blocks (217-292); and ``back_project`` (295-337). The
port adds ``HAT`` (the JAX package has none), a window-attention
transformer; what follows up to the layout rules holds for the CNNs.

Every CNN is bicubic-residual: the output is bicubic upsampling plus the
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

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import epilogue, window_attn
from ..ops.resize import resize_area_int, resize_bicubic, resize_bicubic_up

__all__ = ["ESPCN", "EDSR", "RCAN", "HAT", "Conv2d", "Linear", "back_project", "depth_to_space",
           "shuffle_channel_order", "_shuffle_factors"]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the type of its input, casting its
    parameters to it, and ends in its epilogue: the bias, then a ReLU
    (``relu``), a GELU or LeakyReLU (``act``, HAT's), or ``residual +
    res_scale * y`` (``residual``).

    On a card with autograd off (serving) the epilogue is one kernel
    (``epilogue.conv_epilogue``), which raises on what it does not take;
    on the CPU and under autograd (training, zssr's tuning) the plain ops,
    as PyTorch runs them (``epilogue.conv_epilogue_plain``). Both routes
    give the same bits."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None, res_scale: float = 1.0,
                act: Optional[str] = None) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if x.is_cuda and not torch.is_grad_enabled():
            return epilogue.conv_epilogue(self._conv_forward(x, w, None), b, relu, residual,
                                          res_scale, act)
        return epilogue.conv_epilogue_plain(self._conv_forward(x, w, b), None, relu, residual,
                                            res_scale, act)


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


# -- HAT -----------------------------------------------------------------------
# The Hybrid Attention Transformer (Chen et al., CVPR 2023, arXiv:2205.04437),
# equation by equation as XPixelGroup/HAT's ``hat_arch.py`` serves it, under
# that file's parameter names. The JAX package has no HAT: its tests hold it
# against a plain float32 torch reference. The residual stream, the
# LayerNorms' statistics, the softmax and the channel-attention gate run in
# float32 (each HAB adds its CAB branch at 0.01 of its size, which a
# bfloat16 stream would round away); the convolutions, the linear layers and
# the attention's two products in the net's ``dtype`` with float32
# accumulation. Without autograd the stream is updated in place.

class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = F.gelu(h) if torch.is_grad_enabled() else torch.ops.aten.gelu_(h)
        return self.fc2(h)


class _ChannelAttention(nn.Module):
    """HAT's squeeze-excite gate: the spatial mean, 1x1 to ``c / squeeze``,
    ReLU, 1x1 back, sigmoid (``attention.1``, ``attention.3``)."""

    def __init__(self, c: int, squeeze: int):
        super().__init__()
        self.attention = nn.ModuleList([nn.Identity(), Conv2d(c, c // squeeze, 1), nn.Identity(),
                                        Conv2d(c // squeeze, c, 1)])

    def gate(self, y: torch.Tensor) -> torch.Tensor:
        """[N, C] float32 gate of ``y`` (NCHW): the mean in float32, the 1x1
        convs in ``y``'s type, the sigmoid in float32."""
        s = y.float().mean(dim=(2, 3), keepdim=True).to(y.dtype)
        s = self.attention[3](self.attention[1](s, relu=True))
        return torch.sigmoid(s.float()).flatten(1)


class _CAB(nn.Module):
    """HAT's channel-attention block: 3x3 to ``c / compress``, GELU, 3x3 back
    (``cab.0``, ``cab.2``), gated by ``cab.3``."""

    def __init__(self, c: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.ModuleList([Conv2d(c, c // compress, 3, padding=1), nn.Identity(),
                                  Conv2d(c // compress, c, 3, padding=1),
                                  _ChannelAttention(c, squeeze)])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the branch before its gate, NHWC; the gate, [N, C] float32) of an
        NHWC map."""
        y = self.cab[2](self.cab[0](x.permute(0, 3, 1, 2), act="gelu"))
        return y.permute(0, 2, 3, 1), self.cab[3].gate(y)


def _accumulate(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y into the float32 stream: in place without autograd."""
    return x + y if torch.is_grad_enabled() else x.add_(y)


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of the float32 stream in float32, cast to ``dtype``."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


class _WindowAttention(nn.Module):
    """HAT's ``WindowAttention`` (``relative_position_bias_table``, ``qkv``,
    ``proj``), its windows by ``ops/cuda/window_attn``."""

    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        a = window_attn.window_attn(self.qkv(x), self.relative_position_bias_table, self.heads,
                                    self.window, shift=shift)
        return self.proj(a)


class _HAB(nn.Module):
    """HAT's hybrid attention block: x + attention(LN(x)) + 0.01 * CAB(LN(x)),
    then x + MLP(LN(x)); windows shifted by ``shift``."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, compress: int,
                 squeeze: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.shift, self.conv_scale = shift, conv_scale
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _WindowAttention(dim, window, heads)
        self.conv_block = _CAB(dim, compress, squeeze)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _ln(self.norm1, x, dtype)
        x = _accumulate(x, self.attn(h, self.shift))
        y, gate = self.conv_block(h)
        del h
        gate = (gate * self.conv_scale)[:, None, None, :]
        x = x + y * gate if torch.is_grad_enabled() else x.addcmul_(y, gate)
        del y
        return _accumulate(x, self.mlp(_ln(self.norm2, x, dtype)))


class _OCAB(nn.Module):
    """HAT's overlapping cross-attention block: 16^2 query windows on 24^2
    key windows (``overlap_ratio`` 0.5), then the MLP."""

    def __init__(self, dim: int, heads: int, window: int, overlap_ratio: float,
                 mlp_ratio: float):
        super().__init__()
        self.window, self.heads = window, heads
        self.overlap = int(window * overlap_ratio)
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim)
        side = 2 * window + self.overlap - 1
        self.relative_position_bias_table = nn.Parameter(torch.zeros(side * side, heads))
        self.proj = Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        qkv = self.qkv(_ln(self.norm1, x, dtype))
        a = window_attn.window_attn(qkv, self.relative_position_bias_table, self.heads,
                                    self.window, overlap=self.overlap)
        del qkv
        x = _accumulate(x, self.proj(a))
        del a
        return _accumulate(x, self.mlp(_ln(self.norm2, x, dtype)))


class _AttenBlocks(nn.Module):
    def __init__(self, dim, depth, heads, window, overlap_ratio, compress, squeeze, conv_scale,
                 mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList(
            _HAB(dim, heads, window, 0 if i % 2 == 0 else window // 2, compress, squeeze,
                 conv_scale, mlp_ratio) for i in range(depth))
        self.overlap_attn = _OCAB(dim, heads, window, overlap_ratio, mlp_ratio)


class _RHAG(nn.Module):
    """A residual hybrid attention group: the HABs and the OCAB, a 3x3 conv
    (``resi_connection`` "1conv"), plus the group's input."""

    def __init__(self, dim, depth, heads, window, overlap_ratio, compress, squeeze, conv_scale,
                 mlp_ratio):
        super().__init__()
        self.residual_group = _AttenBlocks(dim, depth, heads, window, overlap_ratio, compress,
                                           squeeze, conv_scale, mlp_ratio)
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = x.clone()
        for blk in self.residual_group.blocks:
            h = blk(h, dtype)
        h = self.residual_group.overlap_attn(h, dtype)
        y = self.conv(h.to(dtype).permute(0, 3, 1, 2))
        del h
        return _accumulate(x, y.permute(0, 2, 3, 1))


class HAT(nn.Module):
    """HAT with the ``pixelshuffle`` tail, NHWC [0, 255] in and out like the
    other nets (the published net works in [0, 1]; the scaling is the only
    wrapper). A side that is not a multiple of the window is reflect-padded
    and the output cropped, as ``hat_model.py``'s pre- and post-process do.
    Defaults: the published x2-x4 settings (``HAT_SRx3.yml``)."""

    MEAN = (0.4488, 0.4371, 0.4040)

    def __init__(self, scale: int = 3, embed_dim: int = 180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size: int = 16, overlap_ratio: float = 0.5,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 mlp_ratio: float = 2.0, img_range: float = 1.0, num_feat: int = 64,
                 channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.scale, self.dtype, self.window = scale, dtype, window_size
        self.embed_dim, self.depths, self.num_heads = embed_dim, tuple(depths), tuple(num_heads)
        self.overlap_ratio, self.compress_ratio, self.mlp_ratio = (overlap_ratio, compress_ratio,
                                                                   mlp_ratio)
        self.img_range, self.num_feat, self.channels = img_range, num_feat, channels
        self.register_buffer("mean", torch.tensor(self.MEAN).view(1, 3, 1, 1), persistent=False)
        self.conv_first = Conv2d(channels, embed_dim, 3, padding=1)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            _RHAG(embed_dim, d, h, window_size, overlap_ratio, compress_ratio, squeeze_factor,
                  conv_scale, mlp_ratio) for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.ModuleList([Conv2d(embed_dim, num_feat, 3, padding=1)])
        self.factors = _shuffle_factors(scale)
        ups = []
        for f in self.factors:
            ups += [Conv2d(num_feat, num_feat * f * f, 3, padding=1), nn.PixelShuffle(f)]
        self.upsample = nn.ModuleList(ups)
        self.conv_last = Conv2d(num_feat, channels, 3, padding=1)
        for m in self.modules():  # the LayerNorms and bias tables stay float32
            if isinstance(m, (Conv2d, Linear)):
                m.to(dtype)

    @staticmethod
    def load_kernels() -> None:
        """Build (once) and load the window-attention kernel."""
        window_attn.load_library()

    def flops_per_pixel(self) -> float:
        """Tensor-core FLOP of one pass per input pixel: every convolution
        and linear layer at the resolution it runs at, and the attention's
        two products (4 * keys * C per query: 256 keys in a HAB, 576 in an
        OCAB); the gate's 1x1 convs on pooled maps and the bias tables are
        no such work."""
        c, f = self.embed_dim, self.num_feat
        conv = lambda ci, co, k=3: 2.0 * ci * co * k * k  # noqa: E731
        hidden = int(c * self.mlp_ratio)
        mlp = 2.0 * c * hidden * 2
        ext = self.window + int(self.window * self.overlap_ratio)
        hab = (2.0 * c * 3 * c + 2.0 * c * c + mlp + conv(c, c // self.compress_ratio)
               + conv(c // self.compress_ratio, c) + 4.0 * self.window ** 2 * c)
        ocab = 2.0 * c * 3 * c + 2.0 * c * c + mlp + 4.0 * ext * ext * c
        total = conv(self.channels, c) + conv(c, c) + conv(c, f)
        total += sum(d * hab + ocab + conv(c, c) for d in self.depths)
        area = 1
        for g in self.factors:
            total += conv(f, f * g * g) * area
            area *= g * g
        return total + conv(f, self.channels) * area

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        dt = self.dtype
        ph, pw = (-h) % self.window, (-w) % self.window
        t = x.float().permute(0, 3, 1, 2) / 255.0
        if ph or pw:
            t = F.pad(t, (0, pw, 0, ph), mode="reflect")
        t = ((t - self.mean) * self.img_range).to(dt).contiguous(memory_format=torch.channels_last)
        first = self.conv_first(t)  # NCHW, channels_last
        del t
        feats = first.permute(0, 2, 3, 1).float()  # the stream, NHWC float32
        feats = F.layer_norm(feats, (self.embed_dim,), self.patch_embed.norm.weight,
                             self.patch_embed.norm.bias, self.patch_embed.norm.eps)
        for layer in self.layers:
            feats = layer(feats, dt)
        feats = _ln(self.norm, feats, dt).permute(0, 3, 1, 2)
        y = self.conv_after_body(feats, residual=first)
        del feats, first
        y = self.conv_before_upsample[0](y, act="lrelu")
        for conv, shuffle in zip(self.upsample[0::2], self.upsample[1::2]):
            y = shuffle(conv(y))
        y = self.conv_last(y).float() / self.img_range + self.mean
        y = y[:, :, :h * self.scale, :w * self.scale]
        return y.permute(0, 2, 3, 1) * 255.0


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
