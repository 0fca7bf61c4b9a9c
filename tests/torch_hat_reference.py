"""A plain float32 HAT (Chen et al., CVPR 2023, arXiv:2205.04437) in torch
ops, for the port's tests: XPixelGroup/HAT's ``hat_arch.py`` step by step
(the cyclic roll, ``window_partition``, the precomputed shift mask,
``nn.Unfold``'s overlapping key windows, the bias gathered by HAT's
relative position indices) and ``hat_model.py``'s padding and crop, on a
state dict under HAT's parameter names. It imports nothing of the port or
of the JAX package, and runs with TF32 off.

Departures, each of the wrapping only: NHWC [0, 255] in and out (the
published net takes NCHW [0, 1]); the net's input padded inside
:func:`forward` (``hat_model.pre_process`` pads before calling the net).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

MEAN = (0.4488, 0.4371, 0.4040)


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_rpi_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_rpi_oca(ws: int, overlap_ratio: float) -> torch.Tensor:
    ext = ws + int(overlap_ratio * ws)
    ori = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                                   indexing="ij")), 1)
    exf = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ext), torch.arange(ext)],
                                                   indexing="ij")), 1)
    rel = (exf[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ext + 1
    rel[:, :, 1] += ws - ext + 1
    rel[:, :, 0] *= ws + ext - 1
    return rel.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(mask == 0, float(0.0))


def layer_norm(sd, key, x):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{key}.weight"], sd[f"{key}.bias"], 1e-5)


def linear(sd, key, x):
    return F.linear(x, sd[f"{key}.weight"], sd[f"{key}.bias"])


def conv(sd, key, x, padding=1):
    return F.conv2d(x, sd[f"{key}.weight"], sd[f"{key}.bias"], padding=padding)


def mlp(sd, key, x):
    return linear(sd, f"{key}.fc2", F.gelu(linear(sd, f"{key}.fc1", x)))


def cab(sd, key, x):
    """``CAB`` on NCHW: conv, GELU, conv, channel attention."""
    y = conv(sd, f"{key}.cab.2", F.gelu(conv(sd, f"{key}.cab.0", x)))
    a = F.adaptive_avg_pool2d(y, 1)
    a = torch.sigmoid(conv(sd, f"{key}.cab.3.attention.3",
                           F.relu(conv(sd, f"{key}.cab.3.attention.1", a, 0)), 0))
    return y * a


def window_attention(sd, key, x, heads, ws, rpi, mask=None, windows_per_block=None):
    """``WindowAttention.forward`` on [windows, n, c], in blocks of windows."""
    b_, n, c = x.shape
    nw = mask.shape[0] if mask is not None else 1
    step = windows_per_block or b_
    step = max(nw, step // nw * nw) if mask is not None else step
    table = sd[f"{key}.relative_position_bias_table"]
    bias = table[rpi.view(-1)].view(ws * ws, ws * ws, -1).permute(2, 0, 1).contiguous()
    outs = []
    for i in range(0, b_, step):
        xb = x[i:i + step]
        nb = xb.shape[0]
        qkv = linear(sd, f"{key}.qkv", xb).reshape(nb, n, 3, heads, c // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (c // heads) ** -0.5
        attn = q @ k.transpose(-2, -1) + bias.unsqueeze(0)
        if mask is not None:
            attn = attn.view(nb // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        outs.append((attn @ v).transpose(1, 2).reshape(nb, n, c))
    return linear(sd, f"{key}.proj", torch.cat(outs))


def hab(sd, key, x, x_size, heads, ws, shift, rpi, mask, conv_scale, windows_per_block):
    h, w = x_size
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(sd, f"{key}.norm1", x).view(b, h, w, c)
    conv_x = cab(sd, f"{key}.conv_block", x.permute(0, 3, 1, 2))
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift > 0 else x
    xw = window_partition(shifted, ws).view(-1, ws * ws, c)
    aw = window_attention(sd, f"{key}.attn", xw, heads, ws, rpi, mask if shift > 0 else None,
                          windows_per_block).view(-1, ws, ws, c)
    shifted = window_reverse(aw, ws, h, w)
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift > 0 else shifted
    x = shortcut + attn_x.view(b, h * w, c) + conv_x * conv_scale
    return x + mlp(sd, f"{key}.mlp", layer_norm(sd, f"{key}.norm2", x))


def ocab(sd, key, x, x_size, heads, ws, overlap_ratio, rpi, windows_per_block):
    h, w = x_size
    b, _, c = x.shape
    ext = int(ws * overlap_ratio) + ws
    shortcut = x
    x = layer_norm(sd, f"{key}.norm1", x).view(b, h, w, c)
    qkv = linear(sd, f"{key}.qkv", x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    qw = window_partition(q, ws).view(-1, ws * ws, c)
    unfold = torch.nn.Unfold(kernel_size=(ext, ext), stride=ws, padding=(ext - ws) // 2)
    kvw = unfold(kv)  # b, 2c * ext * ext, windows
    nwin = kvw.shape[-1]
    kvw = kvw.view(b, 2, c, ext, ext, nwin).permute(1, 0, 5, 3, 4, 2).reshape(2, b * nwin,
                                                                              ext * ext, c)
    kw_, vw_ = kvw[0], kvw[1]
    d = c // heads
    table = sd[f"{key}.relative_position_bias_table"]
    bias = table[rpi.view(-1)].view(ws * ws, ext * ext, -1).permute(2, 0, 1).contiguous()
    step = windows_per_block or qw.shape[0]
    outs = []
    for i in range(0, qw.shape[0], step):
        qb = qw[i:i + step].reshape(-1, ws * ws, heads, d).permute(0, 2, 1, 3)
        kb = kw_[i:i + step].reshape(-1, ext * ext, heads, d).permute(0, 2, 1, 3)
        vb = vw_[i:i + step].reshape(-1, ext * ext, heads, d).permute(0, 2, 1, 3)
        attn = torch.softmax((qb * d ** -0.5) @ kb.transpose(-2, -1) + bias.unsqueeze(0), -1)
        outs.append((attn @ vb).transpose(1, 2).reshape(-1, ws * ws, c))
    aw = torch.cat(outs).view(-1, ws, ws, c)
    x = window_reverse(aw, ws, h, w).view(b, h * w, c)
    x = linear(sd, f"{key}.proj", x) + shortcut
    return x + mlp(sd, f"{key}.mlp", layer_norm(sd, f"{key}.norm2", x))


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, scale: int, depths=(6,) * 6,
            heads=(6,) * 6, window_size: int = 16, overlap_ratio: float = 0.5,
            conv_scale: float = 0.01, img_range: float = 1.0,
            windows_per_block: int = None) -> torch.Tensor:
    """HAT x``scale`` with the pixel-shuffle tail on an NHWC [0, 255] batch,
    in float32: [N, H * scale, W * scale, 3]."""
    with no_tf32():
        return _forward(sd, x, scale, depths, heads, window_size, overlap_ratio, conv_scale,
                        img_range, windows_per_block)


def _forward(sd, x, scale, depths, heads, ws, overlap_ratio, conv_scale, img_range, wpb):
    sd = {k: v.float() for k, v in sd.items()}
    img = x.float().permute(0, 3, 1, 2) / 255.0
    _, _, h0, w0 = img.shape
    ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
    img = F.pad(img, (0, pw, 0, ph), "reflect")  # hat_model.pre_process
    mean = torch.tensor(MEAN, device=img.device).view(1, 3, 1, 1)
    t = (img - mean) * img_range
    first = conv(sd, "conv_first", t)
    b, c, h, w = first.shape
    rpi_sa, rpi_oca = calculate_rpi_sa(ws).to(t.device), calculate_rpi_oca(
        ws, overlap_ratio).to(t.device)
    mask = calculate_mask(h, w, ws, ws // 2).to(t.device)
    feats = layer_norm(sd, "patch_embed.norm", first.flatten(2).transpose(1, 2))
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        key = f"layers.{i}.residual_group"
        y = feats
        for j in range(depth):
            y = hab(sd, f"{key}.blocks.{j}", y, (h, w), nh, ws, 0 if j % 2 == 0 else ws // 2,
                    rpi_sa, mask, conv_scale, wpb)
        y = ocab(sd, f"{key}.overlap_attn", y, (h, w), nh, ws, overlap_ratio, rpi_oca, wpb)
        y = conv(sd, f"layers.{i}.conv", y.transpose(1, 2).view(b, c, h, w))
        feats = y.flatten(2).transpose(1, 2) + feats
    feats = layer_norm(sd, "norm", feats).transpose(1, 2).view(b, c, h, w)
    y = conv(sd, "conv_after_body", feats) + first
    y = F.leaky_relu(conv(sd, "conv_before_upsample.0", y), 0.01)
    i = 0
    while f"upsample.{i}.weight" in sd:
        f = int(round((sd[f"upsample.{i}.weight"].shape[0] / y.shape[1]) ** 0.5))
        y = F.pixel_shuffle(conv(sd, f"upsample.{i}", y), f)
        i += 2
    y = conv(sd, "conv_last", y) / img_range + mean
    y = y[:, :, :h0 * scale, :w0 * scale]  # hat_model.post_process
    return y.permute(0, 2, 3, 1) * 255.0


def shapes(scale: int, embed_dim: int = 180, depths=(6,) * 6, heads=(6,) * 6,
           window_size: int = 16, overlap_ratio: float = 0.5, compress_ratio: int = 3,
           squeeze_factor: int = 30, mlp_ratio: float = 2.0, num_feat: int = 64
           ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, under HAT's names."""
    c, ext = embed_dim, window_size + int(window_size * overlap_ratio)
    out = {"conv_first.weight": (c, 3, 3, 3), "conv_first.bias": (c,),
           "patch_embed.norm.weight": (c,), "patch_embed.norm.bias": (c,)}

    def lin(key, i, o):
        out[f"{key}.weight"], out[f"{key}.bias"] = (o, i), (o,)

    def cv(key, i, o, k=3):
        out[f"{key}.weight"], out[f"{key}.bias"] = (o, i, k, k), (o,)

    def ln(key):
        out[f"{key}.weight"], out[f"{key}.bias"] = (c,), (c,)

    hidden = int(c * mlp_ratio)
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        key = f"layers.{i}.residual_group"
        for j in range(depth):
            bk = f"{key}.blocks.{j}"
            ln(f"{bk}.norm1")
            out[f"{bk}.attn.relative_position_bias_table"] = ((2 * window_size - 1) ** 2, nh)
            lin(f"{bk}.attn.qkv", c, 3 * c)
            lin(f"{bk}.attn.proj", c, c)
            cv(f"{bk}.conv_block.cab.0", c, c // compress_ratio)
            cv(f"{bk}.conv_block.cab.2", c // compress_ratio, c)
            cv(f"{bk}.conv_block.cab.3.attention.1", c, c // squeeze_factor, 1)
            cv(f"{bk}.conv_block.cab.3.attention.3", c // squeeze_factor, c, 1)
            ln(f"{bk}.norm2")
            lin(f"{bk}.mlp.fc1", c, hidden)
            lin(f"{bk}.mlp.fc2", hidden, c)
        ok = f"{key}.overlap_attn"
        ln(f"{ok}.norm1")
        lin(f"{ok}.qkv", c, 3 * c)
        out[f"{ok}.relative_position_bias_table"] = ((window_size + ext - 1) ** 2, nh)
        lin(f"{ok}.proj", c, c)
        ln(f"{ok}.norm2")
        lin(f"{ok}.mlp.fc1", c, hidden)
        lin(f"{ok}.mlp.fc2", hidden, c)
        cv(f"layers.{i}.conv", c, c)
    ln("norm")
    cv("conv_after_body", c, c)
    cv("conv_before_upsample.0", c, num_feat)
    s, i = scale, 0
    factors = [2] * (s.bit_length() - 1) if s & (s - 1) == 0 else [3]
    for f in factors:
        cv(f"upsample.{i}", num_feat, num_feat * f * f)
        i += 2
    cv("conv_last", num_feat, 3)
    return out
