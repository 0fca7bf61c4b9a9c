"""HAT, the Hybrid Attention Transformer (Chen et al., CVPR 2023,
arXiv:2205.04437), with the ``pixelshuffle`` tail, as XPixelGroup/HAT's
``hat_arch.py`` computes it, step by step: the mean shift and
``conv_first``; the patch-embed LayerNorm; residual hybrid attention
groups (RHAGs), each of hybrid attention blocks (HABs: LayerNorm, window
attention over the map rolled by half a window on every second block with
HAT's -100 mask, plus a channel-attention block (CAB) at ``conv_scale``,
then LayerNorm and a GELU MLP), one overlapping cross-attention block
(OCAB: 16^2 query windows on ``nn.Unfold``'s 24^2 key windows of the
zero-padded projected k and v), a 3x3 conv and the group's input; the
final LayerNorm, ``conv_after_body`` plus ``conv_first``'s output;
``conv_before_upsample`` with LeakyReLU, the shuffle convs and
``conv_last``. Inputs whose sides are no multiple of the window are
reflect-padded and the output cropped (``hat_model.py``). The net works
in [0, 1]; NHWC [0, 255] in and out is the only wrapper. No bicubic skip.

The attention runs in blocks of windows (``_WINDOWS`` at a time, and the
OCAB's unfold over a band of window rows), so that a 1536^2 tile fits a
card: the same arithmetic as HAT's whole-map tensors. Every convolution,
linear layer and attention product goes through ``ops``.

The configuration's ``nets`` entry names the published widths
(``HAT_SRx3.yml``): ``embed_dim``, ``depths``, ``num_heads``,
``window_size``, ``overlap_ratio``, ``compress_ratio``,
``squeeze_factor``, ``conv_scale``, ``mlp_ratio``, ``img_range``,
``num_feat``, ``channels``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import factors

MEAN = (0.4488, 0.4371, 0.4040)
# Windows whose scores one step of the plain attention holds.
_WINDOWS = 256
# ``conv_last``'s share of PyTorch's default draw in ``init``. At 1 (the
# draw unscaled) the output of the full-width x3 net varies by 10-40 LSB
# about its channel means with under 1% of pixels clipped: measured on the
# CPU on 48x48 crops of the cell's six renders, 15.3-24.0 LSB and no pixel
# outside [0, 255]; at 2, 30.6-48.0 LSB and up to 0.08% clipped; at 0.3,
# under 8 LSB.
TAIL_GAIN = 1.0


def _spec(spec: Dict):
    g = lambda k, d: spec.get(k, d)  # noqa: E731
    return dict(c=int(g("embed_dim", 180)), depths=[int(v) for v in g("depths", [6] * 6)],
                heads=[int(v) for v in g("num_heads", [6] * 6)], ws=int(g("window_size", 16)),
                ratio=float(g("overlap_ratio", 0.5)), compress=int(g("compress_ratio", 3)),
                squeeze=int(g("squeeze_factor", 30)), conv_scale=float(g("conv_scale", 0.01)),
                mlp_ratio=float(g("mlp_ratio", 2.0)), img_range=float(g("img_range", 1.0)),
                feat=int(g("num_feat", 64)), channels=int(g("channels", 3)))


# -- HAT's index arithmetic, as hat_arch.py computes it ----------------------------

def calculate_rpi_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_rpi_oca(ws: int, ratio: float) -> torch.Tensor:
    ext = ws + int(ratio * ws)
    ori = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                                   indexing="ij")), 1)
    exf = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ext), torch.arange(ext)],
                                                   indexing="ij")), 1)
    rel = (exf[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ext + 1
    rel[:, :, 1] += ws - ext + 1
    rel[:, :, 0] *= ws + ext - 1
    return rel.sum(-1)  # below 0 in places: PyTorch's indexing wraps those


def calculate_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(mask == 0, float(0.0))


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


# -- the pass ----------------------------------------------------------------------

def forward(sd: Dict[str, torch.Tensor], spec: Dict, scale: int, x: torch.Tensor, ops):
    p = _spec(spec)
    ws = p["ws"]
    img = x.permute(0, 3, 1, 2) / 255.0
    _, _, h0, w0 = img.shape
    ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
    img = F.pad(img, (0, pw, 0, ph), "reflect")  # hat_model.pre_process
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)

    def conv(key, t, padding=1):
        return ops.conv(t, sd[f"{key}.weight"], sd[f"{key}.bias"], padding)

    def linear(key, t):
        return ops.linear(t, sd[f"{key}.weight"], sd[f"{key}.bias"])

    def ln(key, t):
        return F.layer_norm(t, (t.shape[-1],), sd[f"{key}.weight"], sd[f"{key}.bias"], 1e-5)

    def mlp(key, t):
        return linear(f"{key}.fc2", F.gelu(linear(f"{key}.fc1", t)))

    first = conv("conv_first", (img - mean) * p["img_range"])
    del img
    b, c, h, w = first.shape
    rpi_sa = calculate_rpi_sa(ws).to(x.device)
    rpi_oca = calculate_rpi_oca(ws, p["ratio"]).to(x.device)
    mask = calculate_mask(h, w, ws, ws // 2, x.device)
    feats = ln("patch_embed.norm", first.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(p["depths"], p["heads"])):
        key = f"layers.{i}.residual_group"
        y = feats
        for j in range(depth):
            y = _hab(sd, f"{key}.blocks.{j}", y, (h, w), heads, ws, 0 if j % 2 == 0 else ws // 2,
                     rpi_sa, mask, p, conv, linear, ln, mlp, ops)
        y = _ocab(sd, f"{key}.overlap_attn", y, (h, w), heads, ws, p["ratio"], rpi_oca, linear,
                  ln, mlp, ops)
        y = conv(f"layers.{i}.conv", y.transpose(1, 2).reshape(b, c, h, w))
        feats = y.flatten(2).transpose(1, 2) + feats
        del y
    del mask
    feats = ln("norm", feats).transpose(1, 2).reshape(b, c, h, w)
    y = conv("conv_after_body", feats) + first
    del feats, first
    y = F.leaky_relu(conv("conv_before_upsample.0", y), 0.01)
    for k, f in enumerate(factors(scale)):
        y = F.pixel_shuffle(conv(f"upsample.{2 * k}", y), f)
    y = conv("conv_last", y) / p["img_range"] + mean
    y = y[:, :, :h0 * scale, :w0 * scale]  # hat_model.post_process
    return y.permute(0, 2, 3, 1) * 255.0


def _cab(key, x, conv):
    y = conv(f"{key}.cab.2", F.gelu(conv(f"{key}.cab.0", x)))
    a = F.adaptive_avg_pool2d(y, 1)
    a = torch.sigmoid(conv(f"{key}.cab.3.attention.3",
                           F.relu(conv(f"{key}.cab.3.attention.1", a, 0)), 0))
    return y * a


def _window_attention(sd, key, xw, heads, ws, rpi, mask, linear, ops):
    """``WindowAttention.forward`` over [windows, n, c], ``_WINDOWS`` at a
    time; window i takes ``mask[i % len(mask)]``."""
    n_all, n, c = xw.shape
    d = c // heads
    table = sd[f"{key}.relative_position_bias_table"]
    bias = table[rpi.view(-1)].view(ws * ws, ws * ws, -1).permute(2, 0, 1).contiguous()
    out = torch.empty_like(xw)
    for i in range(0, n_all, _WINDOWS):
        xb = xw[i:i + _WINDOWS]
        nb = xb.shape[0]
        qkv = linear(f"{key}.qkv", xb).reshape(nb, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * d ** -0.5
        attn = ops.matmul(q, k.transpose(-2, -1)) + bias.unsqueeze(0)
        if mask is not None:
            idx = torch.arange(i, i + nb, device=xw.device) % mask.shape[0]
            attn = attn + mask[idx].unsqueeze(1)
        attn = torch.softmax(attn, dim=-1)
        out[i:i + nb] = ops.matmul(attn, v).transpose(1, 2).reshape(nb, n, c)
    return linear(f"{key}.proj", out)


def _hab(sd, key, x, x_size, heads, ws, shift, rpi, mask, p, conv, linear, ln, mlp, ops):
    h, w = x_size
    b, _, c = x.shape
    shortcut = x
    x = ln(f"{key}.norm1", x).view(b, h, w, c)
    conv_x = _cab(f"{key}.conv_block", x.permute(0, 3, 1, 2), conv)
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift > 0 else x
    del x
    xw = window_partition(shifted, ws).view(-1, ws * ws, c)
    del shifted
    aw = _window_attention(sd, f"{key}.attn", xw, heads, ws, rpi, mask if shift > 0 else None,
                           linear, ops).view(-1, ws, ws, c)
    del xw
    shifted = window_reverse(aw, ws, h, w)
    del aw
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift > 0 else shifted
    x = shortcut + attn_x.view(b, h * w, c) + conv_x * p["conv_scale"]
    del attn_x, conv_x
    return x + mlp(f"{key}.mlp", ln(f"{key}.norm2", x))


def _ocab(sd, key, x, x_size, heads, ws, ratio, rpi, linear, ln, mlp, ops):
    h, w = x_size
    b, _, c = x.shape
    ext = int(ws * ratio) + ws
    pad = (ext - ws) // 2
    d = c // heads
    shortcut = x
    x = ln(f"{key}.norm1", x).view(b, h, w, c)
    qkv = linear(f"{key}.qkv", x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    del x
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)  # b, 2c, h, w
    del qkv
    qw = window_partition(q, ws).view(b, h // ws, w // ws, ws * ws, c)
    del q
    # nn.Unfold(ext, stride ws, padding pad) of the whole map, a band of window
    # rows at a time: the band's rows of the zero-padded map, unfolded unpadded
    kvp = F.pad(kv, (pad, pad, pad, pad))
    del kv
    unfold = torch.nn.Unfold(kernel_size=(ext, ext), stride=ws)
    table = sd[f"{key}.relative_position_bias_table"]
    bias = table[rpi.view(-1)].view(ws * ws, ext * ext, -1).permute(2, 0, 1).contiguous()
    rows = max(1, _WINDOWS // (w // ws))
    out = torch.empty((b, h // ws, w // ws, ws * ws, c), device=shortcut.device)
    for r0 in range(0, h // ws, rows):
        r1 = min(h // ws, r0 + rows)
        band = kvp[:, :, r0 * ws:r1 * ws + 2 * pad]
        kvw = unfold(band)  # b, 2c * ext * ext, windows of the band
        nw = kvw.shape[-1]
        kvw = kvw.view(b, 2, c, ext, ext, nw).permute(1, 0, 5, 3, 4, 2).reshape(
            2, b * nw, ext * ext, c)
        kb = kvw[0].reshape(-1, ext * ext, heads, d).permute(0, 2, 1, 3)
        vb = kvw[1].reshape(-1, ext * ext, heads, d).permute(0, 2, 1, 3)
        qb = qw[:, r0:r1].reshape(-1, ws * ws, heads, d).permute(0, 2, 1, 3) * d ** -0.5
        attn = torch.softmax(ops.matmul(qb, kb.transpose(-2, -1)) + bias.unsqueeze(0), dim=-1)
        out[:, r0:r1] = ops.matmul(attn, vb).transpose(1, 2).reshape(b, r1 - r0, w // ws,
                                                                     ws * ws, c)
        del kvw, kb, vb, qb, attn
    del kvp, qw
    x = window_reverse(out.view(-1, ws, ws, c), ws, h, w).view(b, h * w, c)
    del out
    x = linear(f"{key}.proj", x) + shortcut
    return x + mlp(f"{key}.mlp", ln(f"{key}.norm2", x))


# -- work, weights and convolutions ----------------------------------------------------

def layers(spec: Dict, scale: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(parameter name, shape) of every tensor, under HAT's names."""
    p = _spec(spec)
    c, ws = p["c"], p["ws"]
    ext = ws + int(ws * p["ratio"])
    hidden = int(c * p["mlp_ratio"])
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def cv(key, i, o, k=3):
        out.extend([(f"{key}.weight", (o, i, k, k)), (f"{key}.bias", (o,))])

    def lin(key, i, o):
        out.extend([(f"{key}.weight", (o, i)), (f"{key}.bias", (o,))])

    def ln(key):
        out.extend([(f"{key}.weight", (c,)), (f"{key}.bias", (c,))])

    cv("conv_first", p["channels"], c)
    ln("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(p["depths"], p["heads"])):
        key = f"layers.{i}.residual_group"
        for j in range(depth):
            bk = f"{key}.blocks.{j}"
            ln(f"{bk}.norm1")
            out.append((f"{bk}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads)))
            lin(f"{bk}.attn.qkv", c, 3 * c)
            lin(f"{bk}.attn.proj", c, c)
            cv(f"{bk}.conv_block.cab.0", c, c // p["compress"])
            cv(f"{bk}.conv_block.cab.2", c // p["compress"], c)
            cv(f"{bk}.conv_block.cab.3.attention.1", c, c // p["squeeze"], 1)
            cv(f"{bk}.conv_block.cab.3.attention.3", c // p["squeeze"], c, 1)
            ln(f"{bk}.norm2")
            lin(f"{bk}.mlp.fc1", c, hidden)
            lin(f"{bk}.mlp.fc2", hidden, c)
        ok = f"{key}.overlap_attn"
        ln(f"{ok}.norm1")
        lin(f"{ok}.qkv", c, 3 * c)
        out.append((f"{ok}.relative_position_bias_table", ((ws + ext - 1) ** 2, heads)))
        lin(f"{ok}.proj", c, c)
        ln(f"{ok}.norm2")
        lin(f"{ok}.mlp.fc1", c, hidden)
        lin(f"{ok}.mlp.fc2", hidden, c)
        cv(f"layers.{i}.conv", c, c)
    ln("norm")
    cv("conv_after_body", c, c)
    cv("conv_before_upsample.0", c, p["feat"])
    for k, f in enumerate(factors(scale)):
        cv(f"upsample.{2 * k}", p["feat"], p["feat"] * f * f)
    cv("conv_last", p["feat"], p["channels"])
    return out


def _require_program_hat() -> None:
    """Stop a benchmark run whose program has no HAT. Its registry would not
    serve the seeded ``hat_x3.pt``, and its job layer would serve the cell's
    jobs by another net without a word and print a result line, which
    measures something else; so the run ends in its set-up, before any
    window. Only a program already loaded in the process is looked at: the
    reference never imports it, and without it nothing is checked."""
    import sys

    registry = sys.modules.get("srs_tpu_torch.models.registry")
    if registry is not None and "hat" not in registry.MODEL_REGISTRY:
        raise RuntimeError("the program's registry has no 'hat' net: it cannot run HAT")


def init(spec: Dict, scale: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """HAT's ``_init_weights``: linear weights and the bias tables from a
    normal of std 0.02 truncated at +-2 (timm's ``trunc_normal_``), linear
    biases 0, LayerNorms 1 and 0; convolutions PyTorch's default draw
    (weights and biases uniform in +-1 / sqrt(fan_in)), ``conv_last``'s
    weights times ``TAIL_GAIN``. Drawn in ``layers``' order from
    ``generator``, once a loaded program is found to serve HAT."""
    _require_program_hat()
    sd = {}
    for key, shape in layers(spec, scale):
        name = key.rsplit(".", 1)[0]
        is_norm = name.endswith(("norm", "norm1", "norm2")) or name == "norm"
        if key.endswith("relative_position_bias_table") or (len(shape) == 2 and
                                                            key.endswith("weight")):
            sd[key] = torch.nn.init.trunc_normal_(torch.empty(shape), std=0.02, a=-2.0, b=2.0,
                                                  generator=generator)
        elif is_norm:
            sd[key] = torch.ones(shape) if key.endswith("weight") else torch.zeros(shape)
        elif len(shape) == 4 or (len(shape) == 1 and sd.get(f"{name}.weight") is not None
                                 and sd[f"{name}.weight"].dim() == 4):
            fan_in = math.prod(shape[1:]) if len(shape) == 4 else math.prod(
                sd[f"{name}.weight"].shape[1:])
            bound = 1.0 / math.sqrt(fan_in)
            t = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
            sd[key] = t * TAIL_GAIN if key == "conv_last.weight" else t
        else:  # a linear layer's bias
            sd[key] = torch.zeros(shape)
    return sd


def flops_per_pixel(spec: Dict, scale: int) -> float:
    """Every convolution and linear layer at the resolution it runs at, per
    input pixel, and the attention's two products (4 * keys * C per query:
    window^2 keys in a HAB, (window + overlap)^2 in an OCAB); the gate's 1x1
    convolutions on pooled maps and the bias tables are no such work."""
    p = _spec(spec)
    c, f, ws = p["c"], p["feat"], p["ws"]
    ext = ws + int(ws * p["ratio"])
    conv = lambda ci, co, k=3: 2.0 * ci * co * k * k  # noqa: E731
    mlp = 2 * 2.0 * c * int(c * p["mlp_ratio"])
    hab = (2.0 * c * 3 * c + 2.0 * c * c + mlp + conv(c, c // p["compress"])
           + conv(c // p["compress"], c) + 4.0 * ws * ws * c)
    ocab = 2.0 * c * 3 * c + 2.0 * c * c + mlp + 4.0 * ext * ext * c
    total = conv(p["channels"], c) + conv(c, c) + conv(c, f)
    total += sum(d * hab + ocab + conv(c, c) for d in p["depths"])
    area = 1
    for g in factors(scale):
        total += conv(f, f * g * g) * area
        area *= g * g
    return total + conv(f, p["channels"]) * area


def convs(spec: Dict, scale: int) -> List[Tuple]:
    """Each convolution in the program's launch order, with its epilogue
    form ("gelu" after the CAB's first, "lrelu" after
    ``conv_before_upsample``, "residual" at scale 1 for
    ``conv_after_body``) and its output pixels per input pixel."""
    p = _spec(spec)
    c, f, ch = p["c"], p["feat"], p["channels"]
    out = [(c, ch, 3, 3, "bias", 1)]
    for depth in p["depths"]:
        for _ in range(depth):
            out += [(c // p["compress"], c, 3, 3, "gelu", 1), (c, c // p["compress"], 3, 3, "bias", 1),
                    (c // p["squeeze"], c, 1, 1, "relu", 0), (c, c // p["squeeze"], 1, 1, "bias", 0)]
        out.append((c, c, 3, 3, "bias", 1))
    out += [(c, c, 3, 3, "residual", 1), (f, c, 3, 3, "lrelu", 1)]
    area = 1
    for g in factors(scale):
        out.append((f * g * g, f, 3, 3, "bias", area))
        area *= g * g
    out.append((ch, f, 3, 3, "bias", area))
    return out


# Bytes of a value of q, k, v and the output as the program's counters count them.
_ATTN_BYTES = 2


def attention_work(spec: Dict, scale: int, pixels: float) -> Dict[str, Tuple[float, float]]:
    """(FLOP, bytes) by launch class ("hab", "ocab") of every attention
    launch of passes over ``pixels`` input pixels (sides multiples of the
    window): the two products, 2 * queries * keys * C each, and q, k, v and
    the output read or written once each in bfloat16."""
    p = _spec(spec)
    c, ws = p["c"], p["ws"]
    ext = ws + int(ws * p["ratio"])
    per = 4.0 * pixels * c * _ATTN_BYTES
    habs, ocabs = sum(p["depths"]), len(p["depths"])
    return {"hab": (habs * 4.0 * pixels * ws * ws * c, habs * per),
            "ocab": (ocabs * 4.0 * pixels * ext * ext * c, ocabs * per)}


def image_attention(config: Dict) -> Dict[str, Tuple[float, float]]:
    """``attention_work`` of one image of ``config``: every pass of every
    HAT member of each ladder step over the step's tile batch."""
    route, specs = config["route"], config["nets"]
    res, out = int(route["block"]), {}
    for scale, members in zip(route["ladder"], route["steps"]):
        px = res * res * int(route["tiles"])
        for name, passes in members:
            if specs[name]["kind"] != "hat":
                continue
            for cls, (fl, by) in attention_work(specs[name], int(scale), px).items():
                f0, b0 = out.get(cls, (0.0, 0.0))
                out[cls] = (f0 + passes * fl, b0 + passes * by)
        res *= int(scale)
    return out
