"""The learned generator: a class-conditional diffusion model (port of
``srs_tpu/models/generative.py``).

- :class:`CondUNet`, a v-prediction UNet with single-head attention at
  the coarsest level, conditioned on the timestep and one of the eight
  visual classes of :data:`ARK_CLASSES` (index ``n_classes`` is the
  unconditional token of classifier-free guidance). NHWC in and out, like
  the port's SR nets; inside, NCHW views. Parameters are float32 and
  every convolution and linear layer runs in ``dtype`` (bfloat16 by
  default), casting them as it runs, as flax's ``nn.Conv(dtype=...)``
  does; GroupNorm runs in float32.
- :func:`sample_ark`, DDIM (eta 0) on the cosine schedule with both
  guidance branches in one batched UNet call a step; :func:`refine_ark`,
  SDEdit on overlapping tiles at the model's native size, merged with the
  ramp weights of the tiling layout.
- :func:`train_ark` on torch autograd: v-target MSE with label dropout
  and horizontal flips, the reference's clip-then-Adam
  (``models/train.make_optimizer``) and an EMA of the weights, saved as
  ``ark_gen_x1.pt`` with an ``ark_meta.json`` sidecar.
- :func:`build_ark` takes a state dict handed in (:func:`convert_ark_params`
  turns the reference's flax tree into one), else reads that checkpoint
  from a directory, else the store's generator (``ark_gen_x1.srsw`` with
  the store's ``ark_meta.json``, converted from the reference's packaged
  one): the reference's order. The reference's orbax checkpoints are
  never read.

The reference draws its noise from ``jax.random``; the port draws from a
``torch.Generator`` seeded with the same integer, so the values differ.
:func:`sample_ark` and :func:`refine_ark` take the draws as arguments
(``noise``, ``eps``) so that a test can hand in the reference's.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import zipfile
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .nets import Conv2d, Linear
from .registry import _torch_dtype

__all__ = [
    "ARK_CLASSES",
    "CondUNet",
    "class_for_prompt",
    "render_class",
    "make_class_corpus",
    "alpha_bar",
    "ark_loss",
    "convert_ark_params",
    "init_ark_params",
    "train_ark",
    "sample_ark",
    "refine_ark",
    "build_ark",
    "is_ark_trained",
    "ark_meta",
    "clear_ark_cache",
]

# ---------------------------------------------------------------------
# Classes and prompt mapping (reference generative.py:60-128)
# ---------------------------------------------------------------------

#: The 8 visual families the generator is conditioned on; each has a
#: deterministic renderer in :func:`render_class`.
ARK_CLASSES: Tuple[str, ...] = (
    "graphic",   # flat color cells + line/glyph overlays (ad graphics)
    "document",  # text pages / posters
    "shaded",    # smooth studio shading + sharp foreground edges
    "pattern",   # periodic structure (weaves, grids)
    "texture",   # fractal micro-texture (grain, surfaces)
    "natural",   # 1/f natural-statistics fields with edge overlays
    "scene",     # layered photo-statistics scenes (render_photo)
    "photo",     # real bundled photograph mosaics
)

# Industry prompt category (models/prompts.py) -> default class.
_CATEGORY_CLASS: Dict[str, str] = {
    "beauty": "scene",
    "3c": "graphic",
    "food": "photo",
    "fashion": "pattern",
    "jewelry": "shaded",
    "furniture": "photo",
    "automotive": "shaded",
    "general": "scene",
}

# Keyword routing (checked in order, first hit wins) for free-text
# prompts that name a visual family directly.
_KEYWORD_CLASS: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("text", "document", "poster", "page", "typography"), "document"),
    (("pattern", "grid", "weave", "tile", "stripe", "checker"), "pattern"),
    (("texture", "grain", "surface", "material"), "texture"),
    (("abstract", "noise", "organic field"), "natural"),
    (("photo", "photograph", "realistic", "camera"), "photo"),
    (("scene", "landscape", "still life", "product shot"), "scene"),
    (("logo", "icon", "graphic", "chart", "illustration"), "graphic"),
    (("gradient", "studio", "glossy", "metallic"), "shaded"),
)


def class_for_prompt(prompt: str, category: Optional[str] = None) -> int:
    """Conditioning class index for a prompt (and optional template
    category): a keyword of the prompt (whole words) wins, then the
    category, then the prompt as a category name, then 'scene'."""
    low = (prompt or "").lower()
    for words, cls in _KEYWORD_CLASS:
        if any(re.search(r"\b" + re.escape(w) + r"\b", low) for w in words):
            return ARK_CLASSES.index(cls)
    if category:
        cls = _CATEGORY_CLASS.get(category)
        if cls:
            return ARK_CLASSES.index(cls)
    cls = _CATEGORY_CLASS.get(low.strip())
    if cls:
        return ARK_CLASSES.index(cls)
    return ARK_CLASSES.index("scene")


# ---------------------------------------------------------------------
# Class-labelled training corpus (reference generative.py:131-210)
# ---------------------------------------------------------------------


def render_class(seed: int, cls: int, size: int = 64) -> np.ndarray:
    """One deterministic [size, size, 3] float32 [0, 255] image of a class,
    drawn by the corpus renderers (``models/corpus.py``; 'photo' from the
    bundled photographs of ``models/photo_data.py``, or the scene
    renderer when none is installed)."""
    from . import corpus as C

    name = ARK_CLASSES[cls]
    rng = np.random.default_rng((seed * 8 + cls) ^ 0x9E3779B9)
    s = int(rng.integers(1, 2**31))
    if name == "graphic":
        img = C._voronoi(rng, size, int(rng.integers(6, 24)))
        img = C._draw_overlays(rng, img)
    elif name == "document":
        img = C._document(rng, size)
    elif name == "shaded":
        img = C._gradient(rng, size)
        if rng.random() < 0.7:
            img = C._draw_overlays(rng, img)
    elif name == "pattern":
        img = C._pattern(rng, size)
    elif name == "texture":
        img = C._fractal_noise(rng, size, rng.uniform(1.0, 2.2))
        if rng.random() < 0.5:
            img = C._draw_overlays(rng, img)
    elif name == "natural":
        img = C.render_natural(s, size)
    elif name == "scene":
        img = C.render_photo(s, size)
    else:  # photo
        from .photo_data import photo_mosaic

        img = photo_mosaic(s, size)
        if img is None:
            img = C.render_photo(s, size)
    return np.clip(np.asarray(img, np.float32), 0.0, 255.0)


def make_class_corpus(
    n_per_class: int, size: int = 64, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """([N, size, size, 3] float32, [N] int32 labels), N = n_per_class * 8,
    class by class.

    Rendering is slow on the host, so the result is cached in the
    temporary directory, keyed by (n, size, seed, photo count). The cache
    is written to a temporary name and renamed into place, so a
    concurrent reader never sees half a file; an unreadable cache is
    rendered anew."""
    from .photo_data import photo_paths

    cache = os.path.join(
        tempfile.gettempdir(),
        f"srs_tpu_torch_ark_corpus_{n_per_class}x{size}_s{seed}_{len(photo_paths())}p.npz",
    )
    if os.path.isfile(cache):
        try:
            with np.load(cache) as z:
                return z["x"], z["y"]
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass
    xs, ys = [], []
    for c in range(len(ARK_CLASSES)):
        for i in range(n_per_class):
            xs.append(render_class(seed + i, c, size))
            ys.append(c)
    x = np.stack(xs).astype(np.float32)
    y = np.asarray(ys, np.int32)
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, x=x, y=y)
        os.replace(tmp, cache)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
    return x, y


# ---------------------------------------------------------------------
# Denoiser network (reference generative.py:217-318)
# ---------------------------------------------------------------------

def _linspace(start: float, stop: float, num: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 with XLA's roundings
    on the CPU (computed on the host in numpy's IEEE float32): the step
    ``i / div`` is ``i * (1 / div)``, and the constant factor is folded,
    ``stop * (i * r)`` becoming ``i * (stop * r)``; the last value is
    ``stop``. Exact for the schedules here, where one end is 0."""
    lo, hi = np.float32(start), np.float32(stop)
    if num == 1:
        return torch.tensor([lo], device=device)
    r = np.float32(1) / np.float32(num - 1)
    i = np.arange(num - 1, dtype=np.float32)
    vals = np.append(lo * (np.float32(1) - i * r) + i * (hi * r), hi).astype(np.float32)
    return torch.from_numpy(vals).to(device)


def _timestep_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of continuous t in [0, 1] -> (..., dim):
    ``[sin, cos]`` of t times frequencies rising from 1 to 1000."""
    half = dim // 2
    freqs = torch.exp(_linspace(0.0, math.log(1000.0), half, device=t.device))
    ang = t.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups=min(32, C // 4), dtype=float32)``:
    statistics and output in float32 whatever the input's type, epsilon
    1e-6 (torch's default is 1e-5)."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels // 4), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) of flax's ``SAME`` padding of ``n`` samples for a
    window ``k`` at stride ``s``: the output has ceil(n / s) samples and
    the odd sample of padding goes after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _DownConv(Conv2d):
    """The 3x3 stride-2 convolution with flax's ``SAME`` padding: on an
    even input 0 before and 1 after (``padding=1`` would shift every coarse
    level by a pixel), on an odd one 1 and 1."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = _same_pad(x.shape[-2], 3, 2)
        left, right = _same_pad(x.shape[-1], 3, 2)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class _ResBlock(nn.Module):
    """GroupNorm, SiLU, conv; plus the embedding's projection; GroupNorm,
    SiLU, a zero-initialised conv; a 1x1 conv on the skip when the width
    changes (reference generative.py:225-241)."""

    def __init__(self, cin: int, ch: int, emb_ch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm0 = _GroupNorm(cin)
        self.conv0 = Conv2d(cin, ch, 3, padding=1)
        self.dense = Linear(emb_ch, ch)
        self.norm1 = _GroupNorm(ch)
        self.conv1 = Conv2d(ch, ch, 3, padding=1)
        self.skip = Conv2d(cin, ch, 1) if cin != ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x)).to(self.dtype))
        h = h + self.dense(F.silu(emb))[:, :, None, None]
        h = self.conv1(F.silu(self.norm1(h)).to(self.dtype))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class _Attn(nn.Module):
    """Single-head self-attention over the h*w positions at full width c
    (reference generative.py:244-261): ``q @ k^T`` in the compute type,
    cast to float32 and divided by sqrt(c), softmax in float32, cast back,
    times v; a zero-initialised output projection on the residual."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = _GroupNorm(c)
        self.qkv = Linear(c, 3 * c)
        self.proj = Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = self.norm(x).to(self.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.qkv(tokens).split(c, dim=-1)
        scores = torch.matmul(q, k.transpose(1, 2)).float() / math.sqrt(c)
        att = torch.softmax(scores, dim=-1).to(self.dtype)
        out = self.proj(torch.matmul(att, v))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class CondUNet(nn.Module):
    """Class-conditional v-prediction UNet (reference generative.py:264-318).

    ``forward(x, t, y)``: x [B, S, S, 3] in [-1, 1], t [B] in [0, 1], y [B]
    integer class in [0, n_classes] (``n_classes`` is the unconditional
    token); returns the v-estimate [B, S, S, 3] in float32. Three levels of
    width ``base``, ``2 base``, ``4 base``, ``depth`` resblocks each (with
    attention at the coarsest), a middle of resblock, attention, resblock,
    and an up path that concatenates ``[h, skip]``.

    The layers are held in the order the reference creates them
    (``convs``, ``resblocks``, ``attns``), so its parameter names map by
    index (:func:`convert_ark_params`), and ``forward`` takes them in that
    order."""

    def __init__(self, base: int = 64, n_classes: int = len(ARK_CLASSES), depth: int = 2,
                 dtype: Union[str, torch.dtype] = "bfloat16"):
        super().__init__()
        self.base, self.n_classes, self.depth = base, n_classes, depth
        self.dtype = dtype = _torch_dtype(dtype)
        emb = base * 4
        self.t_dense = Linear(base * 2, emb)
        self.embed = nn.Embedding(n_classes + 1, emb)
        self.emb_dense = Linear(emb, emb)
        chs = (base, base * 2, base * 4)
        convs, res, attns = [Conv2d(3, chs[0], 3, padding=1)], [], []
        c, skips = chs[0], [chs[0]]
        for lvl, ch in enumerate(chs):  # down path
            if lvl:
                convs.append(_DownConv(c, ch))
                c = ch
            for _ in range(depth):
                res.append(_ResBlock(c, ch, emb, dtype))
                if lvl == len(chs) - 1:
                    attns.append(_Attn(ch, dtype))
                skips.append(ch)
        res.append(_ResBlock(c, c, emb, dtype))  # middle
        attns.append(_Attn(c, dtype))
        res.append(_ResBlock(c, c, emb, dtype))
        for lvl, ch in reversed(list(enumerate(chs))):  # up path
            for _ in range(depth if lvl else depth + 1):
                res.append(_ResBlock(c + skips.pop(), ch, emb, dtype))
                c = ch
                if lvl == len(chs) - 1:
                    attns.append(_Attn(ch, dtype))
            if lvl:
                convs.append(Conv2d(c, chs[lvl - 1], 3, padding=1))
                c = chs[lvl - 1]
        self.norm_out = _GroupNorm(c)
        convs.append(Conv2d(c, 3, 3, padding=1))
        self.convs = nn.ModuleList(convs)
        self.resblocks = nn.ModuleList(res)
        self.attns = nn.ModuleList(attns)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        emb = self.t_dense(_timestep_embed(t, self.base * 2).to(dt))
        emb = emb + F.embedding(y.long(), self.embed.weight.to(dt))
        emb = self.emb_dense(F.silu(emb))

        convs, res, attns = iter(self.convs), iter(self.resblocks), iter(self.attns)
        levels = 3
        h = next(convs)(x.permute(0, 3, 1, 2).to(dt))
        skips = [h]
        for lvl in range(levels):  # down path
            if lvl:
                h = next(convs)(h)
            for _ in range(self.depth):
                h = next(res)(h, emb)
                if lvl == levels - 1:
                    h = next(attns)(h)
                skips.append(h)
        h = next(res)(h, emb)  # middle
        h = next(attns)(h)
        h = next(res)(h, emb)
        for lvl in reversed(range(levels)):  # up path
            for _ in range(self.depth if lvl else self.depth + 1):
                h = next(res)(torch.cat([h, skips.pop()], dim=1), emb)
                if lvl == levels - 1:
                    h = next(attns)(h)
            if lvl:
                # jax.image.resize(..., "nearest") to exactly twice the size
                h = next(convs)(h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
        h = F.silu(self.norm_out(h)).to(dt)
        return next(convs)(h).float().permute(0, 2, 3, 1)


def _zero_init(key: str, module: CondUNet) -> bool:
    """The layers the reference initialises to zero: each resblock's second
    conv, each attention's output projection, the last conv."""
    last = f"convs.{len(module.convs) - 1}."
    return key.startswith(last) or re.match(r"resblocks\.\d+\.conv1\.", key) is not None \
        or re.match(r"attns\.\d+\.proj\.", key) is not None


def init_ark_params(module: CondUNet, seed: int = 0) -> Dict[str, torch.Tensor]:
    """From-scratch float32 parameters of ``module`` drawn from ``seed``
    with the distributions of flax's init: LeCun-normal conv and linear
    weights (a normal of std sqrt(1 / fan_in) / 0.8796, truncated at two
    of its stds), the embedding a normal of std sqrt(1 / width), GroupNorm
    scales 1, zero biases, and the zero-initialised layers zero. The
    values are the port's own draw, not flax's."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, ref in module.state_dict().items():
        if key.endswith("bias") or _zero_init(key, module):
            sd[key] = torch.zeros(ref.shape)
        elif ".norm" in key or key.startswith("norm_out."):
            sd[key] = torch.ones(ref.shape)
        elif key == "embed.weight":
            sd[key] = torch.randn(ref.shape, generator=gen) * math.sqrt(1.0 / ref.shape[1])
        else:
            std = math.sqrt(1.0 / ref[0].numel()) / 0.87962566103423978
            sd[key] = torch.nn.init.trunc_normal_(torch.empty(ref.shape), std=std,
                                                  a=-2.0 * std, b=2.0 * std, generator=gen)
    return sd


_RES_LAYERS = {"GroupNorm_0": "norm0", "Conv_0": "conv0", "Dense_0": "dense",
               "GroupNorm_1": "norm1", "Conv_1": "conv1", "Conv_2": "skip"}
_ATTN_LAYERS = {"GroupNorm_0": "norm", "Dense_0": "qkv", "Dense_1": "proj"}
_TOP_LAYERS = {"Dense_0": "t_dense", "Dense_1": "emb_dense", "Embed_0": "embed",
               "GroupNorm_0": "norm_out"}


def _leaves(prefix: str, node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax layer's leaves as the port's: a Conv kernel [kh, kw, cin,
    cout] -> [cout, cin, kh, kw], a Dense kernel [in, out] -> [out, in],
    GroupNorm's scale -> weight, an Embed's embedding -> weight."""
    out = {}
    for name, leaf in node.items():
        a = np.array(leaf, np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[f"{prefix}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def convert_ark_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's ``CondUNet`` parameter tree (``{"params": {...}}``
    or its inner dict, leaves as arrays) -> the port's state dict. The
    reference names layers by creation order (``Conv_3``, ``_ResBlock_7``);
    the port keeps them in that order, so ``Conv_i`` is ``convs.i``,
    ``_ResBlock_i`` is ``resblocks.i`` and ``_Attn_i`` is ``attns.i``."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        kind, _, idx = name.rpartition("_")
        if name in _TOP_LAYERS:
            sd.update(_leaves(_TOP_LAYERS[name], node))
        elif kind == "Conv":
            sd.update(_leaves(f"convs.{idx}", node))
        elif kind == "_ResBlock":
            for sub, leaf in node.items():
                sd.update(_leaves(f"resblocks.{idx}.{_RES_LAYERS[sub]}", leaf))
        elif kind == "_Attn":
            for sub, leaf in node.items():
                sd.update(_leaves(f"attns.{idx}.{_ATTN_LAYERS[sub]}", leaf))
        else:
            raise KeyError(f"convert_ark_params: unknown layer {name!r}")
    return sd


def _geometry(state: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """(base, depth) of a ``CondUNet`` state dict: the stem's width, and
    depth from its resblock count (6 depth + 3)."""
    base = int(state["convs.0.weight"].shape[0])
    n_res = len({k.split(".")[1] for k in state if k.startswith("resblocks.")})
    return base, (n_res - 3) // 6


# ---------------------------------------------------------------------
# Diffusion math: cosine schedule, v-prediction (reference 321-338)
# ---------------------------------------------------------------------


def alpha_bar(t: torch.Tensor) -> torch.Tensor:
    """Cosine cumulative signal level (Nichol & Dhariwal 2021), t in [0, 1]."""
    s = 0.008
    return torch.cos((t + s) / (1.0 + s) * (math.pi / 2)) ** 2


def _vt_from(x0: torch.Tensor, eps: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    a, b = torch.sqrt(ab), torch.sqrt(1.0 - ab)
    return a * eps - b * x0


def _x0_eps_from_v(xt: torch.Tensor, v: torch.Tensor, ab: torch.Tensor):
    a, b = torch.sqrt(ab), torch.sqrt(1.0 - ab)
    return a * xt - b * v, b * xt + a * v


# ---------------------------------------------------------------------
# Training (reference generative.py:342-471)
# ---------------------------------------------------------------------


def ark_loss(module: CondUNet, x0: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """The v-target MSE of one batch given its draws: x0 [B, S, S, 3] in
    [-1, 1], labels y (the unconditional token where dropped), t [B] and
    the noise eps."""
    ab = alpha_bar(t)[:, None, None, None]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    v = module(xt, t, y)
    return torch.mean((v - _vt_from(x0, eps, ab)) ** 2)


def _ark_batch(x8: torch.Tensor, labels: torch.Tensor, batch: int, drop_label: float,
               n_classes: int, gen: torch.Generator):
    """One training batch's draws, on the corpus's device: random images
    (uint8 -> [-1, 1]), label dropout to the unconditional token,
    horizontal flips with probability 1/2, t uniform in [1e-4, 1) and
    standard normal noise (reference generative.py:409-421)."""
    kw = dict(generator=gen, device=x8.device)
    idx = torch.randint(0, x8.shape[0], (batch,), **kw)
    x0 = x8[idx].float() / 127.5 - 1.0
    y = torch.where(torch.rand(batch, **kw) < drop_label, n_classes, labels[idx])
    x0 = torch.where(torch.rand((batch, 1, 1, 1), **kw) < 0.5, x0.flip(2), x0)
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(batch, **kw)
    eps = torch.randn(x0.shape, **kw)
    return x0, y, t, eps


@torch.no_grad()
def _ema_update(ema: list, params: list, decay: float) -> None:
    """``ema * decay + param * (1 - decay)``, rounded as the reference's
    (two products, then the sum)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


def _save_ark(state: Mapping[str, torch.Tensor], checkpoint_dir: str, size: int, base: int,
              depth: int) -> str:
    """``ark_gen_x1.pt`` and its ``ark_meta.json`` sidecar, each written
    whole under a temporary name and renamed into place."""
    from .train import save_checkpoint

    path = save_checkpoint(state, "ark_gen", 1, checkpoint_dir)
    meta = os.path.join(os.path.dirname(path), ARK_META)
    with open(meta + ".tmp", "w") as f:
        json.dump({"size": size, "base": base, "depth": depth}, f)
    os.replace(meta + ".tmp", meta)
    return path


def train_ark(
    steps: int = 30000,
    n_per_class: int = 384,
    size: int = 64,
    base: int = 64,
    depth: int = 2,
    batch: int = 64,
    lr: float = 2e-4,
    ema_decay: float = 0.999,
    drop_label: float = 0.1,
    seed: int = 0,
    scan_chunk: int = 100,
    checkpoint_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, float], None]] = None,
    corpus: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    init_from: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    dtype: Union[str, torch.dtype] = "bfloat16",
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Tuple[CondUNet, Dict[str, torch.Tensor], float]:
    """Train the conditional diffusion model on ``device`` (the card by
    default; raises without one). Returns (the module holding the EMA
    weights, in eval mode; the EMA state dict in float32 on the CPU; the
    last logged loss).

    The corpus (``make_class_corpus``, or ``corpus`` = (images, labels))
    is uploaded once as uint8. Steps run in ``ceil(steps / scan_chunk)``
    chunks of ``scan_chunk``; a chunk's mean loss is read back at the end
    of every ``max(1000 // scan_chunk, 1)``-th chunk and of the last, where
    ``log_fn(step, loss)`` sees it; ``on_step(step, loss)`` sees each
    step's loss as a device tensor. Each step: one batch of draws
    (:func:`_ark_batch`), the loss (:func:`ark_loss`), the reference's
    clip-then-Adam at ``lr``, and the EMA. With ``checkpoint_dir`` the EMA
    weights are saved as ``ark_gen_x1.pt`` with ``ark_meta.json`` (size,
    base, depth); ``init_from`` warm-starts from such a checkpoint."""
    from .registry import load_checkpoint
    from .train import make_optimizer

    dev = resolve_device(device)
    x_np, y_np = corpus if corpus is not None else make_class_corpus(n_per_class, size, seed)
    module = CondUNet(base=base, depth=depth, dtype=dtype)
    params = init_ark_params(module, seed)
    if init_from is not None:
        params = load_checkpoint("ark_gen", 1, init_from)
        if params is None:
            raise FileNotFoundError(f"no ark_gen_x1 checkpoint in {init_from}")
    module.load_state_dict(params)
    module = module.to(dev)
    x8 = torch.from_numpy(np.clip(np.round(x_np), 0, 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(np.asarray(y_np, np.int64)).to(dev)
    ncls = len(ARK_CLASSES)
    gen = torch.Generator(dev).manual_seed(seed)
    loss = float("nan")
    n_chunks = max((steps + scan_chunk - 1) // scan_chunk, 1)
    log_stride = max(1000 // max(scan_chunk, 1), 1)
    with torch.inference_mode(False), torch.enable_grad():
        module.requires_grad_(True).train()
        plist = list(module.parameters())
        ema = [p.detach().clone() for p in plist]
        optimizer = make_optimizer(plist, lr)
        for ci, start in enumerate(range(0, steps, scan_chunk)):
            total = torch.zeros((), device=dev)
            for i in range(scan_chunk):
                x0, y, t, eps = _ark_batch(x8, labels, batch, drop_label, ncls, gen)
                optimizer.zero_grad()
                step_loss = ark_loss(module, x0, y, t, eps)
                step_loss.backward()
                optimizer.step()
                _ema_update(ema, plist, ema_decay)
                total += step_loss.detach()
                if on_step is not None:
                    on_step(start + i, step_loss.detach())
            if ci == n_chunks - 1 or (ci + 1) % log_stride == 0:
                loss = float(total) / scan_chunk
                if log_fn is not None:
                    log_fn(min(start + scan_chunk, steps), loss)
    names = [k for k, _ in module.named_parameters()]
    state = {k: e.detach().to("cpu", torch.float32).contiguous() for k, e in zip(names, ema)}
    module.load_state_dict(state)
    module.eval().requires_grad_(False)
    if checkpoint_dir is not None:
        _save_ark(state, checkpoint_dir, size, base, depth)
        clear_ark_cache()  # a train-then-generate flow must see the new checkpoint
    return module, state, loss


# ---------------------------------------------------------------------
# Sampling (reference generative.py:474-594)
# ---------------------------------------------------------------------


def _module_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _float32_on(a: Union[np.ndarray, torch.Tensor], dev: torch.device) -> torch.Tensor:
    """``a`` as float32 on ``dev`` (a numpy array is copied first)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def _ddim(module: CondUNet, x: torch.Tensor, cls: int, ts: torch.Tensor, guidance: float,
          clip_x0: float = 1.5) -> torch.Tensor:
    """DDIM (eta 0) from ``ts[0]`` down to ``ts[-1]`` with classifier-free
    guidance: per step one UNet call on ``[x, x]`` with labels ``[cls,
    uncond]``, ``v = v_u + guidance * (v_c - v_u)``, x0 clipped."""
    b = x.shape[0]
    y = torch.cat([torch.full((b,), cls, dtype=torch.long, device=x.device),
                   torch.full((b,), module.n_classes, dtype=torch.long, device=x.device)])
    abs_ = alpha_bar(ts)
    for i in range(ts.shape[0] - 1):
        v2 = module(torch.cat([x, x]), ts[i].expand(2 * b), y)
        v = v2[b:] + guidance * (v2[:b] - v2[b:])
        x0, eps = _x0_eps_from_v(x, v, abs_[i])
        x0 = torch.clamp(x0, -clip_x0, clip_x0)
        x = torch.sqrt(abs_[i + 1]) * x0 + torch.sqrt(1.0 - abs_[i + 1]) * eps
    return x


@torch.no_grad()
def sample_ark(
    module: CondUNet,
    cls: int,
    seed: int = 0,
    size: int = 64,
    steps: int = 50,
    guidance: float = 2.0,
    batch: int = 1,
    noise: Optional[Union[np.ndarray, torch.Tensor]] = None,
) -> torch.Tensor:
    """DDIM (eta 0) sample -> [batch, size, size, 3] float32 in [0, 255] on
    the module's device. The starting noise is drawn from a
    ``torch.Generator`` seeded ``seed`` (the reference's ``PRNGKey(seed)``),
    or handed in as ``noise`` [batch, size, size, 3]."""
    dev = _module_device(module)
    if noise is None:
        gen = torch.Generator(dev).manual_seed(int(seed))
        x = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    else:
        x = _float32_on(noise, dev)
    x = _ddim(module, x, cls, _linspace(1.0 - 1e-4, 0.0, steps + 1, device=dev), guidance)
    return torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)


@torch.no_grad()
def refine_ark(
    module: CondUNet,
    image: Union[np.ndarray, torch.Tensor],
    cls: int,
    seed: int = 0,
    t0: float = 0.22,
    steps: int = 8,
    guidance: float = 1.3,
    tile: Optional[int] = None,
    chunk: int = 64,
    eps: Optional[Union[np.ndarray, torch.Tensor]] = None,
) -> torch.Tensor:
    """SDEdit refinement of an upscaled sample at the model's native size
    (reference generative.py:515-594): the [H, W, 3] float32 [0, 255] image
    is cut into overlapping ``tile``-px tiles (64 when not given; overlap
    0.25, mirror-padded), each renoised to ``t0`` and denoised with class
    guidance in chunks of ``chunk`` tiles, and the tiles are merged with
    the layout's ramp weights. Returns the same shape and range on the
    module's device. The renoising draws come from a ``torch.Generator``
    seeded ``seed``, chunk after chunk, or are handed in as ``eps``
    [N tiles, tile, tile, 3]."""
    from ..ops.tiles import extract_tiles, merge_tiles, pad_image, unpad_image
    from ..ops.weights import layout_weights
    from ..tiling.geometry import compute_layout

    dev = _module_device(module)
    img = _float32_on(image, dev)
    h, w = int(img.shape[0]), int(img.shape[1])
    side = int(tile) if tile else 64
    lo = compute_layout(w, h, block_size=side, overlap_ratio=0.25)
    tiles = extract_tiles(pad_image(img, lo), lo)  # [N, side, side, 3]
    n = tiles.shape[0]
    ab0 = alpha_bar(torch.tensor(t0, dtype=torch.float32, device=dev))
    ts = _linspace(t0, 0.0, steps + 1, device=dev)
    gen = torch.Generator(dev).manual_seed(int(seed)) if eps is None else None
    eps_all = None if eps is None else _float32_on(eps, dev)
    refined = []
    for s0 in range(0, n, chunk):
        x0 = tiles[s0 : s0 + chunk] / 127.5 - 1.0
        e = (torch.randn(x0.shape, generator=gen, device=dev) if eps_all is None
             else eps_all[s0 : s0 + chunk])
        xt = torch.sqrt(ab0) * x0 + torch.sqrt(1.0 - ab0) * e
        refined.append(_ddim(module, xt, cls, ts, guidance))
    out = torch.clamp((torch.cat(refined) + 1.0) * 127.5, 0.0, 255.0)
    merged = merge_tiles(out, layout_weights(lo, kind="ramp"), lo)
    return torch.clamp(unpad_image(merged, lo)[:h, :w], 0.0, 255.0)


# ---------------------------------------------------------------------
# The checkpoint (reference generative.py:597-668)
# ---------------------------------------------------------------------

_CACHE: Dict[Tuple, Tuple[Optional[CondUNet], Optional[Dict[str, torch.Tensor]], bool]] = {}
_DEFAULT_META = {"size": 64, "base": 64, "depth": 2}
ARK_META = "ark_meta.json"


def clear_ark_cache() -> None:
    _CACHE.clear()


def _saved_ark(checkpoint_dir: Optional[str]) -> Optional[str]:
    """The path of ``ark_gen_x1.pt`` under ``checkpoint_dir``, if there."""
    from .registry import checkpoint_path

    path = checkpoint_path("ark_gen", 1, checkpoint_dir) if checkpoint_dir else None
    return path if path and os.path.isfile(path) else None


def ark_meta(checkpoint_dir: Optional[str] = None) -> Dict[str, int]:
    """The trained geometry of the generator :func:`build_ark` would load
    (reference generative.py:646): the ``ark_meta.json`` (size, base,
    depth) beside ``ark_gen_x1.pt`` in ``checkpoint_dir``, else the
    store's beside its generator; 64 px, base 64, depth 2 where the one
    found has no sidecar, or where there is none."""
    from . import registry

    saved = _saved_ark(checkpoint_dir)
    if saved is not None:
        meta = os.path.join(os.path.dirname(saved), ARK_META)
        meta = meta if os.path.isfile(meta) else None
    elif registry.packaged_file(registry.store_name("ark_gen", 1)):
        meta = registry.packaged_file(ARK_META, check_sha=True)
    else:
        meta = None
    if meta is None:
        return dict(_DEFAULT_META)
    with open(meta) as f:
        return {k: int(v) for k, v in json.load(f).items()}


def is_ark_trained(checkpoint_dir: Optional[str] = None) -> bool:
    """Whether there is a trained generator: ``ark_gen_x1.pt`` under
    ``checkpoint_dir``, or the store's."""
    from . import registry

    return _saved_ark(checkpoint_dir) is not None or bool(
        registry.packaged_file(registry.store_name("ark_gen", 1)))


def build_ark(
    checkpoint_dir: Optional[str] = None,
    base: Optional[int] = None,
    depth: Optional[int] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    device: Union[str, torch.device] = "cuda",
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> Tuple[Optional[CondUNet], Optional[Dict[str, torch.Tensor]], bool]:
    """(module on ``device`` in eval mode, its state dict, trained).

    The weights are ``params`` when handed in (base and depth read from
    their shapes), else ``ark_gen_x1.pt`` under ``checkpoint_dir``, else
    the store's generator (base and depth from the ``ark_meta.json``
    beside the one read, unless given). Without any the result is
    ``(None, None, False)``: an untrained generator outputs v = 0, so none
    is built. The weights do not depend on the sample size (:func:`ark_meta`
    gives the trained one). Results read from a directory or the store are
    cached (:func:`clear_ark_cache`); a stored generator at fault raises
    ``registry.StoreError``."""
    from . import registry

    dev = resolve_device(device)
    key = None
    if params is None:
        meta = ark_meta(checkpoint_dir)
        base = meta["base"] if base is None else base
        depth = meta["depth"] if depth is None else depth
        key = (checkpoint_dir, registry.PACKAGED_CHECKPOINT_DIR, base, depth, str(dev),
               str(dtype))
        if key in _CACHE:
            return _CACHE[key]
        params = registry.load_checkpoint("ark_gen", 1, checkpoint_dir)
        if params is None:
            params = registry.load_packaged(registry.store_name("ark_gen", 1))
    else:
        base, depth = _geometry(params)
    if params is None:
        built = (None, None, False)
    else:
        module = CondUNet(base=base, depth=depth, dtype=dtype)
        module.load_state_dict({k: v.float() for k, v in params.items()})
        built = (module.to(dev).eval().requires_grad_(False), dict(params), True)
    if key is not None:
        _CACHE[key] = built
    return built
