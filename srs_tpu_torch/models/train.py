"""Training for the SR nets on torch autograd (port of
``srs_tpu/models/train.py``).

- :func:`degrade` makes the LR half of a training pair: the ``area`` box
  mean, cv2-parity ``bicubic`` decimation, or the ``robust`` ladder (a
  random Gaussian pre-blur, the box mean, random Gaussian noise, with a
  clean share), drawn per image from a ``torch.Generator``;
- :func:`train_step` is one optimizer step of the Charbonnier loss, with
  the reference's optimizer, ``optax.chain(clip_by_global_norm(1.0),
  adam(lr))`` (:class:`ClippedAdam`);
- :func:`sample_patches` cuts random HR patches from one image with a
  numpy generator, drawing the same values in the same order as the
  reference;
- :func:`zssr_finetune` is zero-shot SR: the net tuned on the input image
  itself, on a copy, so the caller's weights survive;
- :func:`train_synthetic` trains a registry net on the procedural corpus
  (``models/corpus.py``), :func:`train_from_images` on image files, and
  :func:`eval_on_holdout` scores a net on held-out corpus images.

Nets train with float32 master weights and run their convolutions in
bfloat16 (``registry.build_model(..., master_weights=True)``), as the
reference's flax nets do. The reference runs ``scan_chunk`` steps per
compiled ``lax.scan``; the port runs a plain loop with the same step
count, schedule and logging. Checkpoints are the port's own: a
``torch.save`` state dict at ``{checkpoint_dir}/{name}_x{scale}.pt``
(``registry.load_checkpoint`` reads it); the reference's orbax
checkpoints are never written or read.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.resize import resize_bicubic, resize_bicubic_up
from ..utils.device import resolve_device

__all__ = [
    "DEFAULT_CHECKPOINT_DIR",
    "downsample_area",
    "degrade",
    "robust_draws",
    "robust_degrade",
    "charbonnier_loss",
    "cosine_decay_schedule",
    "ClippedAdam",
    "make_optimizer",
    "init_train_state",
    "train_step",
    "sample_patches",
    "zssr_finetune",
    "save_checkpoint",
    "train_synthetic",
    "eval_on_holdout",
    "train_from_images",
]

# Where ``train`` saves and the command line's ``process`` looks.
DEFAULT_CHECKPOINT_DIR = os.path.join("~", ".cache", "srs_tpu_torch", "models")

Schedule = Union[float, Callable[[int], float]]


def downsample_area(x: torch.Tensor, s: int) -> torch.Tensor:
    """Integer-factor box mean of (..., H, W, C) (cv2 INTER_AREA for
    integer factors)."""
    h, w = x.shape[-3] // s, x.shape[-2] // s
    x = x.reshape(*x.shape[:-3], h, s, w, s, x.shape[-1])
    return x.mean(dim=(-2, -4))


def _reflect_pad(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """REFLECT_101 padding of ``pad`` samples on both ends of ``dim``."""
    n = x.shape[dim]
    idx = list(range(pad, 0, -1)) + list(range(n)) + list(range(n - 2, n - 2 - pad, -1))
    return x.index_select(dim, torch.tensor(idx, device=x.device))


def _sep_blur7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap blur of [N, H, W, C] with REFLECT_101 borders;
    ``w`` holds the taps, [7] for the batch or [N, 7] per image."""
    w = w.reshape(-1, 7)
    taps = [w[:, i].reshape(-1, 1, 1, 1) for i in range(7)]
    h, wd = x.shape[-3], x.shape[-2]
    xp = _reflect_pad(x, -3, 3)
    x = sum(taps[i] * xp.narrow(-3, i, h) for i in range(7))
    xp = _reflect_pad(x, -2, 3)
    return sum(taps[i] * xp.narrow(-2, i, wd) for i in range(7))


def _gauss7(sigma: torch.Tensor) -> torch.Tensor:
    """[N, 7] normalised Gaussian taps at offsets -3..3 for sigmas [N]."""
    xs = torch.arange(-3, 4, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-0.5 * (xs[None] / sigma[:, None]) ** 2)
    return w / w.sum(dim=1, keepdim=True)


def robust_draws(n: int, lr_shape: Tuple[int, int, int], generator: torch.Generator,
                 clean_frac: float = 0.3, device: Union[str, torch.device] = "cpu"
                 ) -> Dict[str, torch.Tensor]:
    """Per-image draws of the ``robust`` degradation: whether the image
    stays clean (a ``clean_frac`` share), the blur sigma (uniform in
    [0.2, 1.8]; 1e-3 when clean), the noise sigma (uniform in [0, 8]; 0
    when clean) and a standard normal field of the LR shape. One draw per
    image, never one for the batch: that made every step all clean or all
    degraded (reference train.py:96-100)."""
    kw = dict(generator=generator, device=device)
    clean = torch.rand(n, **kw) < clean_frac
    sigma = torch.where(clean, 1e-3, 0.2 + 1.6 * torch.rand(n, **kw))
    nsigma = torch.where(clean, 0.0, 8.0 * torch.rand(n, **kw))
    noise = torch.randn((n,) + tuple(lr_shape), **kw)
    return {"clean": clean, "sigma": sigma, "nsigma": nsigma, "noise": noise}


def robust_degrade(hr: torch.Tensor, scale: int, sigma: torch.Tensor, nsigma: torch.Tensor,
                   noise: torch.Tensor, **_unused) -> torch.Tensor:
    """The ``robust`` arm given its draws: a 7-tap Gaussian blur of sigma,
    the box mean, then ``noise * nsigma``, clipped to [0, 255]."""
    lr = downsample_area(_sep_blur7(hr, _gauss7(sigma)), scale)
    return torch.clamp(lr + noise * nsigma.reshape(-1, 1, 1, 1), 0.0, 255.0)


def degrade(
    hr: torch.Tensor,
    patch: int,
    scale: int,
    method: str = "area",
    generator: Optional[torch.Generator] = None,
    clean_frac: float = 0.3,
) -> torch.Tensor:
    """HR [N, patch*scale, patch*scale, C] -> LR [N, patch, patch, C].

    ``area`` (the default) is the antialiased box mean, the standard
    degradation for photographic inputs; ``bicubic`` is cv2 INTER_CUBIC
    decimation (no antialiasing); ``robust`` models capture damage: per
    image a Gaussian pre-blur (sigma 0.2-1.8), the box mean and Gaussian
    noise (sigma 0-8), with a ``clean_frac`` share left clean (the box
    mean alone). ``robust`` draws from ``generator``, which it needs."""
    if method == "robust":
        if generator is None:
            raise ValueError("robust degradation needs a torch.Generator")
        lh, lw = hr.shape[-3] // scale, hr.shape[-2] // scale
        draws = robust_draws(hr.shape[0], (lh, lw, hr.shape[-1]), generator, clean_frac,
                             hr.device)
        return robust_degrade(hr, scale, **draws)
    if method == "area" and hr.shape[-3] == patch * scale:
        return downsample_area(hr, scale)
    return resize_bicubic(hr, patch, patch)


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier (smooth L1) in the [0, 1] domain."""
    d = (pred - target) / 255.0
    return torch.mean(torch.sqrt(d * d + eps * eps))


def cosine_decay_schedule(lr: float, decay_steps: int, alpha: float = 0.05
                          ) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``lr`` times ``(1 - alpha) *
    0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha``."""
    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr))`` on a net's
    parameters. The gradients are scaled by ``clip / norm`` when their
    global norm reaches ``clip`` (optax's rule, with no epsilon in the
    divisor, unlike ``torch.nn.utils.clip_grad_norm_``; one multiply by
    the factor where optax divides by the norm, then multiplies), then
    ``torch.optim.Adam`` steps (betas (0.9, 0.999), eps 1e-8, bias
    correction at count + 1: optax's update). A schedule's learning rate
    is read at the count before the update, as optax reads it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 2e-4, clip: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr if callable(lr) else (lambda _count, _lr=float(lr): _lr)
        self.clip = float(clip)
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, and return the global norm of the gradients
        before clipping (a 0-d tensor on the parameters' device; no host
        sync)."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0, self.clip / norm))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return norm


def make_optimizer(params: Iterable[torch.Tensor], lr: Schedule = 2e-4,
                   clip: float = 1.0) -> ClippedAdam:
    return ClippedAdam(params, lr, clip)


def init_train_state(net: nn.Module, lr: Schedule = 2e-4) -> Tuple[nn.Module, ClippedAdam]:
    """(net, optimizer): the net's parameters made float32 master weights
    that take gradients (its convolutions keep their compute type)."""
    net = net.to(torch.float32).requires_grad_(True).train()
    return net, make_optimizer(net.parameters(), lr)


def train_step(net: nn.Module, optimizer: ClippedAdam, lr_batch: torch.Tensor,
               hr_batch: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One optimizer step of the Charbonnier loss; returns ``loss`` and
    the gradients' ``grad_norm`` (before clipping) as 0-d tensors."""
    optimizer.zero_grad()
    loss = charbonnier_loss(net(lr_batch), hr_batch)
    loss.backward()
    norm = optimizer.step()
    return {"loss": loss.detach(), "grad_norm": norm}


def sample_patches(
    rng: np.random.Generator,
    hr_image: Union[np.ndarray, torch.Tensor],
    num: int,
    patch: int,
    scale: int,
    degradation: str = "area",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lr [num, patch, patch, C], hr [num, patch*scale, ..]) float32 on the
    image's device: random HR patches of an (H, W, C) image and their
    degraded LR. ``rng`` draws the rows, the columns, then one integer
    seed (the ``robust`` degradation's generator), as the reference draws
    them. The patches are views stacked in one copy: nothing waits on
    the device."""
    h, w = hr_image.shape[:2]
    hp = patch * scale
    if h < hp or w < hp:
        raise ValueError(f"image {h}x{w} smaller than HR patch {hp}")
    ys = rng.integers(0, h - hp + 1, num)
    xs = rng.integers(0, w - hp + 1, num)
    img = hr_image if isinstance(hr_image, torch.Tensor) else torch.from_numpy(
        np.asarray(hr_image))
    hr = torch.stack([img[y : y + hp, x : x + hp] for y, x in zip(ys.tolist(), xs.tolist())]
                     ).float()
    seed = int(rng.integers(0, 2**31))
    gen = torch.Generator(img.device).manual_seed(seed) if degradation == "robust" else None
    return degrade(hr, patch, scale, degradation, generator=gen), hr


def _net_device(net: nn.Module) -> torch.device:
    return next(net.parameters()).device


def zssr_finetune(
    net: nn.Module,
    lr_image: Union[np.ndarray, torch.Tensor],
    scale: int = 2,
    steps: int = 200,
    patch: int = 48,
    batch: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    degradation: str = "area",
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
) -> nn.Module:
    """Zero-shot SR (after Shocher et al. 2018): the input image is the
    HR truth, its further-degraded patches the LR, and a copy of ``net``
    is tuned on them for ``steps`` steps; ``net`` itself is unchanged.
    Returns the tuned copy (float32 master weights, gradients off, on the
    net's device). ``on_step(step, metrics)`` sees each step's loss and
    gradient norm (device tensors). Runs with gradients on even inside
    ``torch.inference_mode``."""
    rng = np.random.default_rng(seed)
    with torch.inference_mode(False), torch.enable_grad():
        tuned, optimizer = init_train_state(copy.deepcopy(net), lr)
        dev = _net_device(tuned)
        img = torch.as_tensor(np.asarray(lr_image, np.float32)
                              if not isinstance(lr_image, torch.Tensor) else lr_image)
        img = img.to(dev, torch.float32).clone()  # a normal tensor, never an inference one
        for step in range(steps):
            lrp, hrp = sample_patches(rng, img, batch, patch, scale, degradation)
            metrics = train_step(tuned, optimizer, lrp, hrp)
            if on_step is not None:
                on_step(step, metrics)
    return tuned.eval().requires_grad_(False)


def _state_dict(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}


def save_checkpoint(params: Union[nn.Module, Mapping[str, torch.Tensor]], name: str, scale: int,
                    checkpoint_dir: str) -> str:
    """Save a net's float32 state dict where the registry finds it
    (``{checkpoint_dir}/{name}_x{scale}.pt``); returns the path."""
    from .registry import checkpoint_path

    path = checkpoint_path(name, scale, checkpoint_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_state_dict(params), tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def random_crops(corpus: torch.Tensor, batch: int, p: int, gen: torch.Generator
                 ) -> torch.Tensor:
    """[batch, p, p, 3] float32 crops of the corpus [n, H, W, 3] (uint8 or
    float32) on its device: random images, then rows, then columns."""
    dev = corpus.device
    n_img, ch, cw, _ = corpus.shape
    idx = torch.randint(0, n_img, (batch,), generator=gen, device=dev)
    ys = torch.randint(0, ch - p + 1, (batch,), generator=gen, device=dev)
    xs = torch.randint(0, cw - p + 1, (batch,), generator=gen, device=dev)
    ar = torch.arange(p, device=dev)
    return corpus[idx[:, None, None], (ys[:, None] + ar)[:, :, None],
                  (xs[:, None] + ar)[:, None, :]].float()


def _train_batch(corpus: torch.Tensor, batch: int, hp: int, gen: torch.Generator,
                 hr_grain: float) -> torch.Tensor:
    """One augmented HR batch [batch, hp, hp, 3] float32 from the
    device-resident corpus: :func:`random_crops`, then the width flip, the
    height flip and the transpose (the dihedral group), each with
    probability 1/2, then optional film grain."""
    kw = dict(generator=gen, device=corpus.device)
    hr = random_crops(corpus, batch, hp, gen)
    flips = (torch.rand((3, batch), **kw) < 0.5).reshape(3, batch, 1, 1, 1)
    hr = torch.where(flips[0], hr.flip(2), hr)
    hr = torch.where(flips[1], hr.flip(1), hr)
    hr = torch.where(flips[2], hr.transpose(1, 2), hr)
    if hr_grain > 0.0:
        # Luma-dominant grain on the HR before degradation, so the LR
        # inherits its downsampled part (reference train.py:330-347).
        on = (torch.rand(batch, **kw) < hr_grain).reshape(-1, 1, 1, 1)
        sig = (0.5 + 5.5 * torch.rand(batch, **kw)).reshape(-1, 1, 1, 1)
        luma = torch.randn(hr.shape[:-1] + (1,), **kw)
        chroma = torch.randn(hr.shape, **kw)
        g = (0.8 * luma + 0.2 * chroma) * sig
        hr = torch.where(on, torch.clamp(hr + g, 0.0, 255.0), hr)
    return hr


def _log_points(steps: int, scan_chunk: int) -> list:
    """The steps at which :func:`train_synthetic` reads the loss back: the
    end of every ``max(1, 1000 // scan_chunk)``-th chunk of
    ``max(steps // scan_chunk, 1)``, and of the last (reference
    train.py:366-376)."""
    n_chunks = max(steps // scan_chunk, 1)
    stride = max(1, 1000 // max(scan_chunk, 1))
    return [(c + 1) * scan_chunk for c in range(n_chunks)
            if c == n_chunks - 1 or (c + 1) % stride == 0]


def train_synthetic(
    model_name: str = "espcn",
    scale: int = 2,
    steps: int = 3000,
    corpus_n: int = 96,
    corpus_size: int = 256,
    patch: int = 48,
    batch: int = 32,
    lr: float = 2e-4,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    scan_chunk: int = 50,
    log_fn: Optional[Callable[[int, float], None]] = None,
    corpus: Optional[Union[np.ndarray, torch.Tensor]] = None,
    degradation: str = "area",
    mix: str = "proc",
    hr_grain: float = 0.0,
    init_from: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
    dtype: str = "bfloat16",
) -> Tuple[Dict[str, torch.Tensor], float]:
    """Train a registry net on the procedural corpus (``corpus.py``), or on
    ``corpus`` ([n, H, W, 3], uint8 or float32), which is uploaded once.

    Every step draws its batch on the device (:func:`_train_batch`),
    degrades it and takes one optimizer step with a cosine-decayed
    learning rate (``steps`` long, floor ``0.05 * lr``). Steps run in
    chunks of ``scan_chunk``: ``max(steps // scan_chunk, 1) * scan_chunk``
    in all. The loss is read back at the end of every ``max(1, 1000 //
    scan_chunk)``-th chunk and of the last, and ``log_fn(step, chunk's
    mean loss)`` sees it there (:func:`_log_points`); ``on_step(step,
    metrics)`` sees every step's loss and gradient norm as device tensors.
    The net starts from :func:`init_params` with ``seed``, or from the
    checkpoint under ``init_from``. The convolutions run in ``dtype``
    (float32 master weights either way). Returns (float32 state dict on
    the CPU, the last logged loss); with ``checkpoint_dir`` the state dict
    is saved there too."""
    from .corpus import make_corpus
    from .registry import build_model, init_params, load_checkpoint

    dev = resolve_device(device)
    if corpus is None:
        corpus = make_corpus(corpus_n, corpus_size, seed, mix=mix)
    corpus_d = torch.as_tensor(corpus).to(dev)
    hp = patch * scale
    params = init_params(model_name, scale, seed)
    if init_from:
        params = load_checkpoint(model_name, scale, init_from)
        if params is None:
            raise FileNotFoundError(f"init_from={init_from!r}: no {model_name}_x{scale} checkpoint")
    loss = float("nan")
    n_chunks = max(steps // scan_chunk, 1)
    logged = set(_log_points(steps, scan_chunk))
    with torch.inference_mode(False), torch.enable_grad():
        net, _ = build_model(model_name, scale, params, dtype=dtype, device=dev,
                             master_weights=True)
        net, optimizer = init_train_state(net, cosine_decay_schedule(lr, max(steps, 1)))
        gen = torch.Generator(dev).manual_seed(seed + 1)
        for chunk in range(n_chunks):
            total = torch.zeros((), device=dev)
            for i in range(scan_chunk):
                hr = _train_batch(corpus_d, batch, hp, gen, hr_grain)
                lr_b = degrade(hr, patch, scale, degradation, generator=gen)
                metrics = train_step(net, optimizer, lr_b, hr)
                total += metrics["loss"]
                if on_step is not None:
                    on_step(chunk * scan_chunk + i, metrics)
            if (chunk + 1) * scan_chunk in logged:
                loss = float(total) / scan_chunk
                if log_fn is not None:
                    log_fn((chunk + 1) * scan_chunk, loss)
    state = _state_dict(net)
    if checkpoint_dir:
        save_checkpoint(state, model_name, scale, checkpoint_dir)
    return state, loss


def _psnr(pred: torch.Tensor, hr: torch.Tensor) -> float:
    mse = torch.mean((pred - hr) ** 2, dim=(1, 2, 3))
    return float(torch.mean(20 * torch.log10(255.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))))


@torch.no_grad()
def eval_on_holdout(
    net: nn.Module,
    scale: int,
    n: int = 8,
    size: int = 256,
    seed: int = 100_000,
    ibp_steps: int = 8,
    degradation: str = "area",
) -> Dict[str, float]:
    """Held-out PSNR panel on the net's device: bicubic, bicubic + IBP, the
    net, and the net + IBP, on corpus images from seeds no training run
    uses. The degraded LR of ``robust`` leaves no image clean and draws
    from a generator seeded 7."""
    from .corpus import make_corpus
    from .nets import back_project

    dev = _net_device(net)
    hr = torch.from_numpy(make_corpus(n, size, seed)).to(dev)
    lh = size // scale
    hr = hr[:, : lh * scale, : lh * scale].contiguous()
    gen = torch.Generator(dev).manual_seed(7)
    lr_b = degrade(hr, lh, scale, degradation, generator=gen, clean_frac=0.0)
    bicubic = resize_bicubic_up(lr_b, scale)
    out = net(lr_b)
    return {
        "psnr_bicubic": _psnr(bicubic.clamp(0, 255), hr),
        "psnr_bicubic_ibp": _psnr(back_project(bicubic, lr_b, scale, steps=ibp_steps
                                               ).clamp(0, 255), hr),
        "psnr_net": _psnr(out.clamp(0, 255), hr),
        "psnr_net_ibp": _psnr(back_project(out, lr_b, scale, steps=ibp_steps).clamp(0, 255),
                              hr),
    }


def train_from_images(
    image_paths,
    model_name: str = "espcn",
    scale: int = 2,
    steps: int = 2000,
    patch: int = 48,
    batch: int = 32,
    lr: float = 2e-4,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    log_every: int = 200,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict[str, torch.Tensor], float]:
    """Train a registry net on HR image files (area-degraded pairs from
    :func:`sample_patches`); images smaller than one HR patch are
    skipped. Returns (float32 state dict on the CPU, the loss of the last
    logged step: every ``log_every``-th and the last); with
    ``checkpoint_dir`` the state dict is saved there too."""
    from ..io.image import load_image
    from .registry import build_model, init_params

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = [np.asarray(load_image(p), np.float32) for p in image_paths]
    images = [torch.from_numpy(im).to(dev) for im in images
              if min(im.shape[:2]) >= patch * scale]
    if not images:
        raise ValueError("no images large enough for the requested patch size")
    loss = float("nan")
    with torch.inference_mode(False), torch.enable_grad():
        net, _ = build_model(model_name, scale, init_params(model_name, scale, seed),
                             device=dev, master_weights=True)
        net, optimizer = init_train_state(net, lr)
        for step in range(steps):
            img = images[rng.integers(len(images))]
            lrp, hrp = sample_patches(rng, img, batch, patch, scale)
            metrics = train_step(net, optimizer, lrp, hrp)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])
    state = _state_dict(net)
    if checkpoint_dir:
        save_checkpoint(state, model_name, scale, checkpoint_dir)
    return state, loss
