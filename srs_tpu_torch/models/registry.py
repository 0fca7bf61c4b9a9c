"""Model registry: ESPCN, EDSR and RCAN nets by name (port of
``srs_tpu/models/registry.py:28-71``), plus the conditioned polish
``cond_polish`` (``models/conditioning.py``), which the reference builds
beside the registry.

The card's machine cannot read the reference's orbax checkpoints, so the
port never loads them. Parameters are handed in instead:

- :func:`convert_flax_params` turns a reference parameter tree (numpy
  arrays, as JAX loads it on the CPU) into the port's state dict;
- :func:`seeded_params` makes random parameters at a net's full width
  from a seed, with a non-zero tail so the net changes the pixels;
- :func:`load_checkpoint` reads the state dict the port's trainer saves
  (``models/train.save_checkpoint``) at ``{dir}/{name}_x{scale}.pt``;
  :func:`is_pretrained` asks whether one is there.

``PACKAGED_CHECKPOINT_DIR`` is the reference's packaged directory, by
path; it holds orbax checkpoints only, which the port does not read.

:func:`build_model` counts handed-in parameters as trained (the pipeline
then skips back-projection, as the reference does for its packaged nets,
sr_module.py:749). Without parameters it builds the from-scratch init of
:func:`init_params` (flax's: LeCun-normal kernels, zero biases, a zero
last conv), which is exact bicubic, and reports it untrained.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.paths import REFERENCE_DIR
from .conditioning import CondPolish
from .nets import EDSR, ESPCN, RCAN, shuffle_channel_order

__all__ = [
    "ModelSpec",
    "MODEL_REGISTRY",
    "build_model",
    "convert_flax_params",
    "seeded_params",
    "init_params",
    "checkpoint_path",
    "load_checkpoint",
    "is_pretrained",
    "clear_param_cache",
    "PACKAGED_CHECKPOINT_DIR",
]

# The reference's packaged checkpoints (reference registry.py:106), by path.
PACKAGED_CHECKPOINT_DIR = os.path.join(REFERENCE_DIR, "models", "checkpoints")
# (name, scale, checkpoint_dir) -> what is_pretrained found
_LOADED: Dict[Tuple[str, int, Optional[str]], bool] = {}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    ctor: Callable[..., Any]
    kwargs: Dict[str, Any] = field(default_factory=dict)
    description: str = ""


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "espcn": ModelSpec("espcn", ESPCN, {}, "fast sub-pixel CNN"),
    "espcn_polish": ModelSpec("espcn_polish", ESPCN, {"scale": 1},
                              "scale-1 polish pass of the hybrid ladder"),
    "edsr_m": ModelSpec("edsr_m", EDSR, {"num_blocks": 8}, "medium quality net"),
    "edsr_l": ModelSpec("edsr_l", EDSR, {"num_blocks": 16, "features": 96}, "large quality net"),
    "edsr_xl": ModelSpec(
        "edsr_xl", EDSR, {"num_blocks": 16, "features": 128}, "flagship quality net"
    ),
    "rcan": ModelSpec("rcan", RCAN, {"num_blocks": 10},
                      "channel-attention quality net"),
    "edsr_l_robust": ModelSpec(
        "edsr_l_robust", EDSR, {"num_blocks": 16, "features": 96},
        "degradation-robust large quality net",
    ),
    "edsr_l_tex": ModelSpec(
        "edsr_l_tex", EDSR, {"num_blocks": 16, "features": 96}, "texture-tier large net"
    ),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _torch_dtype(name: str | torch.dtype) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def _make(name: str, scale: int, dtype: torch.dtype) -> torch.nn.Module:
    """The net ``name`` at ``scale`` (a spec's own scale wins: the polish
    is scale 1 whatever the ladder step)."""
    if name == "cond_polish":
        return CondPolish(dtype=dtype)
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}")
    spec = MODEL_REGISTRY[name]
    return spec.ctor(dtype=dtype, **{"scale": scale, **spec.kwargs})


def _conv_from_flax(node: Mapping[str, Any], out_order: Optional[torch.Tensor] = None):
    kernel = torch.from_numpy(np.array(node["kernel"], np.float32))  # HWIO
    weight = kernel.permute(3, 2, 0, 1).contiguous()  # OIHW
    bias = torch.from_numpy(np.array(node["bias"], np.float32))
    if out_order is not None:
        weight, bias = weight[out_order].contiguous(), bias[out_order].contiguous()
    return weight, bias


def _shuffled(node: Mapping[str, Any], channels: int):
    """The conv's output channels permuted for ``F.pixel_shuffle`` when it
    feeds a shuffle of ``channels`` channels (its outputs are channels * f^2)."""
    f = math.isqrt(np.shape(node["kernel"])[-1] // channels)
    return shuffle_channel_order(channels, f) if f > 1 else None


def convert_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference parameter tree (``{"params": {...}}`` or its inner dict,
    leaves as arrays) of an EDSR, RCAN, ESPCN or CondPolish -> the port's
    state dict. The family is read from the tree's layer names."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, node, out_order=None):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _conv_from_flax(node, out_order)

    if "conv_in" in p:  # ESPCN or CondPolish
        put("conv_in", p["conv_in"])
        put("conv_mid", p["conv_mid"])
        if "film" in p:  # a Dense (in, out) kernel is a Linear's (out, in) weight
            film = p["film"]
            sd["film.weight"] = torch.from_numpy(np.array(film["kernel"], np.float32).T.copy())
            sd["film.bias"] = torch.from_numpy(np.array(film["bias"], np.float32))
        half = np.shape(p["conv_mid"]["kernel"])[-1]
        i = 0
        while f"up_{i}" in p:
            put(f"up_convs.{i}", p[f"up_{i}"], _shuffled(p[f"up_{i}"], half))
            i += 1
        channels = np.shape(p["conv_in"]["kernel"])[-2]
        put("conv_out", p["conv_out"], _shuffled(p["conv_out"], channels))
        return sd

    put("head", p["head"])
    features = np.shape(p["head"]["kernel"])[-1]
    i = 0
    while f"block_{i}" in p:
        put(f"blocks.{i}.conv0", p[f"block_{i}"]["Conv_0"])
        put(f"blocks.{i}.conv1", p[f"block_{i}"]["Conv_1"])
        i += 1
    i = 0
    while f"cab_{i}" in p:  # RCAN: two 3x3 convs, then the gate's two 1x1
        for j, name in enumerate(("conv0", "conv1", "att0", "att1")):
            put(f"blocks.{i}.{name}", p[f"cab_{i}"][f"Conv_{j}"])
        i += 1
    put("body_out", p["body_out"])
    i = 0
    while f"up_conv_{i}" in p:
        put(f"up_convs.{i}", p[f"up_conv_{i}"], _shuffled(p[f"up_conv_{i}"], features))
        i += 1
    channels = np.shape(p["head"]["kernel"])[-2]
    put("tail", p["tail"], _shuffled(p["tail"], channels))
    return sd


# The layer each family zero-initialises: the residual's last conv.
_LAST_CONVS = ("tail.", "conv_out.")


def seeded_params(
    name: str, scale: int, seed: int = 0, tail_gain: float = 0.02
) -> Dict[str, torch.Tensor]:
    """Random parameters for ``name`` at ``scale`` from ``seed``: He-uniform
    weights (convolutions and the FiLM layer), zero biases, and the last
    conv (``tail`` or ``conv_out``) scaled by ``tail_gain`` (0 gives the
    exact-bicubic net, or the identity polish)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, ref in _make(name, scale, torch.float32).state_dict().items():
        if key.endswith("bias"):
            sd[key] = torch.zeros_like(ref)
            continue
        bound = math.sqrt(6.0 / ref[0].numel())  # fan-in: input channels x taps
        w = (torch.rand(ref.shape, generator=gen) * 2.0 - 1.0) * bound
        sd[key] = w * tail_gain if key.startswith(_LAST_CONVS) else w
    return sd


def init_params(name: str, scale: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The from-scratch parameters of ``name`` at ``scale``, drawn from
    ``seed`` with the distributions flax's ``module.init`` uses
    (``srs_tpu/models/nets.py:138-290``): LeCun-normal weights (a normal of
    std sqrt(1 / fan_in) / 0.8796, truncated at two of its stds), zero
    biases, and a zero last conv (``tail`` or ``conv_out``), so the net is
    exact bicubic (or the identity polish). The values are the port's own
    draw, not flax's."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, ref in _make(name, scale, torch.float32).state_dict().items():
        if key.endswith("bias") or key.startswith(_LAST_CONVS):
            sd[key] = torch.zeros_like(ref)
            continue
        std = math.sqrt(1.0 / ref[0].numel()) / 0.87962566103423978  # fan-in
        sd[key] = torch.nn.init.trunc_normal_(torch.empty(ref.shape), std=std, a=-2.0 * std,
                                              b=2.0 * std, generator=gen)
    return sd


def checkpoint_path(name: str, scale: int, checkpoint_dir: str) -> str:
    """Where the port's trainer keeps ``name`` at ``scale``."""
    return os.path.join(os.path.abspath(os.path.expanduser(checkpoint_dir)),
                        f"{name}_x{scale}.pt")


def load_checkpoint(name: str, scale: int,
                    checkpoint_dir: Optional[str]) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict saved for ``name`` at ``scale`` under
    ``checkpoint_dir`` (on the CPU), or None when there is none. The
    reference's orbax checkpoints are never read."""
    if not checkpoint_dir:
        return None
    path = checkpoint_path(name, scale, checkpoint_dir)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def clear_param_cache() -> None:
    """Forget what :func:`is_pretrained` found (reference registry.py:79)."""
    _LOADED.clear()


def is_pretrained(name: str, scale: int = 2, checkpoint_dir: Optional[str] = None,
                  dtype: Any = "bfloat16") -> bool:
    """Whether the port has trained weights of ``name`` at ``scale``: a
    state dict its trainer saved in ``checkpoint_dir``, else in
    ``PACKAGED_CHECKPOINT_DIR`` (reference registry.py:84, which looks in
    the same two places for its own checkpoints). The answer is kept per
    (name, scale, directory) until :func:`clear_param_cache`, as the
    reference keeps its probe build; ``dtype`` is the reference's
    argument and changes nothing here. An unknown name raises
    ``KeyError``."""
    if name not in MODEL_REGISTRY and name != "cond_polish":
        raise KeyError(name)
    key = (name, scale, checkpoint_dir)
    if key not in _LOADED:
        _LOADED[key] = any(os.path.isfile(checkpoint_path(name, scale, d))
                           for d in (checkpoint_dir, PACKAGED_CHECKPOINT_DIR) if d)
    return _LOADED[key]


def build_model(
    name: str,
    scale: int = 2,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: str | torch.dtype = "bfloat16",
    params_dtype: str | torch.dtype = "float32",
    device: str | torch.device = "cuda",
    master_weights: bool = False,
) -> Tuple[torch.nn.Module, bool]:
    """(net in eval mode on ``device``, trained) for a registry entry or
    ``cond_polish``; the card by default (raises without one).

    ``params`` (a state dict, e.g. from :func:`convert_flax_params`) count
    as trained; without them the net is :func:`init_params`' from-scratch
    init (exact bicubic, or the identity polish; untrained). The
    parameters are rounded to ``params_dtype``. For serving they are then
    held in the computation type ``dtype``: the values flax computes with
    when it stores ``params_dtype`` and casts at each convolution. With
    ``master_weights`` they stay in ``params_dtype`` and each convolution
    casts them to ``dtype`` as it runs (the trainer's master weights); the
    convolutions see the same values either way. Gradients stay off."""
    dev = resolve_device(device)
    compute = _torch_dtype(dtype)
    stored = _torch_dtype(params_dtype)
    module = _make(name, scale, compute)
    trained = params is not None
    sd = dict(params) if trained else init_params(name, scale, seed=0)
    if master_weights:
        module = module.to(stored)
    module = module.to(device=dev)
    module.load_state_dict({k: v.to(stored) for k, v in sd.items()})
    module.eval().requires_grad_(False)
    return module, trained
