"""Model registry for the EDSR family (port of ``srs_tpu/models/registry.py``).

The card's machine cannot read the reference's orbax checkpoints, so the
port never loads them. Parameters are handed in instead:

- :func:`convert_flax_params` turns a reference parameter tree (numpy
  arrays, as JAX loads it on the CPU) into the port's state dict;
- :func:`seeded_params` makes random parameters at a net's full width
  from a seed, with a non-zero tail so the net changes the pixels.

:func:`build_model` counts handed-in parameters as trained (the pipeline
then skips back-projection, as the reference does for its packaged nets,
sr_module.py:749). Without parameters it builds the zero-tail net, which
is exact bicubic, and reports it untrained.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .nets import EDSR, shuffle_channel_order

__all__ = [
    "ModelSpec",
    "MODEL_REGISTRY",
    "build_model",
    "convert_flax_params",
    "seeded_params",
]


@dataclass(frozen=True)
class ModelSpec:
    name: str
    ctor: Callable[..., Any]
    kwargs: Dict[str, Any] = field(default_factory=dict)
    description: str = ""


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "edsr_m": ModelSpec("edsr_m", EDSR, {"num_blocks": 8}, "medium quality net"),
    "edsr_l": ModelSpec("edsr_l", EDSR, {"num_blocks": 16, "features": 96}, "large quality net"),
    "edsr_xl": ModelSpec(
        "edsr_xl", EDSR, {"num_blocks": 16, "features": 128}, "flagship quality net"
    ),
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


def _make(name: str, scale: int, dtype: torch.dtype) -> EDSR:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}")
    spec = MODEL_REGISTRY[name]
    return spec.ctor(scale=scale, dtype=dtype, **spec.kwargs)


def _conv_from_flax(node: Mapping[str, Any], out_order: Optional[torch.Tensor] = None):
    kernel = torch.from_numpy(np.array(node["kernel"], np.float32))  # HWIO
    weight = kernel.permute(3, 2, 0, 1).contiguous()  # OIHW
    bias = torch.from_numpy(np.array(node["bias"], np.float32))
    if out_order is not None:
        weight, bias = weight[out_order].contiguous(), bias[out_order].contiguous()
    return weight, bias


def convert_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference EDSR parameter tree (``{"params": {...}}`` or its inner
    dict, leaves as arrays) -> the port's EDSR state dict."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, node, out_order=None):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _conv_from_flax(node, out_order)

    put("head", p["head"])
    features = np.shape(p["head"]["kernel"])[-1]
    i = 0
    while f"block_{i}" in p:
        put(f"blocks.{i}.conv0", p[f"block_{i}"]["Conv_0"])
        put(f"blocks.{i}.conv1", p[f"block_{i}"]["Conv_1"])
        i += 1
    put("body_out", p["body_out"])
    i = 0
    while f"up_conv_{i}" in p:
        f = math.isqrt(np.shape(p[f"up_conv_{i}"]["kernel"])[-1] // features)
        put(f"up_convs.{i}", p[f"up_conv_{i}"], shuffle_channel_order(features, f))
        i += 1
    tail_out = np.shape(p["tail"]["kernel"])[-1]
    channels = np.shape(p["head"]["kernel"])[-2]
    f = math.isqrt(tail_out // channels)
    put("tail", p["tail"], shuffle_channel_order(channels, f) if f > 1 else None)
    return sd


def seeded_params(
    name: str, scale: int, seed: int = 0, tail_gain: float = 0.02
) -> Dict[str, torch.Tensor]:
    """Random parameters for ``name`` at ``scale`` from ``seed``: He-uniform
    conv weights, zero biases, and the tail scaled by ``tail_gain`` (0 gives
    the exact-bicubic net)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, ref in _make(name, scale, torch.float32).state_dict().items():
        if key.endswith("bias"):
            sd[key] = torch.zeros_like(ref)
            continue
        bound = math.sqrt(6.0 / (ref.shape[1] * ref.shape[2] * ref.shape[3]))
        w = (torch.rand(ref.shape, generator=gen) * 2.0 - 1.0) * bound
        sd[key] = w * tail_gain if key.startswith("tail.") else w
    return sd


def build_model(
    name: str,
    scale: int = 2,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: str | torch.dtype = "bfloat16",
    params_dtype: str | torch.dtype = "float32",
    device: str | torch.device = "cuda",
) -> Tuple[EDSR, bool]:
    """(net in eval mode on ``device``, trained) for a registry entry; the
    card by default (raises without one).

    ``params`` (a state dict, e.g. from :func:`convert_flax_params`) count
    as trained; without them the net is the zero-tail init (exact bicubic,
    untrained). The parameters are rounded to ``params_dtype`` and held in
    the computation type ``dtype``: the values flax computes with when it
    stores ``params_dtype`` and casts at each convolution."""
    dev = resolve_device(device)
    compute = _torch_dtype(dtype)
    module = _make(name, scale, compute)
    trained = params is not None
    sd = dict(params) if trained else seeded_params(name, scale, seed=0, tail_gain=0.0)
    stored = _torch_dtype(params_dtype)
    module = module.to(device=dev)
    module.load_state_dict({k: v.to(stored) for k, v in sd.items()})
    module.eval().requires_grad_(False)
    return module, trained
