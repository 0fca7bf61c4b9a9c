"""Model registry: ESPCN, EDSR and RCAN nets by name (port of
``srs_tpu/models/registry.py:28-71``), plus the conditioned polish
``cond_polish`` (``models/conditioning.py``), which the reference builds
beside the registry, and HAT (``hat``, ``nets.HAT``), which the JAX
package does not have.

An entry may state the bytes its pass holds live per input pixel
(``in_px_bytes``), which the pipeline's chunk rule reads
(``pipeline._chunk_tiles``) where they outweigh the CNNs' 160 bytes per
output pixel: HAT's maps at its input's resolution do.

Trained weights come, in this order, from (reference registry.py:106-134):

- state dicts handed in: :func:`convert_flax_params` turns a reference
  parameter tree (numpy arrays, as JAX loads it on the CPU) into one, and
  :func:`seeded_params` makes random ones at a net's full width;
- the state dicts the port's trainer saves (``models/train.
  save_checkpoint``) at ``{checkpoint_dir}/{name}_x{scale}.pt``
  (:func:`load_checkpoint`);
- the store, ``PACKAGED_CHECKPOINT_DIR`` (``models/checkpoints/`` beside
  this module): float32 state dicts converted from the reference's
  packaged checkpoints, each a ``{name}_x{scale}.srsw`` file in the
  lossless byte-plane format of ``models/store.py``, its ``EVAL.json``,
  ``FUSION.json`` and ``ark_meta.json``, and ``MANIFEST.json`` with each
  file's bytes and sha256 (and a net's ``raw_sha256``, the hash of its
  decoded tensors). The manifest says what the store holds; a listed file
  that is missing, cut short or not decodable raises :class:`StoreError`
  naming it (:func:`packaged_file`, :func:`load_packaged`), where the
  reference would serve the net untrained.

:func:`is_pretrained` asks whether a net has trained weights in either
directory. :func:`build_model` counts handed-in parameters as trained
(the pipeline then skips back-projection, as the reference does for its
packaged nets, sr_module.py:749). Without parameters it builds the
from-scratch init of :func:`init_params` (flax's: LeCun-normal kernels,
zero biases, a zero last conv), which is exact bicubic, and reports it
untrained.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .conditioning import CondPolish
from .nets import EDSR, ESPCN, HAT, RCAN, shuffle_channel_order
from .store import SUFFIX, StoreError, load_state, raw_sha256

__all__ = [
    "ModelSpec",
    "MODEL_REGISTRY",
    "PORT_ONLY",
    "build_model",
    "convert_flax_params",
    "seeded_params",
    "init_params",
    "checkpoint_path",
    "load_checkpoint",
    "is_pretrained",
    "clear_param_cache",
    "PACKAGED_CHECKPOINT_DIR",
    "MANIFEST_NAME",
    "StoreError",
    "store_name",
    "store_manifest",
    "packaged_file",
    "load_packaged",
    "TrainedWeights",
]

# The port's store of trained weights (the reference's packaged directory,
# registry.py:106, converted): read at call time, so a caller may point it
# elsewhere.
PACKAGED_CHECKPOINT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
MANIFEST_NAME = "MANIFEST.json"
# (name, scale, checkpoint_dir, store) -> what is_pretrained found
_LOADED: Dict[Tuple[str, int, Optional[str], str], bool] = {}
# manifest path -> ((mtime in ns, size), its "files" table)
_MANIFESTS: Dict[str, Tuple[Tuple[int, int], Dict[str, Dict[str, Any]]]] = {}
# (store file path, sha256) -> its state dict, read once per process
_PACKAGED: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    ctor: Callable[..., Any]
    kwargs: Dict[str, Any] = field(default_factory=dict)
    description: str = ""
    in_px_bytes: float = 0  # live bytes of a pass per input pixel, where stated


# HAT's live bytes per input pixel of a pass: the peak allocated over a
# bfloat16 x3 pass on one 1536^2 tile, less the input, over its pixels:
# 8.748 GB, 3708 bytes (one H100, PERF.md's kernel table); the same on six
# 512^2 tiles.
HAT_IN_PX_BYTES = 3708


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
    "hat": ModelSpec("hat", HAT, {}, "hybrid attention transformer (HAT, arXiv:2205.04437)",
                     in_px_bytes=HAT_IN_PX_BYTES),
}
# Registry nets that the JAX package does not have.
PORT_ONLY = ("hat",)

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


# The layer each family zero-initialises: the residual's last conv (HAT's
# ``conv_last``, whose zero output is the mean colour).
_LAST_CONVS = ("tail.", "conv_out.", "conv_last.")


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


def store_name(name: str, scale: int) -> str:
    """The store's file name of ``name`` at ``scale``."""
    return f"{name}_x{scale}{SUFFIX}"


def store_manifest(store: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """The manifest of the store in ``store`` (``PACKAGED_CHECKPOINT_DIR``
    by default): file name -> ``{"bytes", "sha256", "source"}``, and
    ``raw_sha256`` for a weight file ({} where the directory has no
    manifest). Read again when it changes."""
    path = os.path.join(store or PACKAGED_CHECKPOINT_DIR, MANIFEST_NAME)
    try:
        st = os.stat(path)
    except OSError:
        return {}
    stamp = (st.st_mtime_ns, st.st_size)
    cached = _MANIFESTS.get(path)
    if cached is None or cached[0] != stamp:
        try:
            with open(path) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            raise StoreError(f"{path}: unreadable store manifest ({e})") from e
        _MANIFESTS[path] = cached = (stamp, files)
    return cached[1]


def packaged_file(fname: str, store: Optional[str] = None,
                  check_sha: bool = False) -> Optional[str]:
    """The path of ``fname`` in the store (``PACKAGED_CHECKPOINT_DIR`` by
    default), or None when its manifest does not list it. A listed file
    that is missing or of another size than the manifest's, or with
    ``check_sha`` of another sha256, raises :class:`StoreError`."""
    store = store or PACKAGED_CHECKPOINT_DIR
    entry = store_manifest(store).get(fname)
    if entry is None:
        return None
    path = os.path.join(store, fname)
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise StoreError(f"{path}: listed in the store's manifest but missing") from e
    if size != entry["bytes"]:
        raise StoreError(f"{path}: {size} bytes, the store's manifest says {entry['bytes']}")
    if check_sha and _sha256(path) != entry["sha256"]:
        raise StoreError(f"{path}: sha256 differs from the store's manifest")
    return path


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_packaged(fname: str) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict of ``fname`` (a ``.srsw`` file) in the store, on the
    CPU, or None when the manifest does not list it. The file's sha256 and
    its decoded tensors' ``raw_sha256`` are checked against the manifest's
    and it is read once per process; the tensors are shared between
    callers, which copy them into their nets. Any fault raises
    :class:`StoreError` naming the file."""
    path = packaged_file(fname)
    if path is None:
        return None
    entry = store_manifest()[fname]
    key = (path, entry["sha256"])
    if key not in _PACKAGED:
        packaged_file(fname, check_sha=True)
        sd = load_state(path)
        if raw_sha256(sd) != entry.get("raw_sha256"):
            raise StoreError(f"{path}: the decoded tensors' sha256 differs from the store's "
                             "manifest")
        _PACKAGED[key] = sd
    return dict(_PACKAGED[key])


def _net_file(fname: str, suffix: str = ".pt") -> Optional[Tuple[str, int]]:
    """(name, scale) of a net's file name (saved ``.pt``, or the store's
    ``suffix``), or None for another file."""
    m = re.fullmatch(r"(.+)_x(\d+)" + re.escape(suffix), fname)
    if m is None or (m[1] not in MODEL_REGISTRY and m[1] != "cond_polish"):
        return None
    return m[1], int(m[2])


class TrainedWeights(MutableMapping):
    """``(name, scale)`` -> state dict of every trained net, in the
    reference's order (registry.py:134): the ones handed in, then those
    saved under ``checkpoint_dir``, then the store's. A saved or stored
    net is read at its first lookup (under a lock: the job layer's workers
    share one mapping); a stored one that is missing or cut short raises
    :class:`StoreError` here already."""

    def __init__(self,
                 handed: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
                 checkpoint_dir: Optional[str] = None):
        self._own: Dict[Tuple[str, int], Mapping[str, torch.Tensor]] = dict(handed or {})
        self._lazy: Dict[Tuple[str, int], Callable[[], Dict[str, torch.Tensor]]] = {}
        self._lock = threading.Lock()
        d = os.path.expanduser(checkpoint_dir) if checkpoint_dir else None
        if d and os.path.isdir(d):
            for fname in sorted(os.listdir(d)):
                key = _net_file(fname)
                if key is not None and key not in self._own:
                    self._lazy[key] = lambda k=key: load_checkpoint(k[0], k[1], d)
        for fname in sorted(store_manifest()):
            key = _net_file(fname, SUFFIX)
            if key is not None and key not in self._own and key not in self._lazy:
                packaged_file(fname)
                self._lazy[key] = lambda f=fname: load_packaged(f)

    def __getitem__(self, key):
        with self._lock:
            if key not in self._own:
                if key not in self._lazy:
                    raise KeyError(key)
                self._own[key] = self._lazy[key]()
                del self._lazy[key]
            return self._own[key]

    def __contains__(self, key) -> bool:
        return key in self._own or key in self._lazy

    def __setitem__(self, key, value) -> None:
        with self._lock:
            self._lazy.pop(key, None)
            self._own[key] = value

    def __delitem__(self, key) -> None:
        with self._lock:
            if self._own.pop(key, None) is None and self._lazy.pop(key, None) is None:
                raise KeyError(key)

    def __iter__(self) -> Iterator[Tuple[str, int]]:
        return iter([*self._own, *self._lazy])

    def __len__(self) -> int:
        return len(self._own) + len(self._lazy)


def clear_param_cache() -> None:
    """Forget what :func:`is_pretrained` found and what was read from the
    store (reference registry.py:79)."""
    _LOADED.clear()
    _MANIFESTS.clear()
    _PACKAGED.clear()


def is_pretrained(name: str, scale: int = 2, checkpoint_dir: Optional[str] = None,
                  dtype: Any = "bfloat16") -> bool:
    """Whether the port has trained weights of ``name`` at ``scale``: a
    state dict its trainer saved in ``checkpoint_dir``, else one in the
    store (reference registry.py:84, which looks in the same two places
    for its own checkpoints). The answer is kept per (name, scale,
    directory, store) until :func:`clear_param_cache`, as the reference
    keeps its probe build; ``dtype`` is the reference's argument and
    changes nothing here. An unknown name raises ``KeyError``; a store
    file listed but missing raises :class:`StoreError`."""
    if name not in MODEL_REGISTRY and name != "cond_polish":
        raise KeyError(name)
    key = (name, scale, checkpoint_dir, PACKAGED_CHECKPOINT_DIR)
    if key not in _LOADED:
        _LOADED[key] = bool(
            (checkpoint_dir and os.path.isfile(checkpoint_path(name, scale, checkpoint_dir)))
            or packaged_file(store_name(name, scale)))
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
    if dev.type == "cuda" and hasattr(module, "load_kernels"):
        module.load_kernels()  # HAT's window attention, built here rather than mid-pass
    return module, trained
