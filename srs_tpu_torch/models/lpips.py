"""LPIPS perceptual distance (port of ``srs_tpu/models/lpips.py:39-149``).

The feature nets are the reference's VGG- and Alex-style stacks of 3x3
convolutions with ReLU and 2x average pooling, in float32 (TF32 off on
the card, so the card and the CPU agree). The distance is the mean over
the stages of the spatial mean of the squared difference of the
channel-normalized features.

Weights: :func:`convert_lpips_params` turns a reference parameter tree
(flax HWIO kernels) into a state dict; ``LPIPSMetric(params={"vgg": ...,
"alex": ...})`` serves those. A net with no state dict handed in serves
the store's ranking-trained features (``lpips_vgg.srsw``, ``lpips_alex.srsw``
under ``registry.PACKAGED_CHECKPOINT_DIR``, converted from the
reference's packaged ones), as the reference loads its own by default.
Where the store holds none, the net gets seeded features: truncated-normal
LeCun weights (flax's default initializer) drawn from
``torch.Generator().manual_seed(crc32(net))``. The seed is the
reference's, the generator is not, so seeded values differ from the
reference's seeded features; the report keeps its keys.
"""

from __future__ import annotations

import contextlib
import math
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["LPIPSMetric", "FeatureNet", "convert_lpips_params", "seeded_lpips_params"]

_ARCHS = {
    "vgg": dict(widths=(64, 128, 256, 512, 512), convs_per_stage=(2, 2, 3, 3, 3)),
    "alex": dict(widths=(64, 192, 384, 256, 256), convs_per_stage=(1, 1, 1, 1, 1)),
}


class FeatureNet(nn.Module):
    """Stages of conv + ReLU; each stage's output is a feature, then a 2x
    average pool (floor, as flax's VALID pooling) feeds the next."""

    def __init__(self, widths: Sequence[int], convs_per_stage: Sequence[int], channels: int = 3):
        super().__init__()
        stages = []
        cin = channels
        for w, reps in zip(widths, convs_per_stage):
            convs = []
            for _ in range(reps):
                convs.append(nn.Conv2d(cin, w, 3, padding=1))
                cin = w
            stages.append(nn.ModuleList(convs))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x
        for s, convs in enumerate(self.stages):
            for conv in convs:
                h = F.relu(conv(h))
            feats.append(h)
            if s < len(self.stages) - 1:
                h = F.avg_pool2d(h, 2, 2)
        return feats


def convert_lpips_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference LPIPS parameter tree (``{"params": {"conv{s}_{r}": ...}}``,
    leaves as arrays) -> the port's state dict."""
    p = tree.get("params", tree)
    sd = {}
    for key, node in p.items():
        s, r = key[len("conv"):].split("_")
        kernel = torch.from_numpy(np.array(node["kernel"], np.float32))  # HWIO
        sd[f"stages.{s}.{r}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
        sd[f"stages.{s}.{r}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
    return sd


def seeded_lpips_params(net: str) -> Dict[str, torch.Tensor]:
    """Seeded features for ``net``: LeCun truncated-normal kernels (std
    sqrt(1 / fan_in) / 0.8796, cut at 2 std), zero biases."""
    gen = torch.Generator().manual_seed(zlib.crc32(net.encode()) % (2**31))
    sd = {}
    for key, ref in FeatureNet(**_ARCHS[net]).state_dict().items():
        if key.endswith("bias"):
            sd[key] = torch.zeros_like(ref)
            continue
        std = math.sqrt(1.0 / (ref.shape[1] * ref.shape[2] * ref.shape[3])) / 0.87962566103423978
        w = torch.empty(ref.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        sd[key] = w
    return sd


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions without TF32, restoring the caller's flag."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """f / sqrt(sum over channels of f^2 + eps), channels on axis 1."""
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + eps)


class LPIPSMetric:
    """``LPIPS((H,W,C) [0,255], (H,W,C) [0,255], net=...)`` -> 0-d tensor,
    on ``device`` (the card by default). ``sources`` says, per net built,
    where its features came from: "handed", "store" or "seeded"."""

    def __init__(
        self,
        params: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
        device: str | torch.device = "cuda",
    ):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self._nets: Dict[str, FeatureNet] = {}
        self.sources: Dict[str, str] = {}

    def _net(self, net: str) -> FeatureNet:
        if net not in self._nets:
            if net not in _ARCHS:
                raise KeyError(f"unknown LPIPS net {net!r}")
            from .registry import load_packaged
            from .store import SUFFIX

            module = FeatureNet(**_ARCHS[net])
            sd, self.sources[net] = self.params.get(net), "handed"
            if sd is None:
                sd, self.sources[net] = load_packaged(f"lpips_{net}{SUFFIX}"), "store"
            if sd is None:
                sd, self.sources[net] = seeded_lpips_params(net), "seeded"
            module.load_state_dict({k: v.float() for k, v in sd.items()})
            self._nets[net] = module.to(self.device).eval().requires_grad_(False)
        return self._nets[net]

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor, net: str = "vgg") -> torch.Tensor:
        module = self._net(net)

        def prep(a):
            a = torch.as_tensor(a).to(self.device, torch.float32) / 127.5 - 1.0
            if a.dim() == 3:
                a = a[None]
            return a.permute(0, 3, 1, 2)

        with torch.inference_mode(), _no_tf32():
            fa = module(prep(img1))
            fb = module(prep(img2))
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for x, y in zip(fa, fb):
                d = _unit_normalize(x) - _unit_normalize(y)
                total = total + (d * d).sum(dim=1).mean()
            return total / len(fa)
