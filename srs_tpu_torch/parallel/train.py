"""The mesh-sharded training step (port of the reference's sharded
``train_step``: ``tests/test_parallel.py:73-90`` and
``__graft_entry__.dryrun_multichip``, whose ``model`` axis splits the
convolutions' output channels, ``__graft_entry__.py:119-124``).

Single-controller, as the rest of ``parallel/``: one process drives every
device of the mesh, and a mesh whose devices repeat (a virtual mesh) runs
the sharded code on one device.

- ``data``: the batch is split into contiguous shards.
- ``space``: the LR rows are split into contiguous bands. Each band is
  cut with a conv halo of ``receptive_radius(net)`` rows of its
  neighbours (every 3x3 or 5x5 conv's reach, counted in LR rows, and the
  bicubic base's two taps), so the rows it keeps see what the whole image
  shows them; at the image's true edges the net's own padding applies.
  Each shard keeps its own ``scale x`` output rows.
- ``model``: :func:`shard_params` splits the output channels of every
  conv whose count divides by the axis size (the ``tail`` excepted, as
  in the reference): each ``model`` device computes its slice of the
  conv's output from its slice of the weights, and the slices are
  gathered on the shard's device before the next layer.

The Charbonnier loss is summed over each shard's own output samples and
divided by the global sample count, so every output sample counts once
and the loss is the unsharded one. Each shard runs its backward as soon
as its forward is done. The parameters live on the mesh's first device;
every shard reads them through a copy on its devices, so autograd sums
every shard's gradients there. The clip and Adam step run there, and the
next step copies the new parameters out again.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..models.nets import _CABlock, Conv2d
from ..models.train import ClippedAdam
from ..ops.cuda.epilogue import conv_epilogue_plain
from .mesh import Mesh

__all__ = ["receptive_radius", "shard_params", "sharded_train_step"]

_BICUBIC_RADIUS = 2  # LR rows the bicubic base reads on each side
_EPS = 1e-3  # models.train.charbonnier_loss's


class _OutSplitConv2d(Conv2d):
    """A conv whose output channels are split over ``model_devices``: slice
    i of the weights computes slice i of the output on device i; the
    slices are gathered on the input's device."""

    model_devices: List[torch.device]

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None, res_scale: float = 1.0) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        n = self.out_channels // len(self.model_devices)
        outs = []
        for i, dev in enumerate(self.model_devices):
            part = slice(i * n, (i + 1) * n)
            y = self._conv_forward(x.to(dev), w[part].to(dev), b[part].to(dev))
            outs.append(y.to(x.device))
        return conv_epilogue_plain(torch.cat(outs, dim=1), None, relu, residual, res_scale)


def receptive_radius(net: nn.Module) -> int:
    """LR rows each output row reads on either side: the sum of the convs'
    half-kernels (a conv after a pixel shuffle counts a whole LR row,
    more than it needs), at least the bicubic base's two taps."""
    convs = sum(int(m.kernel_size[0]) // 2 for m in net.modules() if isinstance(m, nn.Conv2d))
    return max(convs, _BICUBIC_RADIUS)


def shard_params(net: nn.Module, mesh: Mesh, axis: str = "model") -> List[str]:
    """Split over ``axis`` the output channels of every conv of ``net``
    whose count divides by the axis size, the ``tail`` excepted
    (reference ``__graft_entry__.py:119-124``). The parameters keep their
    names and stay whole on their device. Returns the split convs'
    names."""
    devices = mesh.axis_devices(axis)
    if len(devices) == 1:
        return []
    names = []
    for name, mod in net.named_modules():
        if (isinstance(mod, Conv2d) and mod.out_channels % len(devices) == 0
                and "tail" not in name):
            mod.__class__ = _OutSplitConv2d
            mod.model_devices = devices
            names.append(name)
    return names


def _bounds(n: int, parts: int, i: int):
    """[lo, hi) of contiguous part i of n items in ``parts`` (the first
    ``n % parts`` parts one longer)."""
    size, extra = divmod(n, parts)
    lo = i * size + min(i, extra)
    return lo, lo + size + (1 if i < extra else 0)


def _mesh_device(mesh: Mesh, **coord: int) -> torch.device:
    return mesh.devices[tuple(coord.get(a, 0) for a in mesh.axis_names)]


def sharded_train_step(net: nn.Module, optimizer: ClippedAdam, lr_batch: torch.Tensor,
                       hr_batch: torch.Tensor, mesh: Mesh,
                       stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step of the Charbonnier loss with the batch over the
    mesh's ``data`` axis, the rows over ``space`` and the split convs
    (:func:`shard_params`) over ``model``. Returns what
    ``models.train.train_step`` returns: ``loss`` and the gradients'
    ``grad_norm`` (before clipping), 0-d tensors on the mesh's first
    device, where ``net`` lives. ``stats`` (a dict), when given, gets
    ``halo_bytes`` added: the LR halo rows the shards read beyond their
    own."""
    shape = mesh.shape
    n_data, n_space, n_model = (shape.get(a, 1) for a in ("data", "space", "model"))
    first = mesh.devices.reshape(-1)[0]
    params = dict(net.named_parameters())
    if any(p.device != torch.device(first) for p in params.values()):
        raise ValueError(f"the net must live on the mesh's first device {first}")
    split = [m for m in net.modules() if isinstance(m, _OutSplitConv2d)]
    if n_model > 1 and not split:
        raise ValueError("the mesh has a model axis: call shard_params(net, mesh) first")
    if n_space > 1 and any(isinstance(m, _CABlock) for m in net.modules()):
        raise ValueError("channel attention pools over the whole image: its rows cannot "
                         "be split over space")
    scale = int(getattr(net, "scale", 1))
    radius = receptive_radius(net) if n_space > 1 else 0
    n, h = int(lr_batch.shape[0]), int(lr_batch.shape[1])
    total = hr_batch.numel()

    optimizer.zero_grad()
    loss = torch.zeros((), dtype=torch.float32, device=first)
    halo = 0
    for d in range(n_data):
        b0, b1 = _bounds(n, n_data, d)
        for s in range(n_space):
            r0, r1 = _bounds(h, n_space, s)
            if b0 == b1 or r0 == r1:
                continue
            dev = _mesh_device(mesh, data=d, space=s, model=0)
            for m in split:
                m.model_devices = [_mesh_device(mesh, data=d, space=s, model=i)
                                   for i in range(n_model)]
            lo, hi = max(0, r0 - radius), min(h, r1 + radius)
            x = lr_batch[b0:b1, lo:hi].to(dev)
            halo += (hi - lo - (r1 - r0)) * x[:, :1].numel() * x.element_size()
            target = hr_batch[b0:b1, r0 * scale : r1 * scale].to(dev)
            out = functional_call(net, {k: p.to(dev) for k, p in params.items()}, (x,))
            out = out[:, (r0 - lo) * scale : (r1 - lo) * scale]
            diff = (out - target) / 255.0
            part = torch.sqrt(diff * diff + _EPS * _EPS).sum() / total
            part.backward()
            loss += part.detach().to(first)
    if stats is not None:
        stats["halo_bytes"] = stats.get("halo_bytes", 0) + halo
    norm = optimizer.step()
    return {"loss": loss, "grad_norm": norm}
