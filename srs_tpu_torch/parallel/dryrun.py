"""The port's multi-device dry run (port of
``__graft_entry__.dryrun_multichip``, 37-201).

``dryrun_multichip(n)`` factors n into a (data, space, model) mesh, runs
one sharded training step of a small EDSR x2 (features 8 x model, 2
blocks) on it (``parallel/train.py``), then the inference path over a
1-D ``space`` mesh of n: the halo-exchange tile merge against the
unsharded merge, and the sharded Laplacian blend with the sharded banded
finalize against the single-device blend and finalize. The mesh is
virtual: ``device`` repeated n times (one card, or the CPU), as the
reference runs on n virtual CPU devices. On the card the blend launches
K1 and K2.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..models.nets import EDSR
from ..models.train import init_train_state
from ..ops.blend import blend_finalize_banded, laplacian_fusion_tiles
from ..ops.tiles import extract_tiles, merge_tiles, pad_image
from ..ops.weights import layout_weight_profiles, layout_weights
from ..tiling.geometry import compute_layout
from ..utils.device import resolve_device
from .finalize import ShardedCanvas, sharded_finalize_banded
from .halo import sharded_laplacian_blend, sharded_weighted_merge
from .mesh import make_mesh
from .train import shard_params, sharded_train_step

__all__ = ["factor_devices", "dryrun_multichip"]

MERGE_ATOL = 1e-4  # the halo merge against the unsharded merge
FINALIZE_SHARE = 1e-3  # samples more than 1 LSB from the unsharded finalize


def factor_devices(n: int) -> Tuple[int, int, int]:
    """(data, space, model): the factors of two dealt round-robin, the odd
    rest on data (8 -> 2x2x2, 4 -> 2x2x1, 2 -> 2x1x1)."""
    dims = [1, 1, 1]
    i = 0
    while n % 2 == 0:
        dims[i % 3] *= 2
        n //= 2
        i += 1
    dims[0] *= n
    return dims[0], dims[1], dims[2]


def dryrun_multichip(n_devices: int, device: Union[str, torch.device] = "cuda") -> Dict:
    """The dry run on ``device`` repeated ``n_devices`` times (the card by
    default: raises without one). Raises ``AssertionError`` when a check
    fails; returns its numbers and prints the reference's summary line."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = [dev] * n_devices
    dd, ds, dm = factor_devices(n_devices)
    mesh = make_mesh({"data": dd, "space": ds, "model": dm}, devices)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = EDSR(scale=2, features=8 * dm, num_blocks=2, dtype=torch.float32)
    net, opt = init_train_state(net.to(dev), lr=1e-3)
    split = shard_params(net, mesh)
    rng = np.random.default_rng(0)
    batch = dd * 2
    lr_b = torch.from_numpy(rng.random((batch, 16, 16, 3), dtype=np.float32) * 255).to(dev)
    hr_b = torch.from_numpy(rng.random((batch, 32, 32, 3), dtype=np.float32) * 255).to(dev)
    stats: Dict = {}
    metrics = sharded_train_step(net, opt, lr_b, hr_b, mesh, stats=stats)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    assert np.isfinite(loss) and np.isfinite(gnorm), (loss, gnorm)
    out = {"mesh": {"data": dd, "space": ds, "model": dm}, "loss": loss, "grad_norm": gnorm,
           "split_convs": len(split), "train_halo_bytes": stats.get("halo_bytes", 0)}

    note = "skipped (1 device)"
    if n_devices > 1:
        smesh = make_mesh({"space": n_devices}, devices)
        lo = compute_layout(96, n_devices * 24 + 8, 32, 0.25)
        assert lo.ny == n_devices, lo.ny
        img = torch.from_numpy(rng.random((lo.image_h, lo.image_w, 3), dtype=np.float32)).to(dev)
        tiles = extract_tiles(pad_image(img, lo), lo)
        weights = layout_weights(lo, kind="ramp")
        err = float((sharded_weighted_merge(tiles, weights, lo, smesh)
                     - merge_tiles(tiles, weights, lo)).abs().max())
        assert err < MERGE_ATOL, f"halo merge mismatch {err}"

        # blend -> save: the deferred sharded Laplacian blend and the
        # sharded banded finalize (each shard quantizes its own rows)
        prof = layout_weight_profiles(lo)
        tiles255 = extract_tiles(pad_image(img * 255.0, lo), lo)
        blend_stats: Dict = {}
        sc = sharded_laplacian_blend(tiles255, *prof, lo, smesh, levels=3,
                                     collapse_last=False, stats=blend_stats)
        assert isinstance(sc, ShardedCanvas), type(sc)
        oh, ow = lo.image_h + 5, lo.image_w - 3
        got = sharded_finalize_banded(sc, oh, ow, bands=2 * n_devices, crop_h=lo.image_h,
                                      crop_w=lo.image_w, to_uint8=True, stats=blend_stats)
        lap0, coarse = laplacian_fusion_tiles(tiles255, lo, prof, levels=3, clip_range=None,
                                              collapse_last=False)
        ref = blend_finalize_banded(lap0, coarse, oh, ow, bands=2, crop_h=lo.image_h,
                                    crop_w=lo.image_w, to_uint8=True)
        bad = float(np.mean(np.abs(got.astype(np.int32) - ref.astype(np.int32)) > 1))
        assert bad < FINALIZE_SHARE, f"sharded finalize mismatch frac {bad}"
        out.update(merge_err=err, finalize_frac_over_1lsb=bad,
                   blend_halo_bytes=blend_stats.get("halo_bytes", 0),
                   gather_fallback=bool(blend_stats.get("gather_fallback")))
        note = (f"halo-merge err {err:.1e}, blend->save frac>1 = {bad:.1e} "
                f"over space={n_devices}")
    print(f"dryrun_multichip OK: mesh(data={dd}, space={ds}, model={dm}), "
          f"loss={loss:.4f}, grad_norm={gnorm:.4f}; {note}")
    return out
