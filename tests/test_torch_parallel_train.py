"""Port parity: the mesh-sharded training step (``srs_tpu_torch/parallel/
train.py``) and the port's dry run (``parallel/dryrun.py``), on the CPU.

The port's meshes are the CPU repeated (a virtual mesh). The sharded step
is held against the port's unsharded ``models/train.train_step`` on the
same seeded weights and batch, in float32: the loss within relative 1e-6,
each gradient within 1e-4 of the largest gradient entry (sums in another
order), the parameters after the step within 1e-5 (Adam's first step
moves each by about its learning rate, 2e-4, whatever the gradient's
size). The reference's ``test_sharded_training_step`` case (ESPCN x2,
features 8, a batch of 8 16x16 patches on a data=4, space=2 mesh, its
bfloat16 convolutions) runs on both sides from the same parameters: both
losses finite, within relative 1e-3 (bfloat16 rounds at other places in
the two frameworks).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srs_tpu.models.nets import ESPCN as JaxESPCN
from srs_tpu.models.train import make_optimizer as jax_optimizer
from srs_tpu.models.train import train_step as jax_train_step
from srs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srs_tpu.parallel.mesh import spatial_sharding
from srs_tpu_torch.models.nets import ESPCN
from srs_tpu_torch.models.registry import build_model, convert_flax_params, seeded_params
from srs_tpu_torch.models.train import init_train_state, train_step
from srs_tpu_torch.parallel.dryrun import dryrun_multichip, factor_devices
from srs_tpu_torch.parallel.mesh import make_mesh
from srs_tpu_torch.parallel.train import receptive_radius, shard_params, sharded_train_step

CPU = torch.device("cpu")


def cpu_mesh(shape):
    return make_mesh(shape, [CPU] * int(np.prod(list(shape.values()))))


def batch(n, h, w, scale, seed):
    rng = np.random.default_rng(seed)
    lr = rng.random((n, h, w, 3), dtype=np.float32) * 255
    hr = rng.random((n, h * scale, w * scale, 3), dtype=np.float32) * 255
    return torch.from_numpy(lr), torch.from_numpy(hr)


def both_steps(name, shape, n, h, w, scale=2):
    """(unsharded net, its metrics, sharded net, its metrics, split convs)
    of one step from the same seeded float32 weights."""
    net, _ = build_model(name, scale, seeded_params(name, scale, seed=3), dtype="float32",
                         device="cpu", master_weights=True)
    ref, ref_opt = init_train_state(copy.deepcopy(net))
    got, got_opt = init_train_state(copy.deepcopy(net))
    mesh = cpu_mesh(shape)
    split = shard_params(got, mesh)
    lr, hr = batch(n, h, w, scale, seed=4)
    want = train_step(ref, ref_opt, lr, hr)
    stats = {}
    have = sharded_train_step(got, got_opt, lr, hr, mesh, stats=stats)
    return ref, want, got, have, split, stats


@pytest.mark.parametrize("name,shape,n,h,w", [
    ("espcn", {"data": 2, "space": 2}, 4, 16, 12),
    ("edsr_m", {"data": 2, "space": 2}, 4, 12, 10),
    ("espcn", {"data": 2, "space": 2, "model": 2}, 4, 16, 12),
    ("edsr_m", {"data": 2, "space": 2, "model": 2}, 4, 12, 10),
    # rows (13) and the batch (5) do not split evenly
    ("edsr_m", {"data": 2, "space": 3}, 5, 13, 9),
])
def test_sharded_step_matches_the_unsharded_step(name, shape, n, h, w):
    ref, want, got, have, split, stats = both_steps(name, shape, n, h, w)
    assert bool(split) == ("model" in shape)
    assert stats["halo_bytes"] > 0
    np.testing.assert_allclose(float(have["loss"]), float(want["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(have["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
    ref_p, got_p = dict(ref.named_parameters()), dict(got.named_parameters())
    assert ref_p.keys() == got_p.keys()
    gmax = max(float(p.grad.abs().max()) for p in ref_p.values())
    for k, p in got_p.items():
        assert float((p.grad - ref_p[k].grad).abs().max()) <= 1e-4 * gmax, k
        assert float((p.detach() - ref_p[k].detach()).abs().max()) <= 1e-5, k


def test_shard_params_splits_the_reference_convs():
    """Every conv whose out channels divide by the model axis, the tail
    excepted; the state dict keeps its names."""
    net, _ = build_model("edsr_m", 2, dtype="float32", device="cpu")
    keys = list(net.state_dict())
    split = shard_params(net, cpu_mesh({"model": 2}))
    assert list(net.state_dict()) == keys
    convs = [n for n, m in net.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert split == [n for n in convs if n != "tail"]
    assert shard_params(net, cpu_mesh({"data": 2})) == []


def test_receptive_radius_counts_every_conv():
    net, _ = build_model("edsr_m", 3, dtype="float32", device="cpu")
    assert receptive_radius(net) == 1 + 2 * len(net.blocks) + 1 + 1
    assert receptive_radius(ESPCN(scale=4, features=8, dtype=torch.float32)) == 2 + 1 + 1 + 1


def test_sharded_step_refuses_what_it_cannot_split():
    net, _ = build_model("rcan", 2, dtype="float32", device="cpu")
    net, opt = init_train_state(net)
    lr, hr = batch(2, 8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="channel attention"):
        sharded_train_step(net, opt, lr, hr, cpu_mesh({"space": 2}))
    with pytest.raises(ValueError, match="shard_params"):
        sharded_train_step(net, opt, lr, hr, cpu_mesh({"model": 2}))


def test_reference_sharded_training_step_case():
    """tests/test_parallel.py:73-90 on both sides from the same parameters."""
    rng = np.random.default_rng(42)
    lr_np = rng.random((8, 16, 16, 3), dtype=np.float32) * 255
    hr_np = rng.random((8, 32, 32, 3), dtype=np.float32) * 255
    jmesh = jax_make_mesh({"data": 4, "space": 2})
    model = JaxESPCN(scale=2, features=8)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(lr_np[:1]))
    # converted first: the reference's step donates its parameters
    sd = convert_flax_params(jax.tree_util.tree_map(np.asarray, params))
    tx = jax_optimizer(1e-3)
    lr_b = jax.device_put(jnp.asarray(lr_np), spatial_sharding(jmesh))
    hr_b = jax.device_put(jnp.asarray(hr_np), NamedSharding(jmesh, P("data", "space", None, None)))
    _, _, metrics = jax_train_step(model.apply, params, tx.init(params), tx, lr_b, hr_b)
    want = float(metrics["loss"])

    net = ESPCN(scale=2, features=8)
    net.load_state_dict(sd)
    net, opt = init_train_state(net, lr=1e-3)
    got = sharded_train_step(net, opt, torch.from_numpy(lr_np), torch.from_numpy(hr_np),
                             cpu_mesh({"data": 4, "space": 2}))
    assert np.isfinite(want) and np.isfinite(float(metrics["grad_norm"]))
    assert np.isfinite(float(got["loss"])) and np.isfinite(float(got["grad_norm"]))
    np.testing.assert_allclose(float(got["loss"]), want, rtol=1e-3)


def test_factor_devices_matches_the_reference():
    assert [factor_devices(n) for n in (1, 2, 4, 8, 6, 16)] == [
        (1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (6, 1, 1), (4, 2, 2)]


def test_dryrun_multichip_on_the_cpu(capsys):
    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"data": 2, "space": 2, "model": 2}
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    assert out["merge_err"] < 1e-4 and out["finalize_frac_over_1lsb"] < 1e-3
    assert not out["gather_fallback"]
    assert "dryrun_multichip OK" in capsys.readouterr().out
