"""Port parity: LPIPS (srs_tpu_torch.models.lpips) against the JAX
reference, on the reference's own parameters converted by
``convert_lpips_params``: the packaged ranking-trained ``lpips_vgg`` /
``lpips_alex`` and the reference's crc32-seeded init. Tolerance: relative
1e-4 on the distance (float32 convolutions summed in another order).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.models import lpips as RL
from srs_tpu_torch.models.lpips import (
    FeatureNet,
    LPIPSMetric,
    convert_lpips_params,
    seeded_lpips_params,
)

RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:52, 0:60].astype(np.float32)
    a = np.stack([127 + 90 * np.sin(xx / 6), 127 + 90 * np.cos(yy / 5),
                  127 + 70 * np.sin((xx + yy) / 4)], -1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.float32)
    return a, b


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_params(net, packaged):
    if packaged:
        params = RL.LPIPSMetric()._load_checkpoint(net)
        assert params is not None, f"packaged lpips_{net} did not load"
        return params
    module = RL._FeatureNet(**RL._ARCHS[net])
    seed = zlib.crc32(net.encode()) % (2**31)
    return module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3), jnp.float32))


@pytest.mark.parametrize("packaged", [True, False], ids=["packaged", "crc32_seeded"])
@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_reference(pair, net, packaged):
    params = _reference_params(net, packaged)
    ref_metric = RL.LPIPSMetric(checkpoint_dir="")
    ref_metric._load_checkpoint = lambda _net: params
    a, b = pair
    ref = float(ref_metric(a, b, net=net))
    port = LPIPSMetric({net: convert_lpips_params(_numpy_tree(params))}, device="cpu")
    got = float(port(torch.from_numpy(a), torch.from_numpy(b), net=net))
    assert got == pytest.approx(ref, rel=RTOL)
    assert float(port(torch.from_numpy(a), torch.from_numpy(a), net=net)) == 0.0


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_seeded_features_are_deterministic_and_shaped(pair, net):
    """Seeded features load into the net and give the same distance in
    every process (crc32 seed); they are the port's own draw, not the
    reference's."""
    sd = seeded_lpips_params(net)
    assert set(sd) == set(FeatureNet(**RL._ARCHS[net]).state_dict())
    again = seeded_lpips_params(net)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    fan_in = sd["stages.0.0.weight"][0].numel()
    std = float(sd["stages.0.0.weight"].std())
    assert 0.7 / np.sqrt(fan_in) < std < 1.3 / np.sqrt(fan_in)
    a, b = pair
    metric = LPIPSMetric(device="cpu")
    d = float(metric(torch.from_numpy(a), torch.from_numpy(b), net=net))
    assert np.isfinite(d) and d > 0
