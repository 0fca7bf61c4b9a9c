"""Port parity: EDSR (srs_tpu_torch.models) against the JAX reference with
the packaged trained checkpoints, converted by ``convert_flax_params``.

Tolerances:
- float32 on both sides: atol 1e-3 on outputs in [0, 255] (34 chained
  convolutions summed in a different order);
- bfloat16 on both sides: PSNR between the two outputs >= 45 dB (the two
  frameworks round bf16 at different places);
- a zero tail reproduces bicubic exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srs_tpu.models.nets import depth_to_space as jax_d2s
from srs_tpu.models.registry import build_model as jax_build
from srs_tpu.ops.resize import resize_bicubic_up as jax_bicubic
from srs_tpu_torch.models.nets import _shuffle_factors, depth_to_space, shuffle_channel_order
from srs_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    PORT_ONLY,
    build_model,
    convert_flax_params,
    seeded_params,
)
from srs_tpu_torch.ops.resize import resize_bicubic_up

F32_ATOL = 1e-3
BF16_PSNR_FLOOR = 45.0


def _x(seed=0, shape=(2, 12, 14, 3)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _ref(name, scale, dtype, x, pretrained=True):
    module, params = jax_build(name, scale, dtype=dtype, pretrained=pretrained)
    out = np.asarray(module.apply(params, jnp.asarray(x)))
    return out, jax.tree_util.tree_map(np.asarray, params)


def _run(net, x):
    with torch.inference_mode():
        return net(torch.from_numpy(x)).numpy()


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 255) - np.clip(b, 0, 255)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.mark.parametrize("name,scale", [("edsr_xl", 2), ("edsr_xl", 3), ("edsr_m", 4)])
def test_trained_edsr_float32_parity(name, scale):
    x = _x(scale)
    ref, params = _ref(name, scale, jnp.float32, x)
    net, trained = build_model(name, scale, convert_flax_params(params), dtype="float32", device="cpu")
    assert trained
    got = _run(net, x)
    assert got.shape == ref.shape == (2, 12 * scale, 14 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def test_trained_edsr_bf16_psnr_floor():
    x = _x(5)
    ref, params = _ref("edsr_xl", 3, jnp.bfloat16, x)
    net, _ = build_model("edsr_xl", 3, convert_flax_params(params), dtype="bfloat16", device="cpu")
    assert _psnr(_run(net, x), ref) >= BF16_PSNR_FLOOR


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_zero_tail_is_exact_bicubic(scale):
    x = _x(10 + scale, (1, 9, 10, 3))
    net, trained = build_model("edsr_m", scale, dtype="float32", device="cpu")
    assert not trained
    got = _run(net, x)
    np.testing.assert_array_equal(got, resize_bicubic_up(torch.from_numpy(x), scale).numpy())
    ref, _ = _ref("edsr_m", scale, jnp.float32, x, pretrained=False)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_bicubic(jnp.asarray(x), scale)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("c,s", [(3, 2), (3, 3), (8, 2), (64, 2)])
def test_depth_to_space_order(c, s):
    x = _x(1, (2, 4, 5, c * s * s))
    ref = np.asarray(jax_d2s(jnp.asarray(x), s))
    np.testing.assert_array_equal(depth_to_space(torch.from_numpy(x), s).numpy(), ref)
    # pixel_shuffle after the channel permutation is the reference's shuffle
    t = torch.from_numpy(x).permute(0, 3, 1, 2)[:, shuffle_channel_order(c, s)]
    np.testing.assert_array_equal(F.pixel_shuffle(t, s).permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("name", sorted(set(MODEL_REGISTRY) - set(PORT_ONLY)))
def test_converted_tree_fits_every_registry_net(name):
    _, params = jax_build(name, 4, dtype=jnp.float32, pretrained=False)
    sd = convert_flax_params(jax.tree_util.tree_map(np.asarray, params))
    net, _ = build_model(name, 4, dtype="float32", device="cpu")
    ref_sd = net.state_dict()
    assert sd.keys() == ref_sd.keys()
    for k, v in sd.items():
        assert v.shape == ref_sd[k].shape, k


def test_seeded_params_are_deterministic_and_change_pixels():
    a = seeded_params("edsr_m", 2, seed=3)
    b = seeded_params("edsr_m", 2, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["tail.weight"].abs().max() > 0
    assert not torch.equal(a["head.weight"], seeded_params("edsr_m", 2, seed=4)["head.weight"])
    x = _x(2, (1, 8, 8, 3))
    net, trained = build_model("edsr_m", 2, a, dtype="float32", device="cpu")
    assert trained
    assert np.abs(_run(net, x) - resize_bicubic_up(torch.from_numpy(x), 2).numpy()).max() > 0.1


def test_shuffle_factors():
    assert _shuffle_factors(2) == [2]
    assert _shuffle_factors(4) == [2, 2]
    assert _shuffle_factors(6) == [2, 3]
    with pytest.raises(ValueError):
        _shuffle_factors(5)
