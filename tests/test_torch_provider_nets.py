"""Port parity: the fast net ESPCN (and its scale-1 polish), RCAN and the
conditioned polish CondPolish (srs_tpu_torch.models) against the JAX nets,
with the packaged trained checkpoints converted by ``convert_flax_params``,
on inputs of at most 48 px.

Tolerances:
- float32 on both sides: atol 1e-3 on outputs in [0, 255] (convolutions
  summed in another order);
- bfloat16 on both sides: PSNR between the two outputs >= 45 dB (the two
  frameworks round bf16 at different places);
- a zero last conv reproduces bicubic (the polishes: the input) within
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.models.conditioning import build_cond_polish as jax_cond_polish
from srs_tpu.models.conditioning import cond_vector as jax_cond_vector
from srs_tpu.models.registry import build_model as jax_build
from srs_tpu_torch.models.conditioning import build_cond_polish, cond_vector
from srs_tpu_torch.models.registry import build_model, convert_flax_params, seeded_params
from srs_tpu_torch.ops.resize import resize_bicubic_up

F32_ATOL = 1e-3
BF16_PSNR_FLOOR = 45.0


def _x(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 255) - np.clip(b, 0, 255)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _net_pair(name, scale, dtype):
    """(reference output fn, port net, trained) with the packaged weights."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    if name == "cond_polish":
        module, params, trained = jax_cond_polish(dtype=jdtype)
        net, ported = build_cond_polish(convert_flax_params(_tree(params)), dtype, device="cpu")

        def ref(x, c="food"):
            return np.asarray(module.apply(params, jnp.asarray(x), jax_cond_vector(c)))
        return ref, lambda x, c="food": net(torch.from_numpy(x), cond_vector(c)), trained, ported
    module, params = jax_build(name, scale, dtype=jdtype)
    net, ported = build_model(name, scale, convert_flax_params(_tree(params)), dtype=dtype,
                              device="cpu")
    return (lambda x: np.asarray(module.apply(params, jnp.asarray(x))),
            lambda x: net(torch.from_numpy(x)), True, ported)


# every packaged checkpoint of these nets, and CondPolish
F32_CASES = [("espcn", 2), ("espcn", 3), ("espcn", 4), ("espcn_polish", 1), ("rcan", 2),
             ("rcan", 3), ("rcan", 4), ("cond_polish", 1)]


@pytest.mark.parametrize("name,scale", F32_CASES)
def test_trained_net_float32_parity(name, scale):
    x = _x(scale, (2, 20, 22, 3))
    ref, port, trained, ported = _net_pair(name, scale, "float32")
    assert trained and ported
    with torch.inference_mode():
        got = port(x).numpy()
    want = ref(x)
    assert got.shape == want.shape == (2, 20 * scale, 22 * scale, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    # the trained net does change the pixels
    assert np.abs(want - resize_bicubic_up(torch.from_numpy(x), scale).numpy()).max() > 1.0


@pytest.mark.parametrize("name,scale", [("espcn", 3), ("espcn_polish", 1), ("rcan", 2),
                                        ("cond_polish", 1)])
def test_trained_net_bf16_psnr_floor(name, scale):
    x = _x(10 + scale, (1, 48, 48, 3))
    ref, port, _, _ = _net_pair(name, scale, "bfloat16")
    with torch.inference_mode():
        assert _psnr(port(x).numpy(), ref(x)) >= BF16_PSNR_FLOOR


@pytest.mark.parametrize("category", ["beauty", "3c", "jewelry", "no-such-category"])
def test_cond_polish_categories_and_batched_conditioning(category):
    """One vector per image (B, COND_DIM) against the reference's batched
    FiLM, and each category's vector."""
    x = _x(7, (2, 16, 18, 3))
    module, params, _ = jax_cond_polish(dtype=jnp.float32)
    c = np.stack([np.asarray(jax_cond_vector(category)), np.asarray(jax_cond_vector("food"))])
    want = np.asarray(module.apply(params, jnp.asarray(x), jnp.asarray(c)))
    net, _ = build_cond_polish(convert_flax_params(_tree(params)), "float32", device="cpu")
    with torch.inference_mode():
        got = net(torch.from_numpy(x), torch.from_numpy(c)).numpy()
        one = net(torch.from_numpy(x[:1]), cond_vector(category)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(one, got[:1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,scale", [("espcn", 2), ("espcn", 4), ("rcan", 3),
                                        ("espcn_polish", 1), ("cond_polish", 1)])
def test_untrained_net_is_bicubic_or_identity(name, scale):
    x = _x(20 + scale, (1, 9, 10, 3))
    if name == "cond_polish":
        net, trained = build_cond_polish(dtype="float32", device="cpu")
        with torch.inference_mode():
            got = net(torch.from_numpy(x), cond_vector("food")).numpy()
    else:
        net, trained = build_model(name, scale, dtype="float32", device="cpu")
        with torch.inference_mode():
            got = net(torch.from_numpy(x)).numpy()
    assert not trained
    np.testing.assert_allclose(got, resize_bicubic_up(torch.from_numpy(x), scale).numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,scale,last", [("espcn", 3, "conv_out"), ("rcan", 2, "tail"),
                                             ("espcn_polish", 4, "conv_out"),
                                             ("cond_polish", 1, "conv_out")])
def test_seeded_params_scale_the_last_conv(name, scale, last):
    """The zero-init layer of each family takes ``tail_gain``; every other
    weight is He-uniform over its fan-in (the FiLM layer's too)."""
    sd = seeded_params(name, scale, seed=1)
    full = seeded_params(name, scale, seed=1, tail_gain=1.0)
    for k, v in sd.items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif k.startswith(f"{last}."):
            torch.testing.assert_close(v, full[k] * 0.02)
        else:
            assert torch.equal(v, full[k]), k
            assert v.abs().max() <= (6.0 / v[0].numel()) ** 0.5, k
    x = _x(3, (1, 12, 12, 3))
    if name == "cond_polish":
        net, trained = build_cond_polish(sd, "float32", device="cpu")
        with torch.inference_mode():
            out = net(torch.from_numpy(x), cond_vector("food")).numpy()
        base = x
    else:
        net, trained = build_model(name, scale, sd, dtype="float32", device="cpu")
        with torch.inference_mode():
            out = net(torch.from_numpy(x)).numpy()
        base = resize_bicubic_up(torch.from_numpy(x), net.scale).numpy()
    # a residual the size of an SR net's, not of the [0, 255] range
    assert trained and 0.1 < np.abs(out - base).max() < 40.0
