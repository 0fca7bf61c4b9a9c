"""Port parity: bicubic resize pieces (srs_tpu_torch.ops.resize) against
the JAX reference. Tolerance: atol 1e-4 on data in [0, 255] for resampled
values (float32 rounding); tap plans and band operators match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import resize as R
from srs_tpu_torch.ops import resize as T

ATOL = 1e-4


def _data(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_resize_bicubic_up_matches_reference(scale):
    x = _data((2, 13, 17, 3), seed=scale)
    got = T.resize_bicubic_up(torch.from_numpy(x), scale).numpy()
    ref = np.asarray(R.resize_bicubic_up(jnp.asarray(x), scale))
    assert got.shape == ref.shape == (2, 13 * scale, 17 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_resize_bicubic_up_matches_general_resize():
    """Integer upscale agrees with the reference's arbitrary-size resize
    (cv2 INTER_CUBIC parity in the reference's own tests)."""
    x = _data((1, 9, 11, 3), seed=7)
    got = T.resize_bicubic_up(torch.from_numpy(x), 3).numpy()
    ref = np.asarray(R.resize_bicubic(jnp.asarray(x), 27, 33))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("f", [0.0, 0.25, 0.5, 0.8333])
def test_cubic_weights_last_tap_normalized(f):
    w = T.cubic_weights(np.array([f]))
    np.testing.assert_array_equal(w, R.cubic_weights(np.array([f])))
    assert abs(float(w.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("src,dst", [(11520, 12245), (100, 37), (37, 100), (64, 64)])
def test_axis_plan_matches_reference(src, dst):
    idx, w = T._axis_plan(src, dst)
    ridx, rw = R._axis_plan(src, dst)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(w, rw)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_down_axis_int_matches_reference(s):
    x = _data((12, 24, 3), seed=s)
    for axis in (0, 1):
        got = T._down_axis_int(torch.from_numpy(x), axis, s).numpy()
        ref = np.asarray(R._down_axis_int(jnp.asarray(x), axis, s))
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst,block", [(50, 73, 16), (96, 150, 64), (40, 41, 2048)])
def test_w_block_resize_matches_reference(src, dst, block):
    starts, src_b, out_b, mats = T._w_block_plan(src, dst, block)
    rs, rsb, rob, rmats = R._w_block_plan(src, dst, block)
    assert (starts, src_b, out_b) == (rs, rsb, rob)
    np.testing.assert_array_equal(mats, rmats)
    x = _data((5, src, 3), seed=9)
    got = T._resize_w_blocked(torch.from_numpy(x), dst, torch.from_numpy(mats), starts, src_b)
    ref = R._resize_w_blocked(jnp.asarray(x), dst, jnp.asarray(rmats), rs, rsb, rob)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_band_matrix_matches_reference():
    idx, w = R._axis_plan(30, 47)
    np.testing.assert_array_equal(T._band_matrix(idx, w, 30), R._band_matrix(idx, w, 30))
