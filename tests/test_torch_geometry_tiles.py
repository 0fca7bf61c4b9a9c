"""Port parity: tile geometry, ramp profiles, padding and tile extraction
(srs_tpu_torch.tiling / ops.weights / ops.tiles) against the JAX
reference. Everything here must match exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops.pallas.pyramid_pallas import decimation_matrix as jax_decimation
from srs_tpu.ops.tiles import extract_tiles as jax_extract, pad_image as jax_pad
from srs_tpu.ops.weights import layout_weight_profiles as jax_profiles, profile_pyramid as jax_ppyr
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu.tiling.tiling import TilingModule as JaxTiling
from srs_tpu_torch.ops.tiles import extract_tiles, pad_image
from srs_tpu_torch.ops.weights import decimation_matrix, layout_weight_profiles, profile_pyramid
from srs_tpu_torch.tiling.geometry import compute_layout
from srs_tpu_torch.tiling.tiling import TilingModule

LAYOUT_CASES = [
    (1280, 720, 512, 0.2, 32),  # the 720p -> 100MP main path: 3x2 tiles
    (128, 96, 64, 0.2, 32),
    (80, 80, 64, 0.2, 32),
    (72, 40, 32, 0.2, 1),
    (50, 30, 64, 0.25, 1),  # smaller than one block
    (300, 200, 100, 0.1, 8),
]


def _same_layout(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, np.asarray(vb))
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_layout_matches_reference(case):
    w, h, block, ratio, mult = case
    lo = compute_layout(w, h, block, ratio, step_multiple=mult)
    ref = jax_layout(w, h, block, ratio, step_multiple=mult)
    _same_layout(lo, ref)
    _same_layout(lo.scaled(9), ref.scaled(9))


def test_main_path_layout():
    lo = compute_layout(1280, 720, 512, 0.2, step_multiple=32).scaled(9)
    assert (lo.nx, lo.ny, lo.block, lo.padded_h, lo.padded_w) == (3, 2, 4608, 8064, 11520)


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_profiles_and_pyramids_match_reference(case):
    w, h, block, ratio, mult = case
    lo = compute_layout(w, h, block, ratio, step_multiple=mult).scaled(3)
    ref = jax_layout(w, h, block, ratio, step_multiple=mult).scaled(3)
    wy, wx = layout_weight_profiles(lo)
    ry, rx = jax_profiles(ref)
    np.testing.assert_array_equal(wy, ry)
    np.testing.assert_array_equal(wx, rx)
    for a, b in zip(profile_pyramid(wx, 6), jax_ppyr(rx, 6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 63, 512])
def test_decimation_matrix_copy(n):
    np.testing.assert_array_equal(decimation_matrix(n), jax_decimation(n))


@pytest.mark.parametrize("mode", ["mirror", "reflect", "replicate", "constant"])
def test_pad_and_extract_match_reference(mode):
    img = (np.random.default_rng(0).random((40, 72, 3)) * 255).astype(np.float32)
    lo = compute_layout(72, 40, 32, 0.2)
    ref_lo = jax_layout(72, 40, 32, 0.2)
    got = pad_image(torch.from_numpy(img), lo, mode, constant_value=7.0)
    ref = jax_pad(jnp.asarray(img), ref_lo, mode, constant_value=7.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(extract_tiles(got, lo).numpy(),
                                  np.asarray(jax_extract(ref, ref_lo)))


def test_mirror_is_reflect101_beyond_one_period():
    """Padding longer than the image reflects again (numpy/jnp rules)."""
    img = np.arange(3 * 2 * 1, dtype=np.float32).reshape(3, 2, 1)
    lo = compute_layout(2, 3, 8, 0.25)
    got = pad_image(torch.from_numpy(img), lo, "mirror")[:, 0, 0].tolist()
    assert got[:8] == [0, 2, 4, 2, 0, 2, 4, 2]


def test_split_to_batch_matches_reference():
    img = (np.random.default_rng(1).random((96, 128, 3)) * 255).astype(np.float32)
    lo, tiles = TilingModule(64, 0.2).split_to_batch(img, "cpu")
    ref_lo, ref_tiles = JaxTiling(64, 0.2).split_to_batch(img)
    _same_layout(lo, ref_lo)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(ref_tiles))
    assert tiles.dtype == torch.float32
