"""Port parity: dense blend weights, the weighted merge and every fusion
method (srs_tpu_torch.ops.weights, .tiles, .blend) against the JAX
reference.

Tolerances (float32 canvases in [0, 255]): weights exact; merge and
weighted fusion atol 1e-4; the canvas-pyramid and reference-mode
Laplacian blends atol 1e-3 (pyramid sums in another order); the Poisson
solve atol 1e-6 of the solution's range (two FFT libraries in complex64);
gradient-domain fusion atol 1e-2 (the solve integrates the merged
gradients of every tile); seamless clone atol 1e-3; the banded resize of a
collapsed canvas atol 1e-3 (float) and equal uint8 bands except at rounding
ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import blend as JB
from srs_tpu.ops import weights as JW
from srs_tpu.ops.resize import resize_bicubic_banded as jax_resize_banded
from srs_tpu.ops.tiles import extract_tiles as jax_extract
from srs_tpu.ops.tiles import merge_tiles as jax_merge
from srs_tpu.ops.tiles import unpad_image as jax_unpad
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu_torch.ops import blend as TB
from srs_tpu_torch.ops import weights as TW
from srs_tpu_torch.ops.tiles import merge_tiles, unpad_image
from srs_tpu_torch.tiling.geometry import compute_layout

# (w, h, block, overlap, step_multiple, scale): a 3-tile row, a 2x2 grid,
# a 3x2 grid at x2, and odd blocks that clamp the blend to one level.
CASES = [(72, 32, 32, 0.2, 1, 4), (48, 48, 32, 0.25, 8, 3), (72, 48, 32, 0.25, 8, 2),
         (45, 30, 25, 0.2, 1, 1)]


def _setup(case, seed=0, noise=0.0):
    w, h, block, ratio, mult, scale = case
    lo = compute_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    ref_lo = jax_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : lo.padded_h, 0 : lo.padded_w].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(xx / 9.0), 128 + 80 * np.cos(yy / 7.0),
                    128 + 60 * np.sin((xx + yy) / 5.0)], -1).astype(np.float32)
    tiles = np.array(jax_extract(jnp.asarray(img), ref_lo))
    # tiles that disagree where they overlap, as upscaled tiles do
    tiles += rng.normal(0, noise, tiles.shape).astype(np.float32)
    return lo, ref_lo, tiles


@pytest.mark.parametrize("kind,weight_type,feather", [
    ("ramp", "cosine", None), ("distance", "linear", None), ("distance", "cosine", None),
    ("distance", "sigmoid", None), ("distance", "cosine", 3)])
@pytest.mark.parametrize("case", CASES)
def test_layout_weights_match_reference(case, kind, weight_type, feather):
    lo, ref_lo, _ = _setup(case)
    got = TW.layout_weights(lo, kind, weight_type, feather)
    ref = JW.layout_weights(ref_lo, kind, weight_type, feather)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("weight_type", ["linear", "cosine", "sigmoid"])
@pytest.mark.parametrize("hw,feather", [((16, 24), None), ((9, 5), 2), ((40, 33), 100)])
def test_distance_weight_map_matches_reference(weight_type, hw, feather):
    np.testing.assert_array_equal(TW.distance_weight_map(*hw, weight_type, feather),
                                  JW.distance_weight_map(*hw, weight_type, feather))


@pytest.mark.parametrize("overlaps", [(0, 0, 0, 0), (3, 0, 5, 0), (4, 4, 4, 4), (0, 7, 0, 2)])
def test_overlap_ramp_weight_matches_reference(overlaps):
    np.testing.assert_array_equal(TW.overlap_ramp_weight(12, 15, *overlaps),
                                  JW.overlap_ramp_weight(12, 15, *overlaps))


def test_unknown_weight_kinds_raise():
    lo, _, _ = _setup(CASES[0])
    with pytest.raises(ValueError, match="weight kind"):
        TW.layout_weights(lo, kind="gauss")
    with pytest.raises(ValueError, match="weight_type"):
        TW.layout_weights(lo, kind="distance", weight_type="cubic")


@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_merge_tiles_and_unpad_match_reference(case, premultiplied):
    lo, ref_lo, tiles = _setup(case, noise=5.0)
    w = TW.layout_weights(lo, "distance", "cosine")
    got = merge_tiles(torch.from_numpy(tiles), w, lo, premultiplied=premultiplied)
    ref = jax_merge(jnp.asarray(tiles), w, ref_lo, premultiplied=premultiplied)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(unpad_image(got, lo).numpy(), np.asarray(jax_unpad(ref, ref_lo)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["canvas", "reference"])
@pytest.mark.parametrize("weights", [("distance", "sigmoid"), ("ramp", "cosine")])
@pytest.mark.parametrize("case", CASES)
def test_dense_laplacian_blend_matches_reference(case, weights, mode):
    lo, ref_lo, tiles = _setup(case, noise=4.0)
    w = TW.layout_weights(lo, *weights)
    got = TB.laplacian_fusion_tiles(torch.from_numpy(tiles), lo, weights=w, levels=6,
                                    mode=mode)
    ref = JB.laplacian_fusion_tiles(jnp.asarray(tiles), jnp.asarray(w), ref_lo, levels=6,
                                    mode=mode)
    assert got.shape == (lo.padded_h, lo.padded_w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=0)


@pytest.mark.parametrize("kind", ["ramp", "distance"])
@pytest.mark.parametrize("case", CASES)
def test_weighted_fusion_matches_reference(case, kind):
    lo, ref_lo, tiles = _setup(case, noise=4.0)
    w = TW.layout_weights(lo, kind)
    got = TB.weighted_fusion_tiles(torch.from_numpy(tiles), w, lo)
    ref = JB.weighted_fusion_tiles(jnp.asarray(tiles), w, ref_lo)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    clipped = TB.weighted_fusion_tiles(torch.from_numpy(tiles), w, lo, clip_range=(0, 255))
    assert float(clipped.min()) >= 0 and float(clipped.max()) <= 255


@pytest.mark.parametrize("shape", [(37, 53, 3), (40, 64), (1, 5, 3), (2, 2, 1), (64, 1, 2)])
def test_poisson_solve_matches_reference(shape):
    div = np.random.default_rng(1).normal(0, 10, shape).astype(np.float32)
    got = TB.poisson_solve_neumann(torch.from_numpy(div)).numpy()
    ref = np.asarray(JB.poisson_solve_neumann(jnp.asarray(div)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.ptp(ref)), rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_dct_pair_is_exact_inverse(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(0, 1, (n, 4)).astype(np.float32))
    for axis in (0, 1):
        back = TB._idct2(TB._dct2(x, axis), axis)
        np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-4)
    ref = np.asarray(JB._dct2(jnp.asarray(x.numpy()), 0))
    np.testing.assert_allclose(TB._dct2(x, 0).numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_gradient_domain_fusion_matches_reference(case):
    lo, ref_lo, tiles = _setup(case, noise=4.0)
    w = TW.layout_weights(lo, "ramp")
    got = TB.gradient_domain_fusion_tiles(torch.from_numpy(tiles), w, lo).numpy()
    ref = np.asarray(JB.gradient_domain_fusion_tiles(jnp.asarray(tiles), w, ref_lo))
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("mode", ["normal", "mixed", "monochrome"])
@pytest.mark.parametrize("mask_ndim", [2, 3])
def test_seamless_clone_matches_reference(mode, mask_ndim):
    rng = np.random.default_rng(2)
    dst = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    src = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    mask = np.zeros((30, 40), np.float32)
    mask[5:25, 4:30] = 1
    if mask_ndim == 3:
        mask = mask[..., None]
    got = TB.seamless_clone(torch.from_numpy(dst), torch.from_numpy(src),
                            torch.from_numpy(mask), mode, iters=60).numpy()
    ref = np.asarray(JB.seamless_clone(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(mask),
                                       mode, 60))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_seamless_clone_batches_independent_problems():
    rng = np.random.default_rng(3)
    dst = torch.from_numpy(rng.uniform(0, 255, (3, 16, 16, 3)).astype(np.float32))
    src = torch.from_numpy(rng.uniform(0, 255, (3, 16, 16, 3)).astype(np.float32))
    mask = torch.zeros(16, 16, 1)
    mask[2:-2, 2:-2] = 1
    batched = TB.seamless_clone(dst, src, mask, "mixed", iters=30)
    for k in range(3):
        one = TB.seamless_clone(dst[k], src[k], mask, "mixed", iters=30)
        torch.testing.assert_close(batched[k], one, atol=0, rtol=0)


@pytest.mark.parametrize("out_hw,to_uint8", [((150, 260), False), ((150, 260), True),
                                             ((40, 70), False), ((96, 288), True)])
def test_finalize_of_collapsed_canvas_matches_reference_resize(out_hw, to_uint8):
    """``blend_finalize_banded(canvas, None, ...)`` is the reference's
    ``resize_bicubic_banded`` of a collapsed canvas (non-deferred save)."""
    lo, ref_lo, tiles = _setup(CASES[0], noise=3.0)
    w = TW.layout_weights(lo, "distance", "sigmoid")
    canvas = TB.laplacian_fusion_tiles(torch.from_numpy(tiles), lo, weights=w)
    crop = dict(crop_h=lo.image_h - 3, crop_w=lo.image_w - 5)
    got = TB.blend_finalize_banded(canvas, None, *out_hw, bands=4, to_uint8=to_uint8, **crop)
    ref = jax_resize_banded(jnp.asarray(canvas.numpy()), *out_hw, bands=4, to_uint8=to_uint8,
                            **crop)
    ref_f = jax_resize_banded(jnp.asarray(canvas.numpy()), *out_hw, bands=4, **crop)
    assert got.shape == ref.shape == (*out_hw, 3)
    if not to_uint8:
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    else:
        diff = np.abs(got.astype(np.int16) - ref)
        tie = np.abs(np.asarray(ref_f) - np.floor(np.asarray(ref_f)) - 0.5) < 1e-3
        assert diff.max() <= 1 and not (diff[~tie] > 0).any()
