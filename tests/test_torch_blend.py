"""Port parity: the canvas-pyramid Laplacian blend with separable ramp
profiles and the banded finalize (srs_tpu_torch.ops.blend) against the JAX
reference, at 3-4 tiles.

Tolerances: atol 1e-3 on float canvases in [0, 255] (float32 sums in
another order); uint8 bands equal except at rounding ties, where the
reference's float value lies within 1e-3 of a half and the two sides may
round apart by 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import blend as JB
from srs_tpu.ops.resize import resize_bicubic_banded as jax_resize_banded
from srs_tpu.ops.tiles import extract_tiles as jax_extract
from srs_tpu.ops.weights import layout_weight_profiles
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu_torch.ops import blend as TB
from srs_tpu_torch.tiling.geometry import compute_layout

ATOL = 1e-3
TIE = 1e-3

# (w, h, block, overlap, step_multiple, scale): a 3-tile row, a 2x2 grid,
# and odd blocks whose small overlap clamps the blend to one level.
CASES = [(72, 32, 32, 0.2, 1, 4), (48, 48, 32, 0.25, 8, 3), (45, 30, 25, 0.2, 1, 1)]


def _tiles(case, seed=0):
    w, h, block, ratio, mult, scale = case
    lo = compute_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    ref_lo = jax_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : lo.padded_h, 0 : lo.padded_w].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(xx / 9.0), 128 + 80 * np.cos(yy / 7.0),
                    128 + 60 * np.sin((xx + yy) / 5.0)], -1)
    tiles = np.asarray(jax_extract(jnp.asarray(img, jnp.float32), ref_lo))
    # per-tile disagreement, as SR tiles have in their overlaps
    tiles = np.clip(tiles + rng.normal(0, 4, tiles.shape), 0, 255).astype(np.float32)
    return lo, ref_lo, tiles


def _blend_both(case, levels=6):
    lo, ref_lo, tiles = _tiles(case)
    wy, wx = layout_weight_profiles(ref_lo)
    got = TB.laplacian_fusion_tiles(torch.from_numpy(tiles), lo, (wy, wx), levels=levels,
                                    clip_range=None, collapse_last=False)
    ref = JB.laplacian_fusion_tiles(jnp.asarray(tiles), None, ref_lo, levels=levels,
                                    weight_profiles=(wy, wx), clip_range=None,
                                    collapse_last=False)
    return lo, got, ref


@pytest.mark.parametrize("case", CASES)
def test_canvas_pyramid_blend_matches_reference(case):
    _, got, ref = _blend_both(case)
    assert isinstance(got, tuple) == isinstance(ref, tuple)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_collapsed_clipped_canvas_matches_reference(case):
    lo, ref_lo, tiles = _tiles(case, seed=1)
    wy, wx = layout_weight_profiles(ref_lo)
    got = TB.laplacian_fusion_tiles(torch.from_numpy(tiles), lo, (wy, wx), levels=6)
    ref = JB.laplacian_fusion_tiles(jnp.asarray(tiles), None, ref_lo, levels=6,
                                    weight_profiles=(wy, wx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0


def test_one_level_deferred_collapse_is_unclipped():
    # Overlap 4 clamps the blend to one level; with collapse_last=False the
    # reference returns that canvas before clip_range applies.
    lo = compute_layout(40, 40, block_size=16, overlap_ratio=0.25)
    ref_lo = jax_layout(40, 40, block_size=16, overlap_ratio=0.25)
    rng = np.random.default_rng(0)
    tiles = rng.uniform(-100, 400, (lo.num_tiles, 16, 16, 3)).astype(np.float32)
    wy, wx = layout_weight_profiles(ref_lo)
    got = TB.laplacian_fusion_tiles(torch.from_numpy(tiles), lo, (wy, wx), levels=6,
                                    clip_range=(0, 255), collapse_last=False)
    ref = JB.laplacian_fusion_tiles(jnp.asarray(tiles), None, ref_lo, levels=6,
                                    weight_profiles=(wy, wx), clip_range=(0, 255),
                                    collapse_last=False)
    assert lo.num_tiles == 9 and not isinstance(ref, tuple) and not isinstance(got, tuple)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _finalize_both(case, out_hw, to_uint8, bands):
    lo, got, ref = _blend_both(case)
    crop_h, crop_w = lo.image_h, lo.image_w
    out_h, out_w = out_hw(crop_h, crop_w)
    kw = dict(bands=bands, crop_h=crop_h, crop_w=crop_w, to_uint8=to_uint8)
    if isinstance(ref, tuple):
        g = TB.blend_finalize_banded(got[0], got[1], out_h, out_w, **kw)
        r = JB.blend_finalize_banded(ref[0], ref[1], out_h, out_w, **kw)
    else:  # one level: the reference finishes with a plain banded resize
        g = TB.blend_finalize_banded(got, None, out_h, out_w, **kw)
        r = jax_resize_banded(ref, out_h, out_w, **kw)
    assert g.shape == r.shape == (out_h, out_w, 3)
    return g, np.asarray(r)


SIZES = {
    "upscale": lambda h, w: (int(h * 1.07) + 1, int(w * 1.063) + 3),
    "same": lambda h, w: (h, w),
    "int_down": lambda h, w: (h // 2, w // 2),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_finalize_float_matches_reference(case, size):
    g, r = _finalize_both(case, SIZES[size], False, bands=3)
    np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_finalize_uint8_equal_except_ties(case):
    g, r = _finalize_both(case, SIZES["upscale"], True, bands=4)
    _, rf = _finalize_both(case, SIZES["upscale"], False, bands=4)
    assert g.dtype == r.dtype == np.uint8
    diff = np.abs(g.astype(np.int16) - r.astype(np.int16))
    assert diff.max() <= 1
    ties = np.abs(np.abs(rf - np.floor(rf)) - 0.5) < TIE
    assert np.all(ties[diff > 0])


def test_finalize_uint16():
    g, r = _finalize_both(CASES[0], SIZES["upscale"], "uint16", bands=2)
    assert g.dtype == r.dtype == np.uint16
    assert np.abs(g.astype(np.int32) - r.astype(np.int32)).max() <= 1
