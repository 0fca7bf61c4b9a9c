"""Port parity: seam detection and repair (srs_tpu_torch.ops.seam) and
colour correction (srs_tpu_torch.ops.color) against the JAX reference.

Tolerances:
- windowed SSIM atol 5e-4: the reference's variance E[x^2] - E[x]^2
  cancels in float32; against float64 window means it is itself off by
  up to 2.5e-4 on these scenes;
- detection on the same SSIM map: the same seams exactly; on the port's
  own map, the same seams where no window score and no merged mean lies
  within that 5e-4 of a threshold (the test checks that of its scene);
- the vectorised merge equal to the reference's greedy walk;
- repair of the same seams: atol 1e-3 against the reference (float32, 200
  Jacobi iterations), and exactly equal between the port's waves and its
  one-seam-at-a-time order;
- histogram LUTs: exact, ties to the lowest bin. The reference's jitted
  LUT can take a neighbouring bin where two bins' float32 distances tie
  exactly when computed apart (XLA evaluates them fused); such a bin is
  accepted when the two distances agree within 1e-4;
- mean-std matching and the guided filter atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import color as JC
from srs_tpu.ops import seam as JS
from srs_tpu.ops.tiles import extract_tiles as jax_extract
from srs_tpu.ops.tiles import merge_tiles as jax_merge
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu_torch.ops import color as TC
from srs_tpu_torch.ops import seam as TS
from srs_tpu_torch.ops.tiles import extract_tiles
from srs_tpu_torch.ops.weights import layout_weights
from srs_tpu_torch.tiling.geometry import compute_layout

# (w, h, block, overlap, step_multiple): 2x3 and 3x3 grids of 64-px tiles
GRIDS = [(160, 112, 64, 0.25, 8), (176, 176, 64, 0.3, 8)]


def _scene(grid, seed):
    """Layout, source tiles that disagree in their overlaps (noise of a
    different strength per tile), and the fused canvas of them."""
    w, h, block, ratio, mult = grid
    lo = compute_layout(w, h, block, ratio, step_multiple=mult)
    ref_lo = jax_layout(w, h, block, ratio, step_multiple=mult)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : lo.padded_h, 0 : lo.padded_w].astype(np.float32)
    img = np.stack([128 + 70 * np.sin(xx / 11.0), 128 + 70 * np.cos(yy / 9.0),
                    128 + 50 * np.sin((xx + yy) / 13.0)], -1).astype(np.float32)
    tiles = np.array(jax_extract(jnp.asarray(img), ref_lo))
    for t in range(lo.num_tiles):
        tiles[t] += rng.normal(0, 4 + 12 * (t % 3), tiles[t].shape)
    weights = layout_weights(lo, "ramp")
    canvas = np.asarray(jax_merge(jnp.asarray(tiles), weights, ref_lo))
    return lo, ref_lo, tiles, canvas


SSIM_ATOL = 5e-4
THRESHOLDS = (0.95, 0.92, 0.85)  # detection, medium, high


@pytest.mark.parametrize("win,stride", [(16, 8), (8, 4)])
@pytest.mark.parametrize("grid", GRIDS)
def test_windowed_ssim_map_matches_reference(grid, win, stride):
    lo, ref_lo, tiles, canvas = _scene(grid, 0)
    result = np.asarray(jax_extract(jnp.asarray(canvas), ref_lo))
    got = TS.windowed_ssim_map(torch.from_numpy(result), torch.from_numpy(tiles), win, stride)
    ref = JS.windowed_ssim_map(jnp.asarray(result), jnp.asarray(tiles), win, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SSIM_ATOL, rtol=0)


def _same(got, ref):
    assert [(g.x, g.y, g.width, g.height, g.severity) for g in got] == \
        [(r.x, r.y, r.width, r.height, r.severity) for r in ref]
    np.testing.assert_allclose([g.ssim_score for g in got], [r.ssim_score for r in ref],
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("threshold", [0.95, 0.99])
@pytest.mark.parametrize("grid", GRIDS)
def test_detect_seams_matches_reference_on_the_same_map(grid, threshold, monkeypatch):
    lo, ref_lo, tiles, canvas = _scene(grid, 1)
    result = np.asarray(jax_extract(jnp.asarray(canvas), ref_lo))
    smap = np.asarray(JS.windowed_ssim_map(jnp.asarray(result), jnp.asarray(tiles)))
    monkeypatch.setattr(TS, "windowed_ssim_map", lambda *a, **k: torch.from_numpy(smap))
    stats = {}
    got = TS.detect_seams(torch.from_numpy(result), torch.from_numpy(tiles), lo,
                          threshold=threshold, stats=stats)
    ref = JS.detect_seams(jnp.asarray(result), jnp.asarray(tiles), ref_lo, threshold=threshold)
    assert len(got) > 0
    _same(got, ref)
    assert stats["flagged_windows"] == int((smap < threshold).sum())
    assert {s.severity for s in got} == {"high", "medium", "low"}


def test_detect_seams_matches_reference():
    """The whole detection, on a scene whose window scores and merged
    means all lie further than SSIM_ATOL from every threshold."""
    lo, ref_lo, tiles, canvas = _scene(GRIDS[0], 1)
    result = extract_tiles(torch.from_numpy(canvas), lo)
    ref = JS.detect_seams(jnp.asarray(result.numpy()), jnp.asarray(tiles), ref_lo)
    smap = np.asarray(JS.windowed_ssim_map(jnp.asarray(result.numpy()), jnp.asarray(tiles)))
    scores = np.concatenate([smap.reshape(-1), [r.ssim_score for r in ref]])
    assert min(np.abs(scores - t).min() for t in THRESHOLDS) > SSIM_ATOL
    got = TS.detect_seams(result, torch.from_numpy(tiles), lo)
    assert len(got) == len(ref) > 0
    assert [(g.x, g.y, g.width, g.height, g.severity) for g in got] == \
        [(r.x, r.y, r.width, r.height, r.severity) for r in ref]
    np.testing.assert_allclose([g.ssim_score for g in got], [r.ssim_score for r in ref],
                               atol=SSIM_ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_vectorised_merge_equals_the_greedy_walk(seed):
    """Random windows on a stride-8 grid, with duplicates (tiles overlap)
    and ties, merged as the reference's walk over Seam objects merges them."""
    rng = np.random.default_rng(seed)
    n = 400
    x = rng.integers(0, 40, n) * 8
    y = rng.integers(0, 12, n) * 8
    x[: n // 4] = x[n // 4 : n // 2]  # duplicates
    y[: n // 4] = y[n // 4 : n // 2]
    score = rng.uniform(0.5, 0.95, n).astype(np.float32).astype(np.float64)
    got = TS._merge_windows(x, y, score, 16)
    ref = TS._merge_adjacent([TS.Seam(int(a), int(b), 16, 16, float(s))
                              for a, b, s in zip(x, y, score)], 16)
    assert [(s.x, s.y, s.width, s.height) for s in got] == \
        [(s.x, s.y, s.width, s.height) for s in ref]
    np.testing.assert_array_equal([s.ssim_score for s in got], [s.ssim_score for s in ref])
    assert TS._merge_windows(x[:0], y[:0], score[:0], 16) == TS._merge_adjacent([], 16) == []


def _ref_seams(grid, seed):
    """Scene and the reference's seams, as the reference's and the port's
    Seam objects."""
    lo, ref_lo, tiles, canvas = _scene(grid, seed)
    result = np.asarray(jax_extract(jnp.asarray(canvas), ref_lo))
    ref = JS.detect_seams(jnp.asarray(result), jnp.asarray(tiles), ref_lo)
    ours = [TS.Seam(s.x, s.y, s.width, s.height, s.ssim_score) for s in ref]
    return lo, ref_lo, tiles, canvas, ref, ours


@pytest.mark.parametrize("with_sources", [True, False])
@pytest.mark.parametrize("grid", GRIDS)
def test_repair_seams_matches_reference(grid, with_sources):
    lo, ref_lo, tiles, canvas, ref, ours = _ref_seams(grid, 2)
    bad = [s for s in ours if s.severity != "low"]
    assert any(s.severity == "high" for s in bad) and any(s.severity == "medium" for s in bad)
    src = torch.from_numpy(tiles) if with_sources else None
    stats = {}
    out = TS.repair_seams(torch.from_numpy(canvas), bad, src, lo if with_sources else None,
                          stats=stats)
    want = JS.repair_seams(jnp.asarray(canvas), [s for s in ref if s.severity != "low"],
                           jnp.asarray(tiles) if with_sources else None,
                           ref_lo if with_sources else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    assert 1 <= stats["waves"] <= len(bad)
    assert not np.array_equal(out.numpy(), canvas)


@pytest.mark.parametrize("grid", GRIDS)
def test_repair_waves_equal_one_seam_at_a_time(grid):
    lo, _, tiles, canvas, _, ours = _ref_seams(grid, 3)
    seams = ours + ours[::3]  # repeats overlap their first repair
    src = torch.from_numpy(tiles)
    stats = {}
    fast = TS.repair_seams(torch.from_numpy(canvas), seams, src, lo, stats=stats)
    repaired = [s for s in seams if s.severity != "low"]
    # the 3x3 grid's patches spread out: fewer waves than patches
    assert stats["waves"] < len(repaired) or grid == GRIDS[0]
    slow = torch.from_numpy(canvas)
    for s in seams:
        slow = TS.repair_seams(slow, [s], src, lo)
    torch.testing.assert_close(fast, slow, atol=0, rtol=0)


def test_repair_without_seams_is_identity():
    canvas = torch.rand(70, 80, 3) * 255
    torch.testing.assert_close(TS.repair_seams(canvas, []), canvas, atol=0, rtol=0)
    low = [TS.Seam(3, 4, 16, 16, 0.97)]
    torch.testing.assert_close(TS.repair_seams(canvas, low), canvas, atol=0, rtol=0)


@pytest.mark.parametrize("score,severity", [(0.5, "high"), (0.849, "high"), (0.85, "medium"),
                                            (0.919, "medium"), (0.92, "low"), (0.99, "low")])
def test_seam_severity_matches_reference(score, severity):
    got, ref = TS.Seam(0, 0, 16, 16, score), JS.Seam(0, 0, 16, 16, score)
    assert got.severity == ref.severity == severity
    assert got.repair_method == ref.repair_method


@pytest.mark.parametrize("seed", [0, 1])
def test_best_tile_matches_reference(seed):
    lo, ref_lo, *_ = _scene(GRIDS[1], seed)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        s = TS.Seam(int(rng.integers(0, 160)), int(rng.integers(0, 160)), 16, 16, 0.5)
        assert TS._best_tile_for(s, lo) == JS._best_tile_for(JS.Seam(s.x, s.y, 16, 16, 0.5),
                                                             ref_lo)


# -- colour ---------------------------------------------------------------------


def _images(seed, shape=(40, 52, 3)):
    rng = np.random.default_rng(seed)
    a = np.clip(rng.normal(120, 50, shape), -3, 258).astype(np.float32)
    b = np.clip(rng.gamma(2.0, 40.0, shape), 0, 255).astype(np.float32)
    return a, b


def _lut_agrees(got, want, src, ref):
    """Equal, or (per channel) a bin whose distance to the source CDF ties
    the reference's within 1e-4: see the module docstring."""
    if got.ndim == 2:
        got, want, src, ref = (a[..., None] for a in (got, want, src, ref))
    for c in range(got.shape[-1]):
        s = TC._cdf256(torch.from_numpy(src[..., c])).numpy()
        r = TC._cdf256(torch.from_numpy(ref[..., c])).numpy()
        bins = np.clip(src[..., c].astype(np.int32), 0, 255)
        off = got[..., c] != want[..., c]
        for b, g, w in zip(bins[off], got[..., c][off], want[..., c][off]):
            dg, dw = abs(r[int(g)] - s[b]), abs(r[int(w)] - s[b])
            assert abs(dg - dw) <= 1e-4 and (g < w or dg < dw), (b, g, w, dg, dw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cdf_and_histogram_matching_match_reference(seed):
    src, ref = _images(seed)
    for c in range(3):
        np.testing.assert_array_equal(TC._cdf256(torch.from_numpy(src[..., c])).numpy(),
                                      np.asarray(JC._cdf256(jnp.asarray(src[..., c]))))
    got = TC.histogram_matching(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    want = np.asarray(JC.histogram_matching(jnp.asarray(src), jnp.asarray(ref)))
    _lut_agrees(got, want, src, ref)
    got2 = TC.histogram_matching(torch.from_numpy(src[..., 1]), torch.from_numpy(ref[..., 1]))
    _lut_agrees(got2.numpy(), want[..., 1], src[..., 1], ref[..., 1])


def test_histogram_lut_breaks_ties_to_the_lowest_index():
    """A reference with empty bins has flat CDF runs: every bin of a run
    ties, and the LUT takes the lowest (numpy's argmin on the same float32
    distances, and the reference's)."""
    src = np.tile(np.arange(256, dtype=np.float32), (4, 1))[..., None].repeat(3, -1)
    ref = np.zeros_like(src)
    ref[:, :128] = 10.0
    ref[:, 128:] = 200.0
    got = TC.histogram_matching(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    s = TC._cdf256(torch.from_numpy(src[..., 0])).numpy()
    r = TC._cdf256(torch.from_numpy(ref[..., 0])).numpy()
    lut = np.argmin(np.abs(r[None, :] - s[:, None]), axis=1).astype(np.float32)
    np.testing.assert_array_equal(got[..., 0], lut[src[..., 0].astype(np.int64)])
    assert set(np.unique(got)) == {0.0, 10.0, 200.0}
    want = np.asarray(JC.histogram_matching(jnp.asarray(src), jnp.asarray(ref)))
    _lut_agrees(got, want, src, ref)


def test_mean_std_matching_matches_reference():
    src, ref = _images(3)
    got = TC.mean_std_matching(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    want = np.asarray(JC.mean_std_matching(jnp.asarray(src), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("radius,ndim", [(8, 3), (3, 2), (5, 3)])
def test_guided_filter_matches_reference(radius, ndim):
    g, s = _images(4)
    if ndim == 2:
        g, s = g[..., 0], s[..., 0]
    got = TC.guided_filter(torch.from_numpy(g), torch.from_numpy(s), radius, 0.01).numpy()
    want = np.asarray(JC.guided_filter(jnp.asarray(g), jnp.asarray(s), radius, 0.01))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["histogram", "mean_std", "none", "other"])
@pytest.mark.parametrize("local_filter", [False, True])
def test_color_correction_matches_reference(method, local_filter):
    img, ref = _images(5)
    got = TC.color_correction(torch.from_numpy(img), torch.from_numpy(ref), method,
                              local_filter).numpy()
    want = np.asarray(JC.color_correction(jnp.asarray(img), jnp.asarray(ref), method,
                                          local_filter))
    if method == "histogram" and not local_filter:
        _lut_agrees(got, want, img, ref)
    elif method == "histogram":
        # tied bins (see _lut_agrees) spread through the guided filter: the
        # reference's filter and clip of the port's matched image
        matched = TC.histogram_matching(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
        want = np.clip(np.asarray(JC.guided_filter(jnp.asarray(matched), jnp.asarray(img),
                                                   8, 0.01)), 0, 255)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
