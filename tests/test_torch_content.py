"""Port parity: content-aware tiling (srs_tpu_torch.tiling.content and
.content_layout) against the JAX reference.

Tolerances: saliency atol 1e-4 on its [0, 1] map (two FFT libraries in
complex64); local entropy atol 1e-5; the forbidden zone equal except at
pixels whose reference saliency lies within 1e-4 of the threshold; the
OpenCV detectors' boxes equal where cv2 imports (both sides call the same
cv2); seam placement and its weights exact (numpy on both sides).
"""

import numpy as np
import pytest
import torch

from srs_tpu.tiling import content as JCA
from srs_tpu.tiling import content_layout as JCL
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu_torch.tiling import content as TCA
from srs_tpu_torch.tiling import content_layout as TCL
from srs_tpu_torch.tiling.geometry import compute_layout

SAL_ATOL = 1e-4


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 60 * np.sin(xx / 17.0 + c) * np.cos(yy / 13.0) for c in range(3)], -1)
    for _ in range(5):  # hard-edged blocks and bars: salient, and MSER finds them
        y0, x0 = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y0 : y0 + rng.integers(8, 24), x0 : x0 + rng.integers(8, 40)] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((64, 96), 0), ((57, 83), 1), ((120, 80), 2)])
def test_saliency_and_entropy_match_reference(shape, seed):
    img = _photo(*shape, seed)
    ours = TCA.ContentAnalyzer(device="cpu")
    ref = JCA.ContentAnalyzer()
    np.testing.assert_allclose(ours.compute_saliency_map(img), ref.compute_saliency_map(img),
                               atol=SAL_ATOL, rtol=0)
    np.testing.assert_allclose(ours.compute_local_entropy(img), ref.compute_local_entropy(img),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_forbidden_zone_and_boxes_match_reference(seed):
    img = _photo(96, 128, seed)
    ours = TCA.ContentAnalyzer(device="cpu")
    ref = JCA.ContentAnalyzer()
    assert ours.detect_faces(img) == ref.detect_faces(img)
    assert ours.detect_text_regions(img) == ref.detect_text_regions(img)
    zone, counts = ours.forbidden_zone_map(img)
    want = ref.create_forbidden_zone_map(img)
    near = np.abs(ref.compute_saliency_map(img) - ref.saliency_threshold) <= SAL_ATOL
    assert not (zone != want)[~near].any()
    np.testing.assert_array_equal(ours.create_forbidden_zone_map(img), zone)
    assert counts == {"faces": len(ref.detect_faces(img)),
                      "text_boxes": len(ref.detect_text_regions(img))}


def test_without_cv2_the_zone_is_saliency_alone(monkeypatch):
    monkeypatch.setattr(TCA, "_cv2", lambda: None)
    img = _photo(80, 100, 4)
    ours = TCA.ContentAnalyzer(device="cpu")
    assert ours.detect_faces(img) == [] and ours.detect_text_regions(img) == []
    zone, counts = ours.forbidden_zone_map(img)
    assert counts == {"faces": 0, "text_boxes": 0}
    np.testing.assert_array_equal(zone, ours.compute_saliency_map(img) > 0.7)


def test_tile_statistics_match_reference():
    img = _photo(40, 50, 5)
    assert TCA.ContentAnalyzer.tile_complexity(img) == pytest.approx(
        JCA.ContentAnalyzer.tile_complexity(img), abs=1e-5)
    zone = np.random.default_rng(0).random((40, 50)) > 0.6
    for box in [(0, 0, 10, 10), (5, 7, 30, 20), (45, 35, 10, 10), (60, 60, 5, 5)]:
        assert TCA.ContentAnalyzer.forbidden_ratio(zone, *box) == \
            JCA.ContentAnalyzer.forbidden_ratio(zone, *box)


def test_analyzer_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCA.ContentAnalyzer()


# (w, h, block, overlap, step_multiple, scale)
LAYOUTS = [(160, 112, 64, 0.25, 8, 1), (176, 176, 64, 0.3, 8, 2), (300, 90, 48, 0.2, 1, 3)]


def _zone(lo, seed):
    rng = np.random.default_rng(seed)
    zone = np.zeros((lo.padded_h, lo.padded_w), bool)
    for _ in range(8):
        y0, x0 = rng.integers(0, lo.padded_h), rng.integers(0, lo.padded_w)
        zone[y0 : y0 + rng.integers(4, 40), x0 : x0 + rng.integers(4, 40)] = True
    return zone


@pytest.mark.parametrize("band,feather", [(8, None), (4, 6)])
@pytest.mark.parametrize("case", LAYOUTS)
def test_seam_placement_matches_reference(case, band, feather):
    w, h, block, ratio, mult, scale = case
    lo = compute_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    ref_lo = jax_layout(w, h, block, ratio, step_multiple=mult).scaled(scale)
    zone = _zone(lo, scale)
    for axis in (0, 1):
        assert TCL.choose_crossovers(lo, zone, axis, band, feather) == \
            JCL.choose_crossovers(ref_lo, zone, axis, band, feather)
        for line in (0, 17, zone.shape[axis] - 1):
            assert TCL.seam_cost(zone, axis, line, band) == JCL.seam_cost(zone, axis, line, band)
    np.testing.assert_array_equal(TCL.content_aware_weights(lo, zone, band, feather),
                                  JCL.content_aware_weights(ref_lo, zone, band, feather))
    wy, wx = TCL.content_aware_weight_profiles(lo, zone, band, feather)
    rwy, rwx = JCL.content_aware_weight_profiles(ref_lo, zone, band, feather)
    np.testing.assert_array_equal(wy, rwy)
    np.testing.assert_array_equal(wx, rwx)
