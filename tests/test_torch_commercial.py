"""Port parity: commercial QA and the rest of the QA module's API
(srs_tpu_torch.qa.commercial, qa.module, ops.colorspace, ops.filters'
Canny, qa.metrics' simple and global SSIM) against the JAX package on the
same seeded inputs, on the CPU.

Tolerances (each stated where it is used):
- commercial metrics: relative 1e-4, absolute 1e-6 (float32 reductions
  and FFT sums in another order);
- the Canny mask: equal on every pixel. Its decisions are binary (the
  NMS comparisons, the thresholds, the sign test) and flip on a one-ulp
  difference in the Sobel sums; on these inputs none does, and
  ``oversharpen_score`` then agrees within the metric tolerance;
- YCrCb: 1e-4 absolute on [0, 255]; the profile conversion: 1e-4
  (float64 on both sides, float32 out);
- simple and global SSIM: 1e-5 absolute;
- the QA module's scalars as tests/test_torch_qa.py holds them (PSNR 1e-3
  dB, SSIM 1e-5, NIQE/BRISQUE relative 2e-2);
- reports: the same text, line for line, apart from the "Generated:"
  timestamp; the JSON report's metrics equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import colorspace as RC
from srs_tpu.ops import filters as RF
from srs_tpu.qa import commercial as RCOM
from srs_tpu.qa import metrics as RM
from srs_tpu.qa.module import QualityAssessmentModule as RQ
from srs_tpu_torch.ops import colorspace as TC
from srs_tpu_torch.ops import filters as TF
from srs_tpu_torch.qa import commercial as TCOM
from srs_tpu_torch.qa import metrics as TM
from srs_tpu_torch.qa.module import QualityAssessmentModule as TQ

RTOL, ATOL = 1e-4, 1e-6
PSNR_ATOL, SSIM_ATOL, MODEL_RTOL = 1e-3, 1e-5, 2e-2

ROIS = [
    {"type": "text", "bbox": [4, 6, 30, 20]},
    {"type": "product", "bbox": [40, 10, 36, 40]},
    {"type": "face", "bbox": [10, 30, 40, 30]},
    {"type": "brand", "bbox": [50, 40, 100, 100], "reference_color": [200, 30, 30]},
    {"type": "brand", "bbox": [0, 0, 20, 20]},  # no reference colour: no key
    {"type": "text", "bbox": [200, 200, 10, 10]},  # outside: skipped, index kept
    {"bbox": [0, 0, 16, 16]},  # type defaults to roi_6: no branch
    {"type": "face", "bbox": [-5, -5, 20, 12]},  # clipped to the image
]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite's parallel workers would otherwise
    each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, h=64, w=80):
    """Smooth colour waves, a hard-edged block and a skin-toned patch, with
    noise: Canny finds edges, the skin mask is neither empty nor full."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 80 * np.sin(xx / (6 + seed)), 127 + 70 * np.cos(yy / 7),
                    127 + 60 * np.sin((xx - yy) / 5)], -1)
    img[h // 4 : h // 2, w // 3 : w // 2] = (230.0, 40.0, 40.0)
    img[h // 2 :, : w // 3] = (200.0, 150.0, 120.0)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    return [_scene(s) for s in (1, 2)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _close(got, ref, key=""):
    assert float(got) == pytest.approx(float(ref), rel=RTOL, abs=ATOL), key


def test_ycrcb_and_profiles_match_reference(images):
    img = images[0]
    np.testing.assert_allclose(TC.rgb_to_ycrcb(_t(img)).numpy(),
                               np.asarray(RC.rgb_to_ycrcb(jnp.asarray(img))), atol=1e-4)
    for target in ("sRGB", "AdobeRGB", "prophoto"):
        np.testing.assert_allclose(TC.convert_profile(img, target),
                                   RC.convert_profile(img, target), atol=1e-4)
    with pytest.raises(ValueError, match="unknown color space"):
        TC.convert_profile(img, "cmyk")


@pytest.mark.parametrize("low_high", [(50.0, 150.0), (20.0, 60.0)])
def test_canny_mask_matches_reference(images, low_high):
    """Exact on every pixel (see the module docstring); the edges wrap
    around the borders as the reference's jnp.roll does."""
    g = TC.rgb_to_gray(_t(images[1]))
    got = TF.canny_edges(g, *low_high).numpy()
    ref = np.asarray(RF.canny_edges(jnp.asarray(g.numpy()), *low_high))
    assert 0 < got.mean() < 0.5
    assert int((got != ref).sum()) == 0


def test_simple_and_global_ssim_match_reference(images):
    a, b = images
    for fn in ("ssim_simple", "ssim_global"):
        got = float(getattr(TM, fn)(_t(a), _t(b)))
        ref = float(getattr(RM, fn)(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - ref) <= SSIM_ATOL, fn


METRICS = ("hf_ratio", "texture_score", "face_naturalness", "color_variance",
           "skin_tone_naturalness", "oversharpen_score", "artifact_score", "noise_level",
           "brightness_uniformity")


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("shape", [(64, 80), (37, 53)])
def test_commercial_metric_matches_reference(name, shape):
    """Each metric on a whole image and on an odd-sized one (partial 8x8
    blocks and 4x4 regions)."""
    img = _scene(3, *shape)
    _close(getattr(TCOM, name)(_t(img)), getattr(RCOM, name)(jnp.asarray(img)), name)


def test_delta_e_matches_reference(images):
    ref_rgb = np.array([200, 30, 30], np.float32)
    _close(TCOM.delta_e(_t(images[0]), _t(ref_rgb)),
           RCOM.delta_e(jnp.asarray(images[0]), jnp.asarray(ref_rgb)))


def test_evaluate_commercial_arrays_with_rois_matches_reference(images):
    """The ROI rules: boxes clipped, a box off the image skipped (its
    index leaves a gap), a brand without a colour and an untyped ROI add
    nothing."""
    got = TCOM.evaluate_commercial_arrays(_t(images[0]), ROIS)
    ref = RCOM.evaluate_commercial_arrays(jnp.asarray(images[0]), ROIS)
    assert list(got) == list(ref)
    for k in ref:
        _close(got[k], ref[k], k)
    assert "text_sharpness_5" not in got and "brand_color_delta_e_4" not in got
    assert {"face_naturalness_7", "brand_color_delta_e_3"} <= set(got)


def _ref_module():
    mod = RQ(lpips_model=None)
    mod._lpips = None
    return mod


def test_module_evaluate_commercial_matches_reference(images):
    """With the brand's delta-E level, for a colour near and one far."""
    rois = ROIS + [{"type": "brand", "bbox": [40, 20, 10, 10],
                    "reference_color": [230, 40, 40]}]
    got = TQ(device="cpu").evaluate_commercial(images[0], rois)
    ref = _ref_module().evaluate_commercial(images[0], rois)
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            _close(got[k], v, k)
    assert {got["brand_color_accuracy_3"], got["brand_color_accuracy_8"]} == {
        ref["brand_color_accuracy_3"], ref["brand_color_accuracy_8"]}


def test_module_scalars_match_reference(images):
    a, b = images
    got, ref = TQ(device="cpu"), _ref_module()
    assert abs(got.calculate_psnr(a, b) - ref.calculate_psnr(a, b)) <= PSNR_ATOL
    assert abs(got.calculate_psnr(a, b, 100.0) - ref.calculate_psnr(a, b, 100.0)) <= PSNR_ATOL
    for fn in ("calculate_ssim", "calculate_ms_ssim"):
        assert abs(getattr(got, fn)(a, b) - getattr(ref, fn)(a, b)) <= SSIM_ATOL, fn
    for fn in ("calculate_niqe", "calculate_brisque"):
        assert getattr(got, fn)(b) == pytest.approx(getattr(ref, fn)(b), rel=MODEL_RTOL), fn
    np.testing.assert_allclose(got.downsample_bicubic(a, 0.4), ref.downsample_bicubic(a, 0.4),
                               atol=1e-3)
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError, match="scale_factor"):
            got.downsample_bicubic(a, bad)
    with pytest.raises(RuntimeError, match="LPIPS"):
        got.calculate_lpips(a, b)


def test_batch_evaluate_takes_the_scale_factor(images):
    a, b = images
    mod = TQ(device="cpu")
    one = mod.evaluate_full_reference(a, b, scale_factor=2)
    batch = mod.batch_evaluate([(a, b), (b, a)], scale_factor=2)
    # (the 0.1 downsample of 64x80 is smaller than the SSIM window: NaN on
    # both sides, so the dicts are compared as JSON)
    assert len(batch) == 2
    assert json.dumps(batch[0], sort_keys=True) == json.dumps(one, sort_keys=True)
    ref = _ref_module().batch_evaluate([(a, b)], scale_factor=2)[0]
    assert set(batch[0]) == set(ref)


def _drop_timestamp(text):
    return [line for line in text.splitlines() if not line.startswith("Generated: ")]


@pytest.mark.parametrize("kind", ["full", "summary", "json"])
def test_reports_match_reference(images, tmp_path, kind):
    """The reports of one metrics dict (full-, no-reference and
    commercial keys), written and returned."""
    a, b = images
    ref_mod = _ref_module()
    metrics = {**ref_mod.evaluate_full_reference(a, b), **ref_mod.evaluate_no_reference(b),
               **ref_mod.evaluate_commercial(b, ROIS[:4])}
    path = tmp_path / f"report.{kind}"
    got = TQ(device="cpu").generate_report(metrics, kind, str(path))
    ref = ref_mod.generate_report(metrics, kind)
    assert path.read_text(encoding="utf-8") == got
    if kind == "json":
        assert json.loads(got)["metrics"] == json.loads(ref)["metrics"]
    else:
        assert _drop_timestamp(got) == _drop_timestamp(ref)
        assert len(_drop_timestamp(got)) == len(got.splitlines()) - (kind == "full")
