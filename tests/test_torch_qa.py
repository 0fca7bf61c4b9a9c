"""Port parity: QA metrics (srs_tpu_torch.qa) against the JAX reference on
the same seeded inputs.

Tolerances (each stated where it is used):
- PSNR: 1e-3 dB; SSIM and MS-SSIM: 1e-5 absolute (float32 blurs of
  values up to 255^2);
- downsample comparison: PSNR keys 1e-3 dB, SSIM keys 1e-5;
- MSCN coefficients: 1e-3 absolute. ``blur(g^2) - blur(g)^2`` cancels
  values up to 255^2, where float32 rounding is 0.004, and XLA fuses the
  reference's jitted taps into multiply-adds that round once (the port's
  unfused blur matches the reference's eager blur bit for bit);
- closed-form no-reference values: relative 1e-4 (float32 reductions in
  another order), absolute 1e-3 where the value is near 0;
- the 36 NSS features: 1.5e-3 absolute. Their shape parameters are the
  moment-ratio table entry nearest a float32 sample ratio; the table
  steps alpha by 0.001, so a near tie takes the neighbouring entry;
- NIQE and BRISQUE from the packaged models: relative 2e-2. One such
  step in a shape feature moves BRISQUE's quadratic regressor by up to
  1.3% (measured on 108-px output crops), NIQE's distance by less.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import filters as RF
from srs_tpu.qa import metrics as RM
from srs_tpu.qa import niqe as RN
from srs_tpu.qa import noref as RNR
from srs_tpu.qa.module import QualityAssessmentModule as RQ
from srs_tpu_torch.ops import filters as TF
from srs_tpu_torch.qa import metrics as TM
from srs_tpu_torch.qa import niqe as TN
from srs_tpu_torch.qa import noref as TNR
from srs_tpu_torch.qa.module import QualityAssessmentModule as TQ

PSNR_ATOL = 1e-3
SSIM_ATOL = 1e-5
MSCN_ATOL = 1e-3
NOREF_RTOL, NOREF_ATOL = 1e-4, 1e-3
MODEL_RTOL = 2e-2
FEATURE_ATOL = 1.5e-3


def _scene(seed, h=120, w=136):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 80 * np.sin(xx / (7 + seed)), 127 + 80 * np.cos(yy / 9),
                    127 + 60 * np.sin((xx - yy) / 5)], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    clean = _scene(1)
    noisy = np.clip(clean + np.random.default_rng(2).normal(0, 8, clean.shape),
                    0, 255).astype(np.float32)
    return clean, noisy


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_psnr_ssim_ms_ssim_match_reference(pair):
    a, b = pair
    assert abs(float(TM.psnr(_t(a), _t(b))) - float(RM.psnr(a, b))) <= PSNR_ATOL
    assert float(TM.psnr(_t(a), _t(a))) == float(RM.psnr(a, a)) == 100.0
    assert abs(float(TM.ssim(_t(a), _t(b))) - float(RM.ssim(a, b))) <= SSIM_ATOL
    assert abs(float(TM.ms_ssim(_t(a), _t(b))) - float(RM.ms_ssim(a, b))) <= SSIM_ATOL


def test_downsample_comparison_matches_reference(pair):
    a, b = pair
    up = cv2.resize(b, (b.shape[1] * 3, b.shape[0] * 3), interpolation=cv2.INTER_CUBIC)
    got = TM.downsample_comparison(_t(a), _t(up))
    ref = RM.downsample_comparison(jnp.asarray(a), jnp.asarray(up))
    assert set(got) == set(ref)
    for k in ref:
        tol = PSNR_ATOL if k.startswith("psnr") else SSIM_ATOL
        assert abs(float(got[k]) - float(ref[k])) <= tol, k


def test_ssim_matches_the_reference_cv2_oracle(pair):
    """The reference's own oracle: cv2 Gaussian 11x11 sigma 1.5 stats."""
    a, b = pair
    g1 = cv2.cvtColor(a.astype(np.uint8), cv2.COLOR_RGB2GRAY).astype(np.float64)
    g2 = cv2.cvtColor(b.astype(np.uint8), cv2.COLOR_RGB2GRAY).astype(np.float64)
    blur = lambda x: cv2.GaussianBlur(x, (11, 11), 1.5)  # noqa: E731
    mu1, mu2 = blur(g1), blur(g2)
    s1, s2 = blur(g1 * g1) - mu1 * mu1, blur(g2 * g2) - mu2 * mu2
    s12 = blur(g1 * g2) - mu1 * mu2
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1**2 + mu2**2 + c1) * (s1 + s2 + c2))
    got = float(TM.ssim(_t(g1.astype(np.float32)), _t(g2.astype(np.float32))))
    assert abs(got - m[5:-5, 5:-5].mean()) < 1e-4


def test_no_reference_metrics_batched_match_reference(pair):
    """One value per image of a batch, as the reference's vmap gives."""
    batch = np.stack([pair[0], pair[1], _scene(3)])
    got = TNR.no_reference_metrics(_t(batch))
    ref = jax.vmap(RNR.no_reference_metrics)(jnp.asarray(batch))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=NOREF_RTOL, atol=NOREF_ATOL, err_msg=k)
    single = TNR.no_reference_metrics(_t(batch[1]))
    for k in ref:
        assert single[k].shape == ()
        np.testing.assert_allclose(float(single[k]), float(np.asarray(ref[k])[1]),
                                   rtol=NOREF_RTOL, atol=NOREF_ATOL)


def test_mscn_matches_reference(pair):
    g = cv2.cvtColor(pair[0].astype(np.uint8), cv2.COLOR_RGB2GRAY).astype(np.float32)
    np.testing.assert_allclose(TNR.mscn(_t(g)).numpy(), np.asarray(RNR.mscn(jnp.asarray(g))),
                               atol=MSCN_ATOL, rtol=0)


def test_blur_matches_reference_eager_bit_for_bit(pair):
    g2 = pair[0][..., 1] * pair[0][..., 1]
    np.testing.assert_array_equal(
        TF.gaussian_blur(_t(g2), 7, 7.0 / 6.0).numpy(),
        np.asarray(RF.gaussian_blur(jnp.asarray(g2), 7, 7.0 / 6.0)))


def test_ggd_table_matches_reference():
    a, rho = TN._ggd_table()
    ra, rrho = RN._ggd_table()
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_allclose(rho, rrho, rtol=1e-6, atol=0)


def test_features36_match_reference(pair):
    g = np.stack([cv2.cvtColor(p.astype(np.uint8), cv2.COLOR_RGB2GRAY).astype(np.float32)
                  for p in pair])
    got = TN.image_features36(_t(g)).numpy()
    ref = np.asarray(jax.vmap(RN._image_features36)(jnp.asarray(g)))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=FEATURE_ATOL)


@pytest.mark.parametrize("size", [(120, 136), (200, 290), (64, 80)])
def test_niqe_brisque_scores_match_reference(pair, size):
    """Patch grids of 1x1 and 2x3 patches of 96, and an image smaller than
    one patch (whole-image features)."""
    rng = np.random.default_rng(size[0])
    batch = np.stack([cv2.resize(p, size[::-1], interpolation=cv2.INTER_CUBIC) for p in pair])
    batch = np.clip(batch + rng.normal(0, 1, batch.shape), 0, 255).astype(np.float32)
    for got, ref in ((TN.niqe_scores(_t(batch)), RN.niqe_scores(jnp.asarray(batch))),
                     (TN.brisque_scores(_t(batch)), RN.brisque_scores(jnp.asarray(batch)))):
        np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=0)
    assert TN.niqe_score(_t(batch[0])) == pytest.approx(
        RN.niqe_score(jnp.asarray(batch[0])), rel=MODEL_RTOL)
    assert TN.brisque_score(_t(batch[1])) == pytest.approx(
        RN.brisque_score(jnp.asarray(batch[1])), rel=MODEL_RTOL)


def _close(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v, k
        elif k.startswith("psnr"):
            assert abs(got[k] - v) <= PSNR_ATOL, k
        elif k.startswith(("ssim", "ms_ssim")):
            assert abs(got[k] - v) <= SSIM_ATOL, k
        elif k in ("niqe", "brisque"):
            assert got[k] == pytest.approx(v, rel=MODEL_RTOL), k
        else:
            assert got[k] == pytest.approx(v, rel=NOREF_RTOL, abs=NOREF_ATOL), k


def test_module_reports_match_reference(pair):
    """Full- and no-reference reports without LPIPS (tests/test_torch_lpips.py
    holds LPIPS): same keys, levels and values; thresholds calibrated."""
    a, b = pair
    ref_mod = RQ(lpips_model=None)
    ref_mod._lpips = None
    got_mod = TQ(device="cpu")
    assert dataclasses.asdict(got_mod.thresholds) == dataclasses.asdict(ref_mod.thresholds)
    _close(got_mod.evaluate_full_reference(a, _t(b)), ref_mod.evaluate_full_reference(a, b))
    _close(got_mod.evaluate_no_reference(b), ref_mod.evaluate_no_reference(b))


def test_module_preprocess_scales_unit_range_and_passes_tensors():
    mod = TQ(device="cpu")
    x = np.full((4, 5), 0.5, np.float32)
    assert mod._preprocess(x).shape == (4, 5, 1)
    assert float(mod._preprocess(x).max()) == 127.5
    t = torch.full((4, 5, 3), 200.0)
    assert torch.equal(mod._preprocess(t), t)
