"""Port parity: separable filters, colour conversions and the general
resizes (srs_tpu_torch.ops.filters, .colorspace, .resize) against the JAX
reference on the same seeded inputs, and against cv2 where the
reference's own tests hold it to cv2.

Tolerance: atol 1e-4 on data in [0, 255] (float32 rounding; taps sum in
the reference's order). cv2 comparisons: atol 1e-3 (cv2 sums its taps in
its own vectorized order).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops import colorspace as RC
from srs_tpu.ops import filters as RF
from srs_tpu.ops import resize as RR
from srs_tpu_torch.ops import colorspace as TC
from srs_tpu_torch.ops import filters as TF
from srs_tpu_torch.ops import resize as TR

ATOL = 1e-4
CV2_ATOL = 1e-3


def _data(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("ksize,sigma", [(7, 7.0 / 6.0), (11, 1.5), (9, 1.0), (17, 2.0), (5, 0.0)])
def test_gaussian_kernel_matches_reference(ksize, sigma):
    np.testing.assert_array_equal(TF.gaussian_kernel1d(ksize, sigma),
                                  RF.gaussian_kernel1d(ksize, sigma))


@pytest.mark.parametrize("shape", [(37, 41), (2, 24, 30), (3, 5), (1, 1)])
@pytest.mark.parametrize("ksize,sigma", [(7, 7.0 / 6.0), (11, 1.5), (17, 2.0)])
def test_gaussian_blur_matches_reference(shape, ksize, sigma):
    """Includes axes shorter than the kernel's radius (REFLECT_101 folds
    more than once, as numpy's "reflect" pad does)."""
    x = _data(shape, seed=ksize)
    got = TF.gaussian_blur(_t(x), ksize, sigma).numpy()
    ref = np.asarray(RF.gaussian_blur(jnp.asarray(x), ksize, sigma))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("sigma,ksize", [(1.0, 9), (2.0, 17)])
def test_gaussian_blur_matches_cv2(sigma, ksize):
    """The kernel sizes cv2 derives from sigma for float input, which the
    router's blur probe uses."""
    x = _data((48, 64), seed=3)
    got = TF.gaussian_blur(_t(x), ksize, sigma).numpy()
    np.testing.assert_allclose(got, cv2.GaussianBlur(x, (0, 0), sigma), atol=CV2_ATOL, rtol=0)


def test_box_sobel_laplacian_match_reference():
    x = _data((2, 21, 26), seed=4)
    np.testing.assert_allclose(TF.box_blur(_t(x), 5).numpy(),
                               np.asarray(RF.box_blur(jnp.asarray(x), 5)), atol=ATOL, rtol=0)
    for got, ref in zip(TF.sobel(_t(x)), RF.sobel(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(TF.laplacian(_t(x)).numpy(),
                               np.asarray(RF.laplacian(jnp.asarray(x))), atol=ATOL, rtol=0)


def test_sobel_laplacian_match_cv2():
    x = _data((30, 33), seed=5)
    gx, gy = TF.sobel(_t(x))
    np.testing.assert_allclose(gx.numpy(), cv2.Sobel(x, cv2.CV_32F, 1, 0, ksize=3),
                               atol=CV2_ATOL, rtol=0)
    np.testing.assert_allclose(gy.numpy(), cv2.Sobel(x, cv2.CV_32F, 0, 1, ksize=3),
                               atol=CV2_ATOL, rtol=0)
    np.testing.assert_allclose(TF.laplacian(_t(x)).numpy(),
                               cv2.Laplacian(x, cv2.CV_32F, ksize=1), atol=CV2_ATOL, rtol=0)


def test_colorspace_matches_reference():
    x = _data((2, 9, 11, 3), seed=6)
    np.testing.assert_allclose(TC.rgb_to_gray(_t(x)).numpy(),
                               np.asarray(RC.rgb_to_gray(jnp.asarray(x))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(TC.rgb_to_lab(_t(x)).numpy(),
                               np.asarray(RC.rgb_to_lab(jnp.asarray(x))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((72, 128), (28, 51)), ((720, 1280), (288, 512)),
                                     ((40, 60), (4, 6)), ((13, 17), (30, 41)),
                                     ((96, 112), (38, 44))])
def test_resize_bicubic_matches_reference(src, dst):
    """Non-integer downscale (the QA comparison's 0.4), integer decimation,
    and upscale."""
    x = _data((*src, 3), seed=src[0])
    got = TR.resize_bicubic(_t(x), *dst).numpy()
    ref = np.asarray(RR.resize_bicubic(jnp.asarray(x), *dst))
    assert got.shape == ref.shape == (*dst, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((96, 112), (38, 44)), ((64, 80), (16, 20))])
def test_resize_bicubic_downscale_matches_cv2(src, dst):
    x = _data((*src, 3), seed=9)
    got = TR.resize_bicubic(_t(x), *dst).numpy()
    ref = cv2.resize(x, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(got, ref, atol=CV2_ATOL, rtol=0)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_resize_area_int_matches_cv2(s):
    x = _data((5, 24, 36, 3), seed=s)
    got = TR.resize_area_int(_t(x), s).numpy()
    for i in range(5):
        ref = cv2.resize(x[i], (36 // s, 24 // s), interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(got[i], ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        TR.resize_area_int(_t(x[:, :23]), s)
