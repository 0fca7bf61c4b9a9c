"""Port parity: pyramid ops (srs_tpu_torch.ops.pyramid / ops.cuda.pyramid)
against the JAX reference's XLA path and its Pallas kernels (interpret
mode), on the CPU where the port runs the kernels' plain versions.

Tolerance: atol 1e-4 on data in [0, 255] (float32 rounding; the XLA path
and the plain version apply the same taps in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops.pallas.pyramid_pallas import pyr_down_pallas, pyr_up_pallas
from srs_tpu.ops.pyramid import (
    _pyr_down_xla,
    _pyr_up_xla,
    build_gaussian_pyramid as jax_gauss,
    build_laplacian_pyramid as jax_lap,
    collapse_laplacian_pyramid as jax_collapse,
)
from srs_tpu_torch.ops import pyramid as P
from srs_tpu_torch.ops.cuda import pyramid as K

ATOL = 1e-4

DOWN_SHAPES = [(2, 63, 129, 3), (1, 64, 128, 3), (1, 5, 7, 3), (1, 2, 3, 1), (3, 1, 1, 2),
               (1, 7, 4, 3),
               # chip_smoke.py's K1 edge cases (PYR_DOWN_EDGE_CASES): the card holds
               # K1 to the plain version there, and these hold the plain version
               # to the XLA path at the same shapes.
               (1, 64, 256, 3), (1, 63, 255, 3), (1, 65, 257, 3), (6, 128, 512, 3),
               (2, 129, 513, 1), (1, 40, 260, 3), (1, 40, 255, 1), (2, 37, 130, 5),
               (1, 1, 300, 3), (1, 2, 301, 3), (1, 300, 1, 3), (1, 301, 2, 3),
               (1, 3, 5, 3), (1, 4, 4, 3), (1, 5, 3, 1), (64, 257, 3), (300, 64, 3),
               (1, 288, 288, 3), (6, 288, 288, 3), (6, 576, 576, 3)]
UP_CASES = [((2, 33, 65, 3), (65, 129)), ((2, 33, 65, 3), (66, 130)),
            ((1, 32, 16, 3), (64, 32)), ((1, 1, 1, 3), (1, 1)), ((1, 1, 1, 3), (2, 2)),
            ((1, 3, 5, 1), (5, 9)), ((1, 4, 6, 2), (6, 10)), ((1, 17, 16, 3), (34, 31))]


def _data(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("shape", DOWN_SHAPES)
def test_pyr_down_plain_matches_xla(shape):
    x = _data(shape)
    got = P.pyr_down(torch.from_numpy(x)).numpy()
    ref = np.asarray(_pyr_down_xla(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 63, 129), (1, 8, 8), (3, 16, 33)])
def test_pyr_down_plain_matches_pallas_interpret(shape):
    x = _data(shape, seed=1)
    got = P.pyr_down(torch.from_numpy(x)[..., None]).numpy()[..., 0]
    ref = np.asarray(pyr_down_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,dst", UP_CASES)
def test_pyr_up_plain_matches_xla(shape, dst):
    x = _data(shape, seed=2)
    got = P.pyr_up(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(_pyr_up_xla(jnp.asarray(x), dst))
    assert got.shape == ref.shape == (shape[0], *dst, shape[-1])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,dst", [((2, 33, 65), (65, 129)), ((2, 33, 65), (66, 130)),
                                       ((1, 8, 9), (16, 17))])
def test_pyr_up_plain_matches_pallas_interpret(shape, dst):
    x = _data(shape, seed=3)
    got = P.pyr_up(torch.from_numpy(x)[..., None], dst).numpy()[..., 0]
    ref = np.asarray(pyr_up_pallas(jnp.asarray(x), *dst, interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_pyr_up_default_size_and_bad_size():
    x = torch.from_numpy(_data((1, 5, 6, 3)))
    assert P.pyr_up(x).shape == (1, 10, 12, 3)
    with pytest.raises(ValueError):
        P.pyr_up(x, (7, 12))  # below 2m-2


def test_pyramid_builders_match_reference():
    x = _data((2, 40, 56, 3), seed=4)
    g = P.build_gaussian_pyramid(torch.from_numpy(x), 6)
    gr = jax_gauss(jnp.asarray(x), 6)
    assert len(g) == len(gr)
    for a, b in zip(g, gr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    lap = P.build_laplacian_pyramid(torch.from_numpy(x), 4)
    lapr = jax_lap(jnp.asarray(x), 4)
    for a, b in zip(lap, lapr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        P.collapse_laplacian_pyramid(lap).numpy(), np.asarray(jax_collapse(lapr)),
        atol=ATOL, rtol=0,
    )
    # exact reconstruction up to rounding
    np.testing.assert_allclose(P.collapse_laplacian_pyramid(lap).numpy(), x, atol=ATOL)


def test_cpu_tensors_never_count_launches():
    K.reset_launches()
    x = torch.from_numpy(_data((1, 16, 16, 3)))
    P.pyr_up(P.pyr_down(x), (16, 16))
    assert K.LAUNCHES == {"pyr_down": 0, "pyr_up": 0}


def test_other_devices_raise():
    x = torch.empty((1, 8, 8, 3), device="meta")
    with pytest.raises(ValueError):
        P.pyr_down(x)
    with pytest.raises(ValueError):
        P.pyr_up(x)
