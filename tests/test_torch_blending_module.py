"""Port parity: ``srs_tpu_torch.blending`` (BlendingModule, its enums and
records, ``create_tile_grid``, ``compute_blend_quality``) and the
multigrid Poisson clone (``ops/blend.seamless_clone_multigrid``) against
``srs_tpu.blending`` and ``srs_tpu.ops.blend`` on the CPU, on tiles of
48-64 px cut from seeded scenes.

Tolerances:
- canvases of every fusion, the pyramids, the clones and the repaired
  canvas: 1e-3 absolute on [0, 255], as tests/test_torch_blend.py. The
  multigrid clone is held at the same 1e-3: its coarse masks are exact on
  both sides (pyrDown of a {0, 1} mask gives multiples of 1/256, none of
  them within float32 rounding of the 0.999 cut), so the two solvers
  differ only by float32 rounding carried through 6 V-cycles;
- seams: the same list (positions, sizes, severities), scores within 1e-4;
- ``compute_blend_quality``: SSIM keys 1e-5 absolute, gradient keys
  relative 1e-4;
- colour correction: the wrapper equals the port's ``ops/color``
  function (tests/test_torch_seam_color.py holds that against the
  reference) bit for bit; against the reference 1e-2 absolute through the
  guided filter, whose variances E[I^2] - E[I]^2 cancel values up to
  255^2 (float32 spacing 0.004 there) before dividing by var + 0.01
  (6.7e-3 measured on this scene), and histogram matching's float32
  distance ties on up to 1% of samples (ROADMAP Queue 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srs_tpu.blending as RB
from srs_tpu.ops import blend as ROB
from srs_tpu.ops.seam import Seam as RSeam
from srs_tpu_torch import blending as TB
from srs_tpu_torch.ops import blend as TOB
from srs_tpu_torch.ops.color import color_correction as port_color_correction
from srs_tpu_torch.ops.seam import Seam as TSeam

ATOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite's parallel workers would otherwise
    each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size_h, size_w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size_h, 0:size_w].astype(np.float32)
    base = np.stack([127 + 100 * np.sin(xx / 17), 127 + 100 * np.cos(yy / 23),
                     127 + 100 * np.sin((xx + yy) / 29)], -1)
    return np.clip(base + rng.normal(0, 2, base.shape), 0, 255).astype(np.float32)


def _grid(block=64, overlap=16, ny=2, nx=3, seed=0, bright=None):
    """Tiles cut from one scene as (reference TileInfos, port TileInfos,
    the scene); ``bright`` lifts one tile by 30 (a seam)."""
    step = block - overlap
    base = _scene((ny - 1) * step + block, (nx - 1) * step + block, seed)
    ref, port = [], []
    for r in range(ny):
        for c in range(nx):
            y, x = r * step, c * step
            img = base[y : y + block, x : x + block].copy()
            if bright == r * nx + c:
                img = np.clip(img + 30, 0, 255)
            ref.append(RB.TileInfo(img, x, y, r, c))
            port.append(TB.TileInfo(img, x, y, r, c))
    return ref, port, base


@pytest.fixture(scope="module")
def modules():
    return RB.BlendingModule(), TB.BlendingModule(device="cpu")


FUSIONS = ("laplacian_fusion", "multi_band_fusion", "weighted_average_fusion",
           "feather_blend", "gradient_domain_fusion")


@pytest.mark.parametrize("method", FUSIONS)
@pytest.mark.parametrize("grid", [dict(), dict(block=48, overlap=16, ny=2, nx=2, bright=1)],
                         ids=["2x3_64", "2x2_48_seam"])
def test_fusion_matches_reference(modules, method, grid):
    ref_mod, port_mod = modules
    ref_t, port_t, base = _grid(**grid)
    shape = base.shape[:2]
    got = getattr(port_mod, method)(port_t, output_shape=shape)
    ref = np.asarray(getattr(ref_mod, method)(ref_t, output_shape=shape))
    assert got.shape == ref.shape == base.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # without output_shape: cropped to the inferred layout's image
    np.testing.assert_allclose(getattr(port_mod, method)(port_t),
                               np.asarray(getattr(ref_mod, method)(ref_t)), atol=ATOL)


def test_fusion_of_bare_arrays_matches_reference(modules):
    """Arrays without positions are laid out edge to edge, row by row."""
    ref_mod, port_mod = modules
    arrays = [_scene(48, 48, s) for s in range(4)]
    for method in ("laplacian_fusion", "weighted_average_fusion"):
        np.testing.assert_allclose(getattr(port_mod, method)(arrays),
                                   np.asarray(getattr(ref_mod, method)(arrays)), atol=ATOL)


def test_layout_from_tiles_keeps_the_tiles_positions():
    """A grid whose step is not what compute_layout would round to keeps
    the tiles' own positions, as the reference does; non-square tiles are
    refused."""
    _, port_t, _ = _grid(block=64, overlap=20, ny=2, nx=2)
    layout, batch, positions = TB._layout_from_tiles(port_t, torch.device("cpu"))
    ref_layout, _, ref_positions = RB._layout_from_tiles(_grid(64, 20, 2, 2)[0])
    assert layout == dataclasses.replace(layout) and tuple(batch.shape) == (4, 64, 64, 3)
    np.testing.assert_array_equal(positions, np.asarray(ref_positions))
    np.testing.assert_array_equal(layout.positions, ref_layout.positions)
    bad = [TB.TileInfo(np.zeros((8, 6, 3), np.float32), 0, 0, 0, 0)]
    with pytest.raises(ValueError, match="square"):
        TB._layout_from_tiles(bad, torch.device("cpu"))


def test_pyramids_match_reference(modules):
    ref_mod, port_mod = modules
    img = _scene(64, 80, 3)
    got = port_mod.build_laplacian_pyramid(img, 4)
    ref = ref_mod.build_laplacian_pyramid(img, 4)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    for g, r in zip(port_mod.build_gaussian_pyramid(img), ref_mod.build_gaussian_pyramid(img)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    np.testing.assert_allclose(port_mod.collapse_laplacian_pyramid(got).numpy(), img, atol=ATOL)


def _clone_case(size=96, seed=4):
    """A flat destination, a textured source at another level, and a mask
    that covers most of the image."""
    rng = np.random.default_rng(seed)
    dst = _scene(size, size, seed) * 0.3 + 20.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    src = (170 + 30 * np.sin(xx / 7))[..., None].repeat(3, -1).astype(np.float32)
    src += rng.normal(0, 3, src.shape).astype(np.float32)
    mask = np.zeros((size, size), np.float32)
    mask[10:size - 12, 8:size - 9] = 1
    return dst.astype(np.float32), src, mask


@pytest.mark.parametrize("mode", ["normal", "mixed", "monochrome"])
@pytest.mark.parametrize("solver", ["multigrid", "jacobi"])
def test_poisson_fusion_matches_reference(modules, mode, solver):
    ref_mod, port_mod = modules
    dst, src, mask = _clone_case()
    got = port_mod.poisson_fusion(dst, src, mask, TB.PoissonMode(mode), solver=solver)
    ref = np.asarray(ref_mod.poisson_fusion(dst, src, mask, RB.PoissonMode(mode), solver=solver))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got[:10], np.clip(dst[:10], 0, 255), atol=ATOL)


def test_multigrid_clone_converges_where_jacobi_stalls():
    """The reference's convergence test (tests/test_blend.py), on the
    port, with the reference's output beside it; an odd size takes pyrUp
    to an explicit odd (H, W) at every level."""
    dst = np.full((131, 127, 3), 40.0, np.float32)
    yy, xx = np.mgrid[0:131, 0:127].astype(np.float32)
    src = (180 + 30 * np.sin(xx / 7))[..., None].repeat(3, -1).astype(np.float32)
    mask = np.zeros((131, 127), np.float32)
    mask[8:123, 8:119] = 1
    t = [torch.from_numpy(a) for a in (dst, src, mask)]
    uj = TOB.seamless_clone(*t, iters=100).numpy()
    um = TOB.seamless_clone_multigrid(*t).numpy()
    ref = np.asarray(ROB.seamless_clone_multigrid(*(jnp.asarray(a) for a in (dst, src, mask))))
    np.testing.assert_allclose(um, ref, atol=ATOL)
    np.testing.assert_allclose(um[5, :, 0], 40.0, atol=1e-3)
    assert (src[64, 64, 0] - um[64, 64, 0]) > (src[64, 64, 0] - uj[64, 64, 0]) + 30
    assert abs(um[40:80, 40:80, 0].std() - src[40:80, 40:80, 0].std()) < 3


def _seams(seams):
    return [(s.x, s.y, s.width, s.height, s.severity) for s in seams]


def test_detect_and_repair_seams_match_reference(modules):
    ref_mod, port_mod = modules
    ref_t, port_t, base = _grid()
    fused = np.asarray(ref_mod.laplacian_fusion(ref_t, output_shape=base.shape[:2]))
    corrupted = fused.copy()
    corrupted[40:56, 40:56] = 255 - corrupted[40:56, 40:56]
    got = port_mod.detect_seams(corrupted, port_t)
    ref = ref_mod.detect_seams(corrupted, ref_t)
    assert len(got) > 0 and _seams(got) == _seams(ref)
    for g, r in zip(got, ref):
        assert abs(g.ssim_score - r.ssim_score) <= 1e-4
    seams_t = [TSeam(10, 10, 16, 16, 0.5), TSeam(40, 40, 16, 16, 0.9), TSeam(70, 20, 8, 8, 0.99)]
    seams_r = [RSeam(10, 10, 16, 16, 0.5), RSeam(40, 40, 16, 16, 0.9), RSeam(70, 20, 8, 8, 0.99)]
    for tiles_t, tiles_r in ((port_t, ref_t), (None, None)):
        np.testing.assert_allclose(port_mod.repair_seams(corrupted, seams_t, tiles_t),
                                   np.asarray(ref_mod.repair_seams(corrupted, seams_r, tiles_r)),
                                   atol=ATOL)
    vis = port_mod.visualize_seams(corrupted, seams_t)
    np.testing.assert_array_equal(vis, ref_mod.visualize_seams(corrupted, seams_r))


@pytest.mark.parametrize("method", ["histogram", "mean_std", "none"])
def test_color_correction_matches_reference(modules, method):
    ref_mod, port_mod = modules
    img = _scene(48, 64, 5) * 0.7 + 30
    ref_tile = _scene(32, 32, 6)
    got = port_mod.color_correction(img, ref_tile, method, local_filter=method != "none")
    op = port_color_correction(torch.from_numpy(img), torch.from_numpy(ref_tile), method,
                               method != "none").numpy()
    np.testing.assert_array_equal(got, op)
    ref = np.asarray(ref_mod.color_correction(img, ref_tile, method, method != "none"))
    close = np.isclose(got, ref, atol=1e-2, rtol=0)
    assert close.mean() >= (0.99 if method == "histogram" else 1.0)


def test_create_tile_grid_and_blend_quality_match_reference():
    ref_t, port_t, base = _grid()
    imgs = [t.image for t in ref_t]
    got_infos, got_regions = TB.create_tile_grid(imgs, (2, 3), overlap=16)
    ref_infos, ref_regions = RB.create_tile_grid(imgs, (2, 3), overlap=16)
    assert [(i.x, i.y, i.row, i.col) for i in got_infos] == [
        (i.x, i.y, i.row, i.col) for i in ref_infos]
    assert [dataclasses.astuple(r) for r in got_regions] == [
        dataclasses.astuple(r) for r in ref_regions]
    assert len(got_regions) == 7
    fused = np.asarray(RB.BlendingModule().laplacian_fusion(ref_t, output_shape=base.shape[:2]))
    positions = [(i.y, i.x) for i in ref_infos]
    got = TB.compute_blend_quality(fused, imgs, positions, device="cpu")
    ref = RB.compute_blend_quality(fused, imgs, positions)
    assert list(got) == list(ref)
    for k, v in ref.items():
        if "ssim" in k:
            assert abs(got[k] - v) <= 1e-5, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-4), k


def test_module_reads_its_config():
    """An argument left at its default reads the config, as in the
    reference."""
    from srs_tpu_torch.config import BlendingConfig

    m = TB.BlendingModule(BlendingConfig(pyramid_levels=4, seam_threshold=0.9), device="cpu")
    assert (m.num_levels, m.ssim_threshold) == (4, 0.9)
    m = TB.BlendingModule(BlendingConfig(pyramid_levels=4), num_levels=3, ssim_threshold=0.8,
                          device="cpu")
    assert (m.num_levels, m.ssim_threshold) == (3, 0.8)
    assert [e.value for e in TB.FusionMethod] == [e.value for e in RB.FusionMethod]
    assert [e.value for e in TB.WeightType] == [e.value for e in RB.WeightType]
