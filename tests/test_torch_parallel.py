"""Port parity: ``srs_tpu_torch/parallel/`` against ``srs_tpu/parallel/``,
on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's meshes are the CPU repeated (``[cpu] * n``), the port's
counterpart. Inputs are drawn from a seed with numpy and cut into the
same tiles on both sides.

Tolerances: the halo merge within 1e-5 (data in [0, 1]); the sharded
Laplacian blend within 2e-4 on the 0-255 scale, the tolerance of the
reference's own sharded-against-single test; the sharded finalize within
1 LSB at every sample in uint8 and 1e-3 in float32 against the
reference's, and against the port's single-device finalize more than 1
LSB on under 1e-3 of samples (the reference's own rule); K2 on the
halo-extended band within 1e-5 of the reference's plain row upsample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.ops.tiles import extract_tiles as jax_extract
from srs_tpu.ops.tiles import pad_image as jax_pad
from srs_tpu.ops.weights import layout_weight_profiles as jax_profiles
from srs_tpu.ops.weights import layout_weights as jax_weights
from srs_tpu.parallel import finalize as jax_finalize
from srs_tpu.parallel import halo as jax_halo
from srs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srs_tpu.tiling.geometry import compute_layout as jax_layout
from srs_tpu_torch.ops.blend import blend_finalize_banded, laplacian_fusion_tiles
from srs_tpu_torch.ops.tiles import extract_tiles, merge_tiles, pad_image
from srs_tpu_torch.ops.weights import layout_weight_profiles, layout_weights
from srs_tpu_torch.parallel import (
    MeshTileDispatcher,
    data_sharding,
    make_mesh,
    replicated,
    sharded_laplacian_blend,
    sharded_weighted_merge,
    spatial_sharding,
)
from srs_tpu_torch.parallel.finalize import (
    ShardedCanvas,
    gather_canvas,
    sharded_finalize_banded,
)
from srs_tpu_torch.parallel.halo import _pyr_up_rows_halo
from srs_tpu_torch.tiling.geometry import compute_layout

CPU = torch.device("cpu")


def cpu_mesh(shape):
    return make_mesh(shape, [CPU] * int(np.prod(list(shape.values()))))


def both_tiles(args, kwargs, seed, scale=1.0):
    """(port layout, port tiles, JAX layout, JAX tiles) of one seeded image."""
    lo, jlo = compute_layout(*args, **kwargs), jax_layout(*args, **kwargs)
    img = np.random.default_rng(seed).random((lo.image_h, lo.image_w, 3),
                                             dtype=np.float32) * scale
    tiles = extract_tiles(pad_image(torch.from_numpy(img), lo), lo)
    jtiles = jax_extract(jax_pad(jnp.asarray(img), jlo), jlo)
    return lo, tiles, jlo, jtiles


# -- mesh ---------------------------------------------------------------------


def test_make_mesh_shapes():
    devs = [CPU] * 8
    assert make_mesh(None, devs).shape == {"data": 8}
    assert make_mesh({"data": 4, "space": 2}, devs).shape == {"data": 4, "space": 2}
    assert make_mesh({"data": -1, "space": 2}, devs).shape == {"data": 4, "space": 2}
    with pytest.raises(ValueError):
        make_mesh({"data": 16}, devs)
    with pytest.raises(ValueError):
        make_mesh({"data": -1, "space": -1}, devs)
    with pytest.raises(ValueError):
        make_mesh({"data": -1, "space": 3}, devs)  # 8 devices do not divide by 3


def test_make_mesh_needs_the_devices_it_names():
    # one card: a two-device mesh is refused, never made virtual
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2}, [torch.device("cuda", 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"data": 1})


def test_mesh_axis_devices():
    devs = [torch.device("cpu", i) for i in range(8)]
    m = make_mesh({"data": 4, "space": 2}, devs)
    assert m.axis_devices("data") == [devs[0], devs[2], devs[4], devs[6]]
    assert m.axis_devices("space") == devs[:2]
    assert m.axis_devices("model") == [devs[0]]
    assert m.distinct_devices() == 8 and cpu_mesh({"data": 8}).distinct_devices() == 1


@pytest.mark.parametrize("sharding", ["data", "spatial", "replicated"])
def test_placements_split_and_gather(sharding):
    m = make_mesh({"data": 4, "space": 2}, [torch.device("cpu", i) for i in range(8)])
    x = torch.arange(8 * 6 * 5 * 3, dtype=torch.float32).reshape(8, 6, 5, 3)
    sh = {"data": data_sharding, "spatial": spatial_sharding, "replicated": replicated}[
        sharding](m)
    shards = sh.split(x)
    assert len(shards) == 8
    want = {"data": (2, 6, 5, 3), "spatial": (2, 3, 5, 3), "replicated": (8, 6, 5, 3)}
    assert all(tuple(s.shape) == want[sharding] for s in shards)
    torch.testing.assert_close(sh.gather(shards), x, rtol=0, atol=0)


# -- halo merge ---------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 4, 8])
def test_halo_merge_matches_reference(s):
    lo, tiles, jlo, jtiles = both_tiles((300, 8 * 48 + 16, 64, 0.25), {}, seed=30 + s)
    assert lo.ny == 8
    stats = {}
    got = sharded_weighted_merge(tiles, layout_weights(lo, kind="ramp"), lo,
                                 cpu_mesh({"space": s}), stats=stats).numpy()
    ref = np.asarray(jax_halo.sharded_weighted_merge(
        jtiles, jnp.asarray(jax_weights(jlo, kind="ramp")), jlo, jax_make_mesh({"space": s})))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # every shard but the first received its neighbour's spill rows
    overlap = lo.block - lo.step
    assert stats["halo_bytes"] == (s - 1) * overlap * lo.padded_w * 4 * 4


def test_halo_merge_requires_divisible_rows():
    lo = compute_layout(100, 100, 64, 0.25)  # ny = 2
    tiles = torch.zeros((lo.num_tiles, lo.block, lo.block, 3))
    w = torch.ones((lo.num_tiles, lo.block, lo.block))
    with pytest.raises(ValueError):
        sharded_weighted_merge(tiles, w, lo, cpu_mesh({"space": 8}))


# -- dispatcher ---------------------------------------------------------------


def test_dispatcher_run_tiled():
    disp = MeshTileDispatcher(cpu_mesh({"data": 8}))
    tiles = torch.from_numpy(np.random.default_rng(3).random((12, 32, 32, 3),
                                                             dtype=np.float32))
    seen = []

    def fn(x):
        seen.append(int(x.shape[0]))
        return x * 2.0

    out = disp.run_tiled(fn, tiles, key="double")
    assert out.shape == tiles.shape
    torch.testing.assert_close(out, tiles * 2.0, rtol=0, atol=1e-6)
    # 12 tiles in shards of ceil(12/8) = 2; the two empty shards do not run
    assert seen == [2] * 6
    assert disp.pad_batch(tiles).shape[0] == 16 and disp.num_devices == 8


def test_dispatcher_merge_fallback():
    disp = MeshTileDispatcher(cpu_mesh({"data": 8}))
    lo = compute_layout(200, 150, 64, 0.25)
    img = np.random.default_rng(4).random((150, 200, 3), dtype=np.float32)
    tiles = extract_tiles(pad_image(torch.from_numpy(img), lo), lo)
    w = layout_weights(lo, kind="ramp")
    assert not disp._space_ok(lo)
    torch.testing.assert_close(disp.merge(tiles, w, lo), merge_tiles(tiles, w, lo),
                               rtol=0, atol=1e-6)


# -- sharded Laplacian blend --------------------------------------------------

# (space shards, levels): ny = shards, own 48 rows a shard
BLEND_CASES = {2: 2, 4: 3}


@pytest.fixture(scope="module")
def blends():
    """Per case: the port's tiles and layout, and the JAX package's
    collapsed and deferred sharded blends of the same tiles."""
    out = {}
    for s, lv in BLEND_CASES.items():
        lo, tiles, jlo, jtiles = both_tiles(
            (96, s * 48 + 16, 64, 0.25), {"step_multiple": 16}, seed=50 + s, scale=255.0)
        assert lo.ny == s and lo.step == 48
        jmesh = jax_make_mesh({"space": s})
        jprof = jax_profiles(jlo)
        out[s] = {
            "layout": lo, "tiles": tiles, "levels": lv,
            "collapsed": np.asarray(jax_halo.sharded_laplacian_blend(
                jtiles, *jprof, jlo, jmesh, levels=lv)),
            "deferred": jax_halo.sharded_laplacian_blend(
                jtiles, *jprof, jlo, jmesh, levels=lv, collapse_last=False),
        }
    return out


def port_deferred(case) -> ShardedCanvas:
    lo = case["layout"]
    s = lo.ny
    return sharded_laplacian_blend(case["tiles"], *layout_weight_profiles(lo), lo,
                                   cpu_mesh({"space": s}), levels=case["levels"],
                                   collapse_last=False)


@pytest.mark.parametrize("s", sorted(BLEND_CASES))
def test_sharded_blend_collapsed_matches_reference(blends, s):
    case = blends[s]
    lo = case["layout"]
    stats = {}
    got = sharded_laplacian_blend(case["tiles"], *layout_weight_profiles(lo), lo,
                                  cpu_mesh({"space": s}), levels=case["levels"],
                                  stats=stats).numpy()
    assert got.shape == case["collapsed"].shape
    np.testing.assert_allclose(got, case["collapsed"], atol=2e-4)
    assert stats["halo_bytes"] > 0
    # and the single-device blend of the same tiles, on the owned rows
    single = laplacian_fusion_tiles(case["tiles"], lo, weight_profiles=layout_weight_profiles(lo),
                                    levels=case["levels"], clip_range=None).numpy()
    np.testing.assert_allclose(got, single[: got.shape[0]], atol=2e-4)


@pytest.mark.parametrize("s", sorted(BLEND_CASES))
def test_sharded_blend_deferred_matches_reference(blends, s):
    case = blends[s]
    sc, ref = port_deferred(case), case["deferred"]
    assert isinstance(sc, ShardedCanvas) and sc.s == s == len(sc.lap0)
    assert (sc.own0, sc.hl0, sc.own1, sc.hl1, sc.w_pad, sc.cw1) == (
        ref.own0, ref.hl0, ref.own1, ref.hl1, ref.w_pad, ref.cw1)
    lap0, coarse = np.asarray(ref.lap0), np.asarray(ref.coarse)
    for d in range(s):
        # only each shard's authoritative rows: [0, own), all of the last one's
        own0 = sc.own0 if d < s - 1 else sc.hl0
        own1 = sc.own1 if d < s - 1 else sc.hl1
        np.testing.assert_allclose(sc.lap0[d][:own0].numpy(),
                                   lap0[d * sc.hl0 : d * sc.hl0 + own0], atol=2e-4)
        np.testing.assert_allclose(sc.coarse[d][:own1].numpy(),
                                   coarse[d * sc.hl1 : d * sc.hl1 + own1], atol=2e-4)
    # gathered, the pair matches the reference's gather
    g_lap0, g_coarse = gather_canvas(sc)
    r_lap0, r_coarse = jax_finalize.gather_canvas(ref)
    np.testing.assert_allclose(g_lap0.numpy(), np.asarray(r_lap0), atol=2e-4)
    np.testing.assert_allclose(g_coarse.numpy(), np.asarray(r_coarse), atol=2e-4)


def test_sharded_blend_validates_rows():
    lo = compute_layout(200, 200, 128, 0.25, step_multiple=32)  # ny = 2
    tiles = torch.zeros((lo.num_tiles, lo.block, lo.block, 3))
    with pytest.raises(ValueError):
        sharded_laplacian_blend(tiles, *layout_weight_profiles(lo), lo, cpu_mesh({"space": 8}))


def test_halo_row_upsample_is_k2_on_the_extended_band():
    """``_pyr_up_rows_halo`` (K2 on [top; band; bot]) against the
    reference's plain polyphase rows, for even and odd target widths and
    both kept row counts."""
    rng = np.random.default_rng(8)
    for m, w, out_rows, w_dst in ((7, 9, 14, 18), (7, 9, 13, 17), (1, 5, 2, 10), (4, 6, 7, 11)):
        coarse, top, bot = (rng.random(shape, dtype=np.float32) * 255
                            for shape in ((m, w, 3), (1, w, 3), (1, w, 3)))
        got = _pyr_up_rows_halo(*(torch.from_numpy(a) for a in (coarse, top, bot)),
                                out_rows, w_dst).numpy()
        ref = np.asarray(jax_halo._pyr_up_rows_halo(
            jnp.asarray(coarse), jnp.asarray(top), jnp.asarray(bot), out_rows, w_dst))
        assert got.shape == ref.shape == (out_rows, w_dst, 3)
        np.testing.assert_allclose(got, ref, atol=1e-5)


# -- sharded banded finalize --------------------------------------------------

FINALIZE_CASES = {"upscale_uint8": (2, 7, 2, 3, True), "downscale_float": (0.5, 0, 0.5, 0, False)}


def finalize_args(lo, case):
    fh, ah, fw, aw, quant = FINALIZE_CASES[case]
    return int(lo.image_h * fh) + ah, int(lo.image_w * fw) + aw, quant


@pytest.mark.parametrize("case", sorted(FINALIZE_CASES))
def test_sharded_finalize_matches_reference(blends, case):
    blend = blends[4]
    lo, sc = blend["layout"], port_deferred(blend)
    out_h, out_w, quant = finalize_args(lo, case)
    kw = dict(crop_h=lo.image_h, crop_w=lo.image_w, to_uint8=quant)
    stats = {}
    got = sharded_finalize_banded(sc, out_h, out_w, bands=8, stats=stats, **kw)
    ref = jax_finalize.sharded_finalize_banded(blend["deferred"], out_h, out_w, bands=8, **kw)
    assert stats["gather_fallback"] is False and stats["halo_bytes"] > 0
    assert got.shape == ref.shape == (out_h, out_w, 3) and got.dtype == ref.dtype
    if quant:
        assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, atol=1e-3)


@pytest.mark.parametrize("case", sorted(FINALIZE_CASES))
def test_sharded_finalize_matches_single_device(blends, case):
    blend = blends[4]
    lo = blend["layout"]
    out_h, out_w, quant = finalize_args(lo, case)
    kw = dict(crop_h=lo.image_h, crop_w=lo.image_w, to_uint8=quant)
    got = sharded_finalize_banded(port_deferred(blend), out_h, out_w, bands=8, **kw)
    lap0, coarse = laplacian_fusion_tiles(blend["tiles"], lo,
                                          weight_profiles=layout_weight_profiles(lo),
                                          levels=blend["levels"], clip_range=None,
                                          collapse_last=False)
    ref = blend_finalize_banded(lap0, coarse, out_h, out_w, bands=4, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if quant:
        assert np.mean(np.abs(got.astype(np.int32) - ref.astype(np.int32)) > 1) < 1e-3
    else:
        np.testing.assert_allclose(got, ref, atol=5e-3)


def test_sharded_finalize_iterator_row_order(blends):
    blend = blends[4]
    lo, sc = blend["layout"], port_deferred(blend)
    oh, ow = lo.image_h + 13, lo.image_w + 5
    kw = dict(crop_h=lo.image_h, crop_w=lo.image_w, to_uint8="uint16")
    full = sharded_finalize_banded(sc, oh, ow, bands=16, **kw)
    rows = list(sharded_finalize_banded(sc, oh, ow, bands=16, as_iterator=True, **kw))
    # 4 shards x ceil(16/4) sub-bands, in global row order
    assert len(rows) == 16 and sum(r.shape[0] for r in rows) == oh
    assert all(r.dtype == np.uint16 for r in rows) and full.dtype == np.uint16
    np.testing.assert_array_equal(np.concatenate(rows, axis=0), full)


def test_sharded_finalize_gather_fallback_matches_reference():
    """Eight shards of 48 canvas rows, finished to 5 output rows: shards
    5-7 have no output row of their own, so their windows lie far past
    their owned rows and the canvas is gathered."""
    lo, tiles, jlo, jtiles = both_tiles((96, 8 * 48 + 16, 64, 0.25), {"step_multiple": 16},
                                        seed=80, scale=255.0)
    assert lo.ny == 8
    sc = sharded_laplacian_blend(tiles, *layout_weight_profiles(lo), lo,
                                 cpu_mesh({"space": 8}), levels=2, collapse_last=False)
    jsc = jax_halo.sharded_laplacian_blend(jtiles, *jax_profiles(jlo), jlo,
                                           jax_make_mesh({"space": 8}), levels=2,
                                           collapse_last=False)
    kw = dict(crop_h=lo.image_h, crop_w=lo.image_w, to_uint8=True)
    stats = {}
    got = sharded_finalize_banded(sc, 5, 40, bands=8, stats=stats, **kw)
    ref = jax_finalize.sharded_finalize_banded(jsc, 5, 40, bands=8, **kw)
    assert stats["gather_fallback"] is True
    assert got.shape == ref.shape == (5, 40, 3)
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
