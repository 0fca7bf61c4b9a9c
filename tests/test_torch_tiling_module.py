"""Port parity: ``TilingModule.split_image`` / ``merge_tiles`` /
``_load_image``, the module's config rule, and the rest of
``tiling/geometry.py`` (``tile_rc``, ``to_dict``, ``reference_positions``,
``overlap_for_tile``) against ``srs_tpu`` on the CPU, on 64-px tiles.

``block_id`` is a uuid4 and the processing state carries a timestamp, so
those are compared by structure; everything else is compared exactly
(tile data, overlaps, neighbours, the md5, the complexity score that
numpy computes from the same float32 tile, the forbidden share) or, for
merged canvases, within 1e-4 absolute on [0, 255].
"""

import numpy as np
import pytest
import torch

import srs_tpu.tiling.geometry as RG
from srs_tpu.ops.resize import resize_bicubic_up as ref_resize_up
from srs_tpu.tiling.tiling import TilingModule as RefTiling
from srs_tpu_torch.config import TilingConfig
from srs_tpu_torch.io.image import save_image
from srs_tpu_torch.ops.resize import resize_bicubic_up
from srs_tpu_torch.tiling import geometry as TG
from srs_tpu_torch.tiling.tiling import TileStatus, TilingModule

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite's parallel workers would otherwise
    each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:150, 0:200].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 23), 127 + 90 * np.cos(yy / 31),
                    127 + 90 * np.sin((xx - yy) / 17)], -1)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.float32)


def _modules(tmp_path, **kw):
    ref = RefTiling(block_size=64, overlap_ratio=0.2, cache_dir=str(tmp_path / "r"), **kw)
    port = TilingModule(block_size=64, overlap_ratio=0.2, cache_dir=str(tmp_path / "p"),
                        device="cpu", **kw)
    return ref, port


def _meta(tile):
    d = tile.metadata.to_dict()
    del d["block_id"]
    return d


@pytest.mark.parametrize("content_aware", [False, True])
def test_split_image_matches_reference(tmp_path, image, content_aware):
    ref, port = _modules(tmp_path, content_aware=content_aware)
    got, want = port.split_image(image), ref.split_image(image)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert _meta(g) == _meta(w)
        np.testing.assert_array_equal(g.data, w.data)
        assert g.metadata.status == TileStatus.PENDING
        assert port.get_tile(g.metadata.block_id) is g
        if content_aware:
            assert "forbidden_ratio" in g.metadata.roi_flags
    assert len({t.metadata.block_id for t in got}) == len(got)
    h = got[0].metadata.image_hash
    assert h == TilingModule.compute_image_hash(image)
    state, ref_state = port.processing_state[h], ref.processing_state[h]
    assert set(state["tiles"]) == {t.metadata.block_id for t in got}
    for k in ("num_tiles", "block_size", "overlap", "image_w", "image_h"):
        assert state[k] == ref_state[k], k
    assert port._layouts[h].to_dict() == ref._layouts[h].to_dict()


def test_split_image_reads_png_and_tensors(tmp_path, image):
    """A PNG path (the port's decoder; md5 of the file, as the reference's
    tile store keys it) and a tensor (md5 of its bytes, as the array's)."""
    path = str(tmp_path / "in.png")
    save_image(path, image.astype(np.uint8))
    ref, port = _modules(tmp_path)
    got, want = port.split_image(path), ref.split_image(path)
    assert [_meta(g) for g in got] == [_meta(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
    from_tensor = port.split_image(torch.from_numpy(image))
    assert from_tensor[0].metadata.image_hash == TilingModule.compute_image_hash(image)
    np.testing.assert_array_equal(from_tensor[3].data, port.split_image(image)[3].data)


def test_merge_tiles_matches_reference(tmp_path, image):
    """Identity merge (the input back), an upscaled merge with the scale
    inferred from the data, and a merge in a fresh module that rebuilds
    the layout from the tiles' metadata."""
    ref, port = _modules(tmp_path)
    got, want = port.split_image(image), ref.split_image(image)
    out = port.merge_tiles(got, output_size=image.shape[:2], scale=1)
    np.testing.assert_allclose(out, image, atol=1e-3)
    np.testing.assert_allclose(out, ref.merge_tiles(want, output_size=image.shape[:2], scale=1),
                               atol=ATOL)
    import jax.numpy as jnp

    for g, w in zip(got, want):
        g.data = resize_bicubic_up(torch.from_numpy(g.data)[None], 2)[0].numpy()
        w.data = np.asarray(ref_resize_up(jnp.asarray(w.data)[None], 2))[0]
    up = port.merge_tiles(got)
    assert up.shape == (300, 400, 3)
    np.testing.assert_allclose(up, ref.merge_tiles(want), atol=ATOL)
    fresh_ref, fresh_port = _modules(tmp_path / "fresh")
    np.testing.assert_allclose(fresh_port.merge_tiles(got), fresh_ref.merge_tiles(want),
                               atol=ATOL)
    with pytest.raises(ValueError, match="no tiles"):
        port.merge_tiles([])


def test_module_reads_its_config():
    """Arguments left at their defaults read the config, as in the
    reference; a checkout without a card fails on split, not on build."""
    cfg = TilingConfig(block_size=96, overlap_ratio=0.25, l1_cache_size=7)
    m = TilingModule(config=cfg)
    # the L1 size reads the config only when the argument is falsy (50 is its default)
    assert (m.block_size, m.overlap_ratio, m.store.l1.max_size) == (96, 0.25, 50)
    assert TilingModule(config=cfg, l1_cache_size=0).store.l1.max_size == 7
    m = TilingModule(128, 0.1, config=cfg, output_scale=4)
    assert (m.block_size, m.overlap_ratio, m.output_scale) == (128, 0.1, 4)
    with pytest.raises(ValueError, match="overlap_ratio"):
        TilingConfig(overlap_ratio=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            m.split_image(np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("size", [(200, 150, 64, 0.2), (1280, 720, 512, 0.2), (97, 33, 32, 0.25)])
def test_geometry_helpers_match_reference(size):
    w, h, block, ratio = size
    assert TG.reference_positions(w, h, block, ratio) == RG.reference_positions(w, h, block, ratio)
    for x, y, tw, th in TG.reference_positions(w, h, block, ratio):
        assert TG.overlap_for_tile(x, y, tw, th, w, h, block, ratio) == RG.overlap_for_tile(
            x, y, tw, th, w, h, block, ratio)
    lo, ref_lo = TG.compute_layout(w, h, block, ratio, 32), RG.compute_layout(w, h, block, ratio, 32)
    assert lo.to_dict() == ref_lo.to_dict()
    assert lo.scaled(3).to_dict() == ref_lo.scaled(3).to_dict()
    assert [lo.tile_rc(t) for t in range(lo.num_tiles)] == [
        ref_lo.tile_rc(t) for t in range(lo.num_tiles)]
