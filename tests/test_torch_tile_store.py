"""Port parity: the tile store (srs_tpu_torch.tiling.cache,
srs_tpu_torch.io.native.content_hash and TilingModule's store half against
srs_tpu's).

The same operations on the same data, made from a seed with numpy, give
the same results in both packages: LRU hits, misses and evictions; store
entries, listings and statistics; content hashes. A store, a tile cache or
a TilingModule checkpoint written by either package reads in the other,
array for array (exact: npz holds the arrays as they are).
"""

import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

import srs_tpu.io.native as ref_native
import srs_tpu.tiling.cache as ref_cache
import srs_tpu_torch.tiling.cache as port_cache
from srs_tpu.io.native import content_hash as ref_content_hash
from srs_tpu.tiling.tiling import TilingModule as RefTiling
from srs_tpu_torch.io.native import content_hash
from srs_tpu_torch.tiling.tiling import Tile, TileMetadata, TileStatus, TilingModule

PACKAGES = {"reference": ref_cache, "port": port_cache}


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:150, 0:200].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 23), 127 + 90 * np.cos(yy / 31),
                    127 + 90 * np.sin((xx - yy) / 17)], -1)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.float32)


def _lru_trace(mod, seed):
    """A seeded run of puts and gets; what each get returned, and stats."""
    rng = np.random.default_rng(seed)
    c = mod.LRUCache(max_size=4)
    got = []
    for _ in range(200):
        k = f"k{rng.integers(0, 9)}"
        if rng.random() < 0.5:
            c.put(k, int(rng.integers(0, 1000)))
        else:
            got.append(c.get(k))
    return got, c.stats(), len(c), sorted(c._data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_cache_matches_reference(seed):
    assert _lru_trace(port_cache, seed) == _lru_trace(ref_cache, seed)


def _store_trace(mod, root, seed):
    rng = np.random.default_rng(seed)
    store = mod.TileStore(str(root), l1_size=3)
    arrays = {}
    for i in range(6):
        h, b = f"img{i % 2}", f"blk{i}"
        arrays[(h, b)] = rng.integers(0, 255, (8, 6, 3)).astype(
            np.uint8 if i % 2 else np.float32)
        store.put(h, b, arrays[(h, b)], step=i)
    store.l1.clear()
    got = {k: store.get(*k) for k in arrays}
    for k, v in got.items():
        np.testing.assert_array_equal(v, arrays[k])
        assert v.dtype == arrays[k].dtype
    listing = {h: sorted(store.list_blocks(h)) for h in ("img0", "img1")}
    store.evict_image("img0")
    after = (store.has("img0", "blk0"), store.has("img1", "blk1"), store.get("img0", "blk2"))
    stats = store.stats()
    return listing, after, stats["l2_files"], stats["l1"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_store_matches_reference(tmp_path, seed):
    assert _store_trace(port_cache, tmp_path / "port", seed) == \
        _store_trace(ref_cache, tmp_path / "ref", seed)


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    rng = np.random.default_rng(7)
    data = {f"sr_{i}": rng.integers(0, 256, (24, 24, 3)).astype(np.uint8) for i in range(4)}
    data["f32"] = rng.random((5, 7, 3)).astype(np.float32) * 255
    w = PACKAGES[writer].TileStore(str(tmp_path))
    for block, arr in data.items():
        w.put("sr-key", block, arr, scale=3)
    r = PACKAGES[reader].TileStore(str(tmp_path))
    assert sorted(r.list_blocks("sr-key")) == sorted(data)
    for block, arr in data.items():
        assert r.has("sr-key", block)
        got = r.get("sr-key", block)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    assert r.stats()["l2_files"] == len(data)


def load_reference_native(timeout_s: float = 120.0):
    """The reference's native library (``native/libsrstiff.so``), loaded.

    The reference builds it in place with ``make`` when its stamp is
    missing, which is so in a fresh checkout. Under pytest-xdist every
    worker imports tests/test_native_io.py while it collects, and that
    module's ``skipif`` loads the library then: several workers run
    ``make`` at once, and one may find the half-written file of another
    up to date and fail to load it. The reference's loader then remembers
    the failure for the life of the worker (``_load_failed``): its
    ``content_hash`` raises, and its pipeline saves TIFFs through PIL with
    LZW. By the time a test runs the other build has finished, so the
    failure is forgotten and the load tried again until it succeeds."""
    deadline = time.time() + timeout_s
    while True:
        ref_native._load_failed = False
        try:
            return ref_native.load()
        except ImportError:
            if time.time() > deadline:
                raise
            time.sleep(1.0)


@pytest.fixture(scope="module")
def reference_native():
    return load_reference_native()


@pytest.mark.parametrize("data", [
    b"", b"abc", bytes(range(256)) * 3,
    np.arange(1000, dtype=np.uint16).reshape(10, 100)[:, ::3],  # not contiguous
    (np.random.default_rng(1).random((17, 9, 3)) * 255).astype(np.float32),
], ids=["empty", "abc", "bytes", "uint16_view", "float32"])
def test_content_hash_matches_reference(data, reference_native):
    assert content_hash(data) == ref_content_hash(data)


def test_cache_thread_safety(tmp_path):
    """Concurrent puts and gets (the reference's test, on the port)."""
    cache = port_cache.LRUCache(max_size=16)
    store = port_cache.TileStore(str(tmp_path / "c"), l1_size=8)
    errors = []

    def worker(k):
        try:
            for i in range(200):
                cache.put(f"k{(k * 7 + i) % 32}", i)
                cache.get(f"k{i % 32}")
                if i % 50 == 0:
                    store.put("h", f"b{k}_{i}", np.full((4, 4, 3), k, np.float32))
                    assert store.get("h", f"b{k}_{i}") is not None
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(cache) <= 16
    assert len(store.list_blocks("h")) == 8 * 4


def _ref_split(tmp_path, image):
    ref = RefTiling(block_size=64, overlap_ratio=0.2, cache_dir=str(tmp_path), step_multiple=32)
    tiles = ref.split_image(image)
    h = tiles[0].metadata.image_hash
    for t in tiles:
        ref.save_tile_cache(t)
    ref.save_checkpoint(h)
    return ref, tiles, h


def test_tiling_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path, image):
    ref, tiles, h = _ref_split(tmp_path, image)
    port = TilingModule(64, 0.2, cache_dir=str(tmp_path))
    restored = port.restore_from_cache(h)
    assert len(restored) == len(tiles)
    for a, b in zip(sorted(tiles, key=lambda t: t.metadata.tile_index), restored):
        assert b.metadata.to_dict() == a.metadata.to_dict()
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.get_effective_region(), a.get_effective_region())
        assert port.get_tile(b.metadata.block_id) is b
        np.testing.assert_array_equal(port.load_tile_cache(h, b.metadata.block_id), a.data)
    assert port.processing_state[h] == ref.processing_state[h]
    assert port.restore_from_cache("nonexistent") is None
    assert port.get_cache_stats()["l2_files"] == ref.get_cache_stats()["l2_files"]


def test_tiling_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path, image):
    """The port restores the reference's split, marks a tile cached after
    storing new data, drops another tile's file and saves its checkpoint;
    a fresh reference module restores the same tiles, the dropped one
    PENDING with zero data (the reference's rule)."""
    _ref, tiles, h = _ref_split(tmp_path / "a", image)
    port = TilingModule(64, 0.2, cache_dir=str(tmp_path / "a"))
    restored = port.restore_from_cache(h)
    rng = np.random.default_rng(4)
    new = (rng.random(restored[1].data.shape) * 255).astype(np.float32)
    restored[1].data = new
    port.save_tile_cache(restored[1])
    assert restored[1].metadata.status == TileStatus.CACHED
    os.remove(os.path.join(str(tmp_path / "a"), h, f"{restored[2].metadata.block_id}.npz"))
    port.save_checkpoint(h)
    back = RefTiling(block_size=64, overlap_ratio=0.2, cache_dir=str(tmp_path / "a"),
                     step_multiple=32).restore_from_cache(h)
    mine = TilingModule(64, 0.2, cache_dir=str(tmp_path / "a")).restore_from_cache(h)
    assert [t.metadata.to_dict() for t in mine] == [
        {**t.metadata.to_dict()} for t in back]
    for a, b in zip(mine, back):
        np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(back[1].data, new)
    assert back[1].metadata.status.value == "cached"
    assert back[2].metadata.status.value == "pending" and not back[2].data.any()
    with pytest.raises(KeyError):
        port.save_checkpoint("unknown")


def test_tile_api_round_trip(tmp_path):
    """A tile made in the port: metadata to and from dicts, the cache, and
    the effective region without its overlap bands."""
    meta = TileMetadata(block_id="b0", tile_index=0, row=0, col=1, global_x=48, global_y=0,
                        input_w=64, input_h=64, output_w=128, output_h=128, overlap_top=0,
                        overlap_bottom=16, overlap_left=16, overlap_right=0, image_hash="h",
                        neighbor_ids=[1, 2])
    assert TileMetadata.from_dict(meta.to_dict()) == meta
    data = np.random.default_rng(2).random((64, 64, 3)).astype(np.float32)
    tile = Tile(data=data, metadata=meta)
    assert tile.get_effective_region().shape == (48, 48, 3)
    module = TilingModule(64, 0.2, cache_dir=str(tmp_path))
    module.save_tile_cache(tile)
    np.testing.assert_array_equal(module.load_tile_cache("h", "b0"), data)
    stats = module.get_cache_stats()
    assert stats["l2_files"] == 1 and stats["l1"]["size"] == 1


@pytest.mark.parametrize("tile_index", [0, 3, -1])
def test_streaming_load_and_image_hash_match_reference(tmp_path, image, tile_index):
    path = str(tmp_path / "img.png")
    Image.fromarray(image.astype(np.uint8)).save(path)
    ref = RefTiling(block_size=64, overlap_ratio=0.2, cache_dir=str(tmp_path), step_multiple=32)
    port = TilingModule(64, 0.2, cache_dir=str(tmp_path))
    n = ref.split_to_batch(image)[0].num_tiles
    idx = tile_index % n
    np.testing.assert_array_equal(port.load_tile_streaming(path, idx),
                                  ref.load_tile_streaming(path, idx))
    assert port.compute_image_hash(path) == ref.compute_image_hash(path)
    assert port.compute_image_hash(image) == ref.compute_image_hash(image)
