"""The per-job span record (``srs_tpu_torch.utils.profiling``) as the port
feeds it, on the CPU at toy sizes: the job layer's stages and their
parts, the fusion members, the seam passes, the TIFF writer's counters
(and its bytes, unchanged) and the pyramid kernels' counters."""

import ctypes
import hashlib
import os
import struct
import threading

import numpy as np
import pytest
import torch

from srs_tpu_torch.io import native
from srs_tpu_torch.models.sr_module import SuperResolutionModule
from srs_tpu_torch.ops import seam
from srs_tpu_torch.ops.cuda import pyramid as k12
from srs_tpu_torch.ops.tiles import extract_tiles, merge_tiles
from srs_tpu_torch.ops.weights import layout_weights
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from srs_tpu_torch.tiling.geometry import compute_layout
from srs_tpu_torch.utils import profiling

STAGES = ("tiling", "super_resolution", "blending", "quality_assessment", "save")


def test_batch_jobs_each_have_their_own_record(tmp_path):
    """Two workers, QA on: each result has its own id and spans; every
    stage span is its ``stage_times`` entry; the parts of QA and of the
    save lie within their stage; the writer's counters match its file."""
    rng = np.random.default_rng(4)
    images = [(rng.random((40, 56, 3)) * 255).astype(np.float32) for _ in range(2)]
    pipe = SuperResolutionPipeline(PipelineConfig(
        device="cpu", provider="bicubic", block_size=32, target_resolution="112x80",
        num_pyramid_levels=3, auto_route=False, per_scale_selection=False))
    jobs = [{"input": im, "output": str(tmp_path / f"j{i}.tiff")} for i, im in enumerate(images)]
    results = pipe.process_batch(jobs, max_concurrent=2)
    assert all(r.success for r in results), [r.error_message for r in results]
    assert len({r.job_id for r in results}) == 2 and all(r.job_id > 0 for r in results)
    for r in results:
        spans = r.spans
        assert set(r.stage_times) == set(STAGES)
        for stage in STAGES:
            assert abs(spans[stage] - r.stage_times[stage]) <= 1e-3
        assert "device_wait" in spans
        for stage, parts in (("quality_assessment", ("finalize", "proxy", "full_reference",
                                                     "no_reference")),
                             ("save", ("fetch", "write", "close", "fullres_qa"))):
            inner = [spans[f"{stage}/{p}"] for p in parts]
            assert all(v > 0 for v in inner) and sum(inner) <= r.stage_times[stage]
        assert spans["count/tiff.raw_bytes"] == 112 * 80 * 3
        assert spans["count/tiff.strips"] == 1
        # the pipeline deflates only where the host has more than one CPU
        assert (spans["count/tiff.deflate_s"] > 0) == ((os.cpu_count() or 1) > 1)
        assert spans["count/pyr_down.bytes"] > 0 and spans["count/pyr_up.bytes"] > 0
        assert not any(k.startswith("device/") for k in spans)  # no card here
    # each job's counters are its own writer's
    for r, job in zip(results, jobs):
        with open(job["output"], "rb") as f:
            assert r.spans["count/tiff.out_bytes"] == sum(_strip_tags(f.read())[1])
    info = pipe.last_run_info["save_breakdown"]
    assert set(info) == {"fetch", "write", "close", "finalize", "fullres_qa"}
    assert profiling.current() is None


def test_fusion_member_spans_once_per_member_and_step():
    sr = SuperResolutionModule(device="cpu")
    tiles = torch.rand(2, 16, 16, 3) * 255
    with profiling.job() as record:
        for s in (2, 3):
            sr.upscale_tiles(tiles, s, provider="fusion")
    want = {f"super_resolution/{m}@x{s}" for s in (2, 3) for m, _w in sr._fusion_for(s)}
    assert len(want) == 16 and "super_resolution/bicubic@x3" in want
    assert set(record.times) == want
    assert all(record.counts[k] == 1 for k in want)


def test_span_and_count_without_a_record_record_nothing():
    with profiling.span("save/write") as timed:
        profiling.count("tiff.strips", 3)
    assert profiling.current() is None and timed.seconds > 0
    out = k12.pyr_down(torch.rand(1, 8, 8, 3))
    assert out.shape == (1, 4, 4, 3)


def test_record_is_per_thread():
    seen = {}

    def worker(i):
        with profiling.job() as record:
            profiling.count("n", i)
            seen[i] = (record.job_id, profiling.current().counters)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len({job for job, _c in seen.values()}) == 4
    assert all(counters == {"n": i} for i, (_j, counters) in seen.items())


def test_pyramid_counters_are_each_calls_float32_bytes():
    shapes = [(2, 17, 12, 3), (9, 8, 1)]
    with profiling.job() as record:
        want_down = want_up = 0
        for shape in shapes:
            x = torch.rand(shape)
            down = k12.pyr_down(x)
            up = k12.pyr_up(down, tuple(x.shape[-3:-1]))
            want_down += 4 * (x.numel() + down.numel())
            want_up += 4 * (down.numel() + up.numel())
    assert record.counters == {"pyr_down.bytes": want_down, "pyr_up.bytes": want_up}


def test_seam_passes_are_blending_spans():
    lo = compute_layout(96, 96, 64, 0.25, step_multiple=8)
    gen = torch.Generator().manual_seed(0)
    tiles = torch.rand(lo.num_tiles, 64, 64, 3, generator=gen) * 255
    canvas = merge_tiles(tiles, layout_weights(lo, "ramp"), lo)
    stats = {}
    with profiling.job() as record:
        found = seam.detect_seams(extract_tiles(canvas, lo), tiles, lo, stats=stats)
        bad = [s for s in found if s.severity != "low"]
        seam.repair_seams(canvas, bad, tiles, lo, stats=stats)
    assert bad and {"detect_s", "merge_s", "repair_s", "waves"} <= set(stats)
    assert set(record.times) == {"blending/seam_detect", "blending/seam_repair"}
    assert record.times["blending/seam_detect"] == stats["detect_s"]
    assert record.times["blending/seam_repair"] == stats["repair_s"]


def _pinned_image():
    h, w = 600, 2048
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 3) % 256, (xx ^ yy) % 256, ((xx // 5) * (yy // 7)) % 256],
                   -1)
    return np.ascontiguousarray(img.astype(np.uint8))


# sha256 of the pinned image streamed in 77-row bands at level 1, as the
# writer wrote it before its counters were added
PINNED = {False: "07693ccb531bed547b58b6c54e84d0cf656230c8bf3f8568ab873b3668f643b1",
          True: "b4f19eaa8270617643a91a74f32d1a6e0d6f746876d6d7a9a0a32ef1689c4046"}


def _strip_tags(data: bytes):
    """(StripOffsets, StripByteCounts) of a classic TIFF's first IFD."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    tags = {}
    for e in range(n):
        tag, _typ, count, value = struct.unpack_from("<HHII", data, ifd + 2 + 12 * e)
        if tag in (273, 279):  # LONG arrays, inline when one
            tags[tag] = (struct.unpack_from(f"<{count}I", data, value) if count > 1
                         else (value,))
    return tags[273], tags[279]


@pytest.mark.parametrize("compress", [False, True])
def test_tiff_writer_counters_match_its_file_and_bytes_are_unchanged(tmp_path, compress):
    img = _pinned_image()
    path = str(tmp_path / "w.tif")
    with profiling.job() as record:
        with native.TiffStreamWriter(path, *img.shape[:2], compress=compress) as w:
            for r in range(0, img.shape[0], 77):
                w.write(img[r:r + 77])
    with open(path, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == PINNED[compress]
    offsets, sizes = _strip_tags(data)
    c = record.counters
    assert c["tiff.strips"] == len(offsets) == 4
    assert c["tiff.raw_bytes"] == img.size and c["tiff.out_bytes"] == sum(sizes)
    assert c["tiff.threads"] >= 2 and c["tiff.file_s"] > 0
    assert (c["tiff.deflate_s"] > 0) == compress
    np.testing.assert_array_equal(native.read_tiff(path), img)

    # srs_tiff_end, the entry point without counters, writes the same file
    lib = native.load_library()
    other = str(tmp_path / "end.tif").encode()
    ctx = lib.srs_tiff_begin(other, *img.shape, 8, int(compress), 1)
    assert lib.srs_tiff_write_rows(ctx, img.ctypes.data_as(ctypes.c_void_p), img.shape[0]) > 0
    assert lib.srs_tiff_end(ctx) == len(data)
    with open(other, "rb") as f:
        assert f.read() == data
