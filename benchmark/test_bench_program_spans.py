"""The readers of the program's per-job span record, on synthetic runs, and
the pyramid kernels' counters held against the launch-shape recorder."""

from types import SimpleNamespace

import pytest
import torch

import run
from yardstick import pyramid

SPANS = {"save": 1.2, "save/fetch": 0.3, "save/write": 0.5, "save/close": 0.2,
         "count/tiff.deflate_s": 2.8, "count/tiff.barrier_s": 0.1,
         "super_resolution": 10.0,
         "super_resolution/edsr_xl+@x3": 4.0, "device/super_resolution/edsr_xl+@x3": 4.5,
         "super_resolution/edsr_l+@x3": 3.0,  # no event pair: the host span counts
         "super_resolution/edsr_xl@x3": 0.6, "device/super_resolution/edsr_xl@x3": 0.7,
         "super_resolution/edsr_xl+@x2": 1.0, "device/super_resolution/edsr_xl+@x2": 1.5}
WANT = {"save_fetch_s": 0.3, "save_writer_s": 0.7, "deflate_cpu_s": 2.8,
        "writer_serial_s": 0.4, "sr_ensemble_s": 9.0}


def _run(*spans, success=True):
    return {"results": [SimpleNamespace(success=success, spans=s) for s in spans]}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_record_and_none_without_it(name):
    read = run.load_reader(name)
    assert read(_run(SPANS)) == pytest.approx(WANT[name])
    # the mean over the window's successful images
    tripled = {k: 3 * v for k, v in SPANS.items()}
    assert read({"results": _run(SPANS)["results"] + _run(tripled)["results"]
                 + _run({}, success=False)["results"]}) == pytest.approx(2 * WANT[name])
    # a program without the record, or a job without these spans
    assert read({"results": [SimpleNamespace(success=True, stage_times={"save": 1.0})]}) is None
    assert read(_run({"save": 1.2, "super_resolution": 10.0})) is None
    assert read(_run(SPANS, success=False)) is None


def test_pyramid_counters_match_the_recorded_launches():
    from srs_tpu_torch.ops.blend import laplacian_fusion_tiles
    from srs_tpu_torch.ops.weights import layout_weight_profiles
    from srs_tpu_torch.tiling.geometry import compute_layout
    from srs_tpu_torch.utils import profiling

    lo = compute_layout(120, 80, 64, 0.25, step_multiple=32)
    tiles = torch.rand(lo.num_tiles, 64, 64, 3) * 255
    with profiling.job() as record, pyramid.recorded_shapes("srs_tpu_torch") as shapes:
        laplacian_fusion_tiles(tiles, lo, layout_weight_profiles(lo), levels=4)
    for name, launches in shapes.items():
        assert launches
        assert record.counters[f"{name}.bytes"] == sum(
            pyramid.WORK[name](a, b)[0] for a, b in launches)
