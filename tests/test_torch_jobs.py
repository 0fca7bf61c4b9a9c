"""Port parity: the job layer of ``process()`` against the JAX package's,
on the CPU, at the reference's own toy size (tests/test_pipeline.py:19-45:
120x160 -> 240x320, block 64, a four-level blend, 2 IBP steps, QA off).

- Failure ladder: the same injected failures in ``upscale_tiles`` on both
  sides (tests/test_pipeline.py:322-379 and one more rung); the same
  served provider, ladder, layout, attempts, degradations and scheduler
  counters, and pixels within the tolerance of
  tests/test_torch_provider_pipeline.py (at most 1 LSB, on under 1% of
  samples). Both sides serve the packaged trained ``espcn`` (converted
  for the port) as the quality and the fast net, float32 convolutions.
- Cancellation: the reference's test_pipeline_cancel
  (tests/test_webui_cli.py:96-124) on the port.
- Resume: kill-and-rerun and partial resume
  (tests/test_pipeline.py:381-460) on the port; the resumed output within
  2 LSB of the reference's fresh run (uint8 store quantization, the
  reference test's bound). The resume key changes with every knob that
  changes the SR output, is the same for the same job in two pipelines,
  and takes the job's alpha.
- Batches: priority order, and a pipelined batch whose outputs equal
  sequential runs, its device stages one job at a time.
- ``roi_regions`` (commercial QA on the proxy, in ``process`` and in a
  batch job) and ``--checkpoint``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.cli import main
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.models.registry import seeded_params
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from srs_tpu_torch.scheduler import VIPLevel
from srs_tpu_torch.tiling.cache import TileStore
from srs_tpu_torch.tiling.geometry import compute_layout
from test_torch_providers import PACKAGED, converted
from torch_packaged import packaged_in

RESUME_LSB = 2.0
CFG = dict(block_size=64, overlap_ratio=0.2, target_resolution="320x240", num_pyramid_levels=4,
           ibp_steps=2, enable_qa=False, auto_route=False, per_scale_selection=False,
           quality_model="espcn")


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    """The reference's fixture (tests/test_pipeline.py:19-32)."""
    d = tmp_path_factory.mktemp("inputs")
    r = np.random.default_rng(5)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 13), 127 + 90 * np.cos(yy / 11),
                    127 + 90 * np.sin((xx + yy) / 7)], -1)
    img = np.clip(img + r.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    p = str(d / "input.png")
    Image.fromarray(img).save(p)
    return p


@pytest.fixture(scope="module")
def espcn():
    return {("espcn", s): converted("espcn", s) for s in (2, 3, 4)}


def _reference(tmp_path, monkeypatch, **cfg):
    """The reference pipeline serving exactly the packaged espcn nets."""
    d = tmp_path / "ckpt"
    if not d.exists():
        d.mkdir()
        for s in (2, 3, 4):
            os.symlink(os.path.join(PACKAGED, f"espcn_x{s}"), d / f"espcn_x{s}")
    packaged_in(monkeypatch, tmp_path / "none")
    pipe = JaxPipeline(JaxConfig(**{**CFG, **cfg}))
    pipe._ensure_engine()
    pipe.sr_module.config.checkpoint_dir = str(d)
    pipe.sr_module.config.compute_dtype = "float32"
    return pipe


def _port(weights, **cfg):
    return SuperResolutionPipeline(
        PipelineConfig(**{**CFG, "compute_dtype": "float32", "device": "cpu", **cfg}), weights)


def _pixels(path):
    if path.endswith(".tiff"):
        return read_tiff(path).astype(np.int16)
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def _failing(pipe, rule):
    """Wrap the pipeline's ``upscale_tiles`` to raise where
    ``rule(call number, provider)`` says so."""
    real, calls = pipe.sr_module.upscale_tiles, {"n": 0}

    def flaky(tiles, scale, provider="quality", steps=0, **kw):
        calls["n"] += 1
        if rule(calls["n"], provider):
            raise RuntimeError("injected device failure (simulated OOM)")
        return real(tiles, scale, provider=provider, steps=steps, **kw)

    pipe.sr_module.upscale_tiles = flaky


# (rule, served provider, attempts, degradations)
LADDER_CASES = {
    "transient": (lambda n, p: n <= 2, "quality", 3, 0),
    "degrade_to_fast": (lambda n, p: p not in ("fast", "bicubic"), "fast", 5, 1),
    "degrade_to_bicubic": (lambda n, p: p != "bicubic", "bicubic", 9, 2),
}


@pytest.mark.parametrize("case", list(LADDER_CASES))
def test_failure_ladder_matches_reference(input_png, espcn, tmp_path, monkeypatch, case):
    rule, served, attempts, degradations = LADDER_CASES[case]
    ref = _reference(tmp_path, monkeypatch, provider="quality")
    _failing(ref, rule)
    res = ref.process(input_png, str(tmp_path / "ref.png"))
    assert res.success, res.error_message
    port = _port(espcn, provider="quality")
    _failing(port, rule)
    got = port.process(input_png, str(tmp_path / "out.tiff"))
    assert got.success, got.error_message

    ri, pi = ref.last_run_info, port.last_run_info
    for key in ("provider", "ladder", "num_tiles", "block", "models", "sr_attempts",
                "sr_degradations"):
        assert pi[key] == ri[key], key
    assert (pi["provider"], pi["sr_attempts"], pi["sr_degradations"]) == (
        served, attempts, degradations)
    assert port.scheduler.get_statistics()["counters"] == \
        ref.scheduler.get_statistics()["counters"]
    if degradations:
        lo = compute_layout(160, 120, 256, 16 / 256, step_multiple=32)
        assert (pi["block"], pi["overlap"], pi["num_tiles"]) == (lo.block, lo.overlap,
                                                                 lo.num_tiles)
    a, b = _pixels(got.output_path), _pixels(res.output_path)
    assert a.shape == b.shape == (240, 320, 3)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())


def test_pipeline_cancel(tmp_path):
    """tests/test_webui_cli.py::test_pipeline_cancel on the port."""
    img = (np.random.default_rng(0).random((60, 80, 3)) * 255).astype(np.uint8)
    src = str(tmp_path / "in.png")
    Image.fromarray(img).save(src)
    cfg = PipelineConfig(block_size=64, target_resolution="160x120", provider="bicubic",
                         enable_qa=False, device="cpu")
    pipe = SuperResolutionPipeline(cfg)
    pipe.cancel()
    result = pipe.process(src, str(tmp_path / "o.png"))
    assert result.success  # a stale cancel must not stop a fresh run

    pipe2 = SuperResolutionPipeline(cfg)
    orig = pipe2._upscale_batch

    def cancel_during_sr(*a, **k):
        pipe2.cancel()
        return orig(*a, **k)

    pipe2._upscale_batch = cancel_during_sr
    result = pipe2.process(src, str(tmp_path / "o2.png"))
    assert not result.success
    assert "cancelled" in result.error_message and "blending" in result.error_message
    assert not os.path.exists(str(tmp_path / "o2.png"))
    del pipe2._upscale_batch
    assert pipe2.process(src, str(tmp_path / "o3.png")).success


def _counting(pipe, store_dir):
    pipe.tiling_module.store = TileStore(str(store_dir))
    real, batches = pipe.sr_module.upscale_tiles, []

    def counted(tiles, scale, **kw):
        batches.append(int(tiles.shape[0]))
        return real(tiles, scale, **kw)

    pipe.sr_module.upscale_tiles = counted
    return batches


@pytest.mark.parametrize("partial", [False, True], ids=["kill_and_rerun", "partial"])
def test_resume_matches_reference_fresh_run(input_png, espcn, tmp_path, monkeypatch, partial):
    """Run 1 writes the store after SR and dies in blending. The rerun, on
    a fresh pipeline, makes no upscale call (or, after one tile's file is
    deleted, upscales just that tile); its output is within 2 LSB of the
    reference's fresh run."""
    store = tmp_path / "store"
    pipe = _port(espcn, provider="fast", enable_checkpoint=True)
    batches = _counting(pipe, store)
    pipe._blend = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("killed"))
    res = pipe.process(input_png, str(tmp_path / "killed.tiff"))
    assert not res.success and "killed" in res.error_message and batches
    n = pipe.last_run_info["num_tiles"]
    key = pipe.last_run_info["checkpoint"]["written_key"]
    assert sorted(TileStore(str(store)).list_blocks(key)) == sorted(f"sr_{i}" for i in range(n))
    if partial:
        os.remove(os.path.join(str(store), key, "sr_3.npz"))

    pipe2 = _port(espcn, provider="fast", enable_checkpoint=True)
    batches2 = _counting(pipe2, store)
    res2 = pipe2.process(input_png, str(tmp_path / "out.tiff"))
    assert res2.success, res2.error_message
    info = pipe2.last_run_info
    assert info["checkpoint"]["key"] == key
    if partial:
        assert batches2 == [1] and info["checkpoint"]["tiles_upscaled"] == 1
        assert not info["resumed"]
    else:
        assert batches2 == [] and info["resumed"]
    ref = _reference(tmp_path, monkeypatch, provider="fast").process(
        input_png, str(tmp_path / "ref.png"))
    assert ref.success, ref.error_message
    diff = np.abs(_pixels(res2.output_path) - _pixels(ref.output_path))
    assert diff.max() <= RESUME_LSB


def _key(weights=None, image_hash="h0", ladder=(2,), provider="quality", model=None,
         category=None, alpha=None, block=64, **cfg):
    w = {("espcn", s): seeded_params("espcn", s, seed=s) for s in (2, 3, 4)}
    w.update({("edsr_m", 2): seeded_params("edsr_m", 2, seed=1),
              ("cond_polish", 1): seeded_params("cond_polish", 1, seed=2),
              ("espcn_polish", 1): seeded_params("espcn_polish", 1, seed=3)})
    pipe = _port(w if weights is None else weights, enable_checkpoint=True,
                 **{"block_size": block, **cfg})
    layout = compute_layout(160, 120, block, pipe.config.overlap_ratio, step_multiple=32)
    return pipe._resume_key(image_hash, list(ladder), layout, provider, model, category, alpha)


# knob: (the base job, the job with the knob changed); every change
# changes the SR output.
KNOBS = {
    "image": ({}, dict(image_hash="h1")),
    "provider": ({}, dict(provider="fast")),
    "ladder": ({}, dict(ladder=(3,))),
    "ibp_steps": ({}, dict(ibp_steps=3)),
    "block_size": ({}, dict(block=128)),
    # at block 128 the overlaps are 32 and 64 px (at 64 both round to 32)
    "overlap_ratio": (dict(block=128), dict(block=128, overlap_ratio=0.3)),
    "padding_mode": ({}, dict(padding_mode="replicate")),
    "compute_dtype": ({}, dict(compute_dtype="bfloat16")),
    "params_dtype": ({}, dict(params_dtype="bfloat16")),
    "category": ({}, dict(category="food")),
    "quality_model": ({}, dict(quality_model="edsr_m")),
    "fast_model": (dict(provider="fast"), dict(provider="fast", fast_model="edsr_m")),
    "routed_model": ({}, dict(model="edsr_m")),
    "self_ensemble": ({}, dict(self_ensemble=True)),
    "weights": ({}, dict(weights={("espcn", s): seeded_params("espcn", s, seed=9)
                                  for s in (2, 3, 4)})),
    # an untrained quality net (the store hidden): the hybrid polish runs,
    # and its weights count
    "hybrid_polish": (dict(provider="hybrid", quality_model="rcan"),
                      dict(provider="hybrid", quality_model="rcan",
                           weights={("espcn_polish", 1): seeded_params("espcn_polish", 1,
                                                                       seed=4)})),
    "shrink_alpha": (dict(provider="shrink", alpha=0.25), dict(provider="shrink", alpha=0.5)),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_resume_key_changes_with_every_knob(knob, tmp_path, monkeypatch):
    from torch_packaged import port_store_in

    if knob == "hybrid_polish":  # the store holds rcan
        port_store_in(monkeypatch, tmp_path / "none")
    base, changed = KNOBS[knob]
    assert _key(**base) is not None and _key(**changed) != _key(**base)


def test_resume_key_is_per_job_and_stable():
    """The same job in two pipelines has one key; the key takes the job's
    alpha on the shrink route only; with the checkpoint off there is none."""
    assert _key() == _key()
    assert _key(provider="shrink", alpha=0.3) != _key(provider="shrink", alpha=0.5)
    assert _key(provider="quality", alpha=0.3) == _key(provider="quality", alpha=0.5)
    pipe = _port({})
    lo = compute_layout(160, 120, 64, 0.2, step_multiple=32)
    assert pipe._resume_key("h0", [2], lo, "quality", None, None, None) is None


def _variant(path, tmp_path, i):
    """Three different inputs: the fixture, flipped, and rolled."""
    with Image.open(path) as im:
        img = np.asarray(im)
    img = [img, img[:, ::-1], np.roll(img, 17, axis=1)][i]
    p = str(tmp_path / f"in{i}.png")
    Image.fromarray(np.ascontiguousarray(img)).save(p)
    return p


def test_process_batch_priority_order(input_png, tmp_path):
    pipe = _port({}, provider="bicubic")
    entered = []
    process = pipe.process

    def traced(inp, outp, **kw):
        entered.append(os.path.basename(outp))
        return process(inp, outp, **kw)

    pipe.process = traced
    jobs = [{"input": input_png, "output": str(tmp_path / "n0.tiff")},
            {"input": input_png, "output": str(tmp_path / "vip.tiff"),
             "vip_level": VIPLevel.ENTERPRISE},
            {"input": input_png, "output": str(tmp_path / "gold.tiff"), "vip_level": 2},
            {"input": input_png, "output": str(tmp_path / "n3.tiff")}]
    results = pipe.process_batch(jobs, max_concurrent=1)
    assert entered == ["vip.tiff", "gold.tiff", "n0.tiff", "n3.tiff"]
    assert [r.output_path for r in results] == [j["output"] for j in jobs]
    assert all(r.success for r in results)


def test_process_batch_pipelined_equals_sequential(input_png, espcn, tmp_path):
    """Two workers, three different jobs: each output equals its own
    sequential run, the SR stages never overlap (one job at a time in the
    device stages), a later job starts before the first ends, and the
    semaphore is cleared after the batch."""
    pipe = _port(espcn, provider="fast")
    inputs = [_variant(input_png, tmp_path, i) for i in range(3)]
    jobs = [{"input": p, "output": str(tmp_path / f"b{i}.tiff")} for i, p in enumerate(inputs)]
    sr, events, lock = [], [], threading.Lock()
    upscale, process = pipe._upscale_batch, pipe.process

    def timed_sr(*a, **k):
        t0 = time.perf_counter()
        out = upscale(*a, **k)
        with lock:
            sr.append((t0, time.perf_counter()))
        return out

    def traced(inp, outp, **kw):
        with lock:
            events.append(("start", time.perf_counter()))
        res = process(inp, outp, **kw)
        with lock:
            events.append(("end", time.perf_counter()))
        return res

    pipe._upscale_batch, pipe.process = timed_sr, traced
    results = pipe.process_batch(jobs, max_concurrent=2)
    assert all(r.success for r in results), [r.error_message for r in results]
    assert pipe._stage_sem is None
    sr.sort()
    assert all(a[1] <= b[0] for a, b in zip(sr, sr[1:])), sr
    starts = sorted(t for k, t in events if k == "start")
    ends = sorted(t for k, t in events if k == "end")
    assert starts[1] < ends[0]
    for i, job in enumerate(jobs):
        seq = _port(espcn, provider="fast").process(job["input"], str(tmp_path / f"s{i}.tiff"))
        assert seq.success
        np.testing.assert_array_equal(read_tiff(job["output"]), read_tiff(seq.output_path))


def test_process_batch_stress(tmp_path):
    """More workers than jobs in flight can use, with a short switch
    interval: every job succeeds, its output is its sequential run's, and
    the scheduler booked and completed every tile exactly once."""
    rng = np.random.default_rng(8)
    images = [(rng.random((40, 56, 3)) * 255).astype(np.float32) for _ in range(12)]
    workers = (os.cpu_count() or 4) + 2
    cfg = dict(block_size=32, target_resolution="112x80", num_pyramid_levels=3)
    pipe = _port({}, provider="bicubic", **cfg)
    jobs = [{"input": im, "output": str(tmp_path / f"j{i}.tiff")} for i, im in enumerate(images)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = pipe.process_batch(jobs, max_concurrent=workers)
    finally:
        sys.setswitchinterval(interval)
    assert all(r.success for r in results), [r.error_message for r in results]
    tiles = sum(r.total_blocks for r in results)
    counters = pipe.scheduler.get_statistics()["counters"]
    assert counters["submitted"] == counters["completed"] == tiles
    seq = _port({}, provider="bicubic", **cfg)
    for i in (0, 11):
        res = seq.process(images[i], str(tmp_path / f"seq{i}.tiff"))
        np.testing.assert_array_equal(read_tiff(jobs[i]["output"]), read_tiff(res.output_path))


# Commercial QA keys on the input-size proxy, within the commercial
# metrics' tolerance (tests/test_torch_commercial.py): relative 1e-4,
# absolute 1e-6; the brand's level equal.
ROIS = [{"type": "text", "bbox": [8, 8, 60, 24]},
        {"type": "product", "bbox": [70, 30, 60, 60]},
        {"type": "face", "bbox": [20, 60, 40, 40]},
        {"type": "brand", "bbox": [10, 10, 50, 50], "reference_color": (200, 30, 30)},
        {"type": "text", "bbox": [500, 500, 10, 10]}]


def _commercial(report):
    return {k: v for k, v in report.items() if k.startswith((
        "global_sharpness", "high_frequency_ratio", "text_", "product_", "face_", "skin_",
        "brand_", "color_variance", "oversharpen", "artifact", "noise_level", "brightness",
        "commercial_score"))}


def _commercial_close(got, ref):
    got, ref = _commercial(got), _commercial(ref)
    assert list(got) == list(ref) and "brand_color_accuracy_3" in got
    assert "text_sharpness_4" not in got
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_roi_regions_raise_not_implemented(input_png, tmp_path, monkeypatch):
    """(Named for the time when ROIs raised.) ``process(roi_regions=...)``
    and a ``process_batch`` job with ROIs add the reference's commercial
    keys to the QA report, computed on the input-size proxy with the boxes
    in input coordinates; the batch's job without ROIs gets none, and
    with QA off ROIs are ignored. Both sides serve ``bicubic`` with QA on."""
    ref = _reference(tmp_path, monkeypatch, provider="bicubic", enable_qa=True)
    port = _port({}, provider="bicubic", enable_qa=True)
    want = ref.process(input_png, str(tmp_path / "ref.png"), roi_regions=ROIS)
    got = port.process(input_png, str(tmp_path / "roi.tiff"), roi_regions=ROIS)
    assert want.success and got.success, (want.error_message, got.error_message)
    _commercial_close(got.quality_report, want.quality_report)

    jobs = [{"input": input_png, "output": str(tmp_path / "a.tiff")},
            {"input": input_png, "output": str(tmp_path / "b.tiff"), "roi_regions": ROIS}]
    ref_jobs = [dict(j, output=j["output"].replace(".tiff", ".png")) for j in jobs]
    batch, ref_batch = port.process_batch(jobs), ref.process_batch(ref_jobs)
    assert all(r.success for r in batch + ref_batch)
    assert _commercial(batch[0].quality_report) == {} == _commercial(ref_batch[0].quality_report)
    _commercial_close(batch[1].quality_report, ref_batch[1].quality_report)

    off = _port({}, provider="bicubic").process(input_png, str(tmp_path / "off.tiff"),
                                                roi_regions=ROIS)
    assert off.success and off.quality_report is None


def test_cli_checkpoint_runs_and_resumes(input_png, tmp_path, monkeypatch):
    """``--checkpoint`` keeps the tiles under the user's cache (here a
    temporary HOME); the second run of the same job reads them back."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    flags = ["--target", "320x240", "--block-size", "64", "--quality-model", "espcn",
             "--pin-quality-model", "--no-qa", "--steps", "2", "--device", "cpu",
             "--checkpoint"]
    out1, out2 = str(tmp_path / "c1.tiff"), str(tmp_path / "c2.tiff")
    assert main(["process", input_png, out1, *flags]) == 0
    store = tmp_path / "home" / ".cache" / "srs_tpu_torch" / "tiling"
    keys = os.listdir(store)
    assert len(keys) == 1 and len(os.listdir(store / keys[0])) > 0
    before = {f: os.path.getmtime(store / keys[0] / f) for f in os.listdir(store / keys[0])}
    assert main(["process", input_png, out2, *flags]) == 0
    assert os.listdir(store) == keys
    # every tile came from the store: nothing was recomputed, so nothing
    # was written again
    assert {f: os.path.getmtime(store / keys[0] / f) for f in os.listdir(store / keys[0])} \
        == before
    assert np.abs(read_tiff(out1).astype(np.int16) - read_tiff(out2)).max() <= RESUME_LSB
