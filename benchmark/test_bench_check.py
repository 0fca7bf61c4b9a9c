"""The comparison that decides ``correct``, on the CPU at a toy size: a
sound run is correct, a run whose timed path or QA is broken underneath
is not, and the control (the reference one precision step down) fails
the real configuration's limits."""

import json
import os

import numpy as np
import pytest
import torch

import cpu_cell
import run
from yardstick import check, inputs, reference, weights

HERE = os.path.dirname(os.path.abspath(__file__))
STORE = os.path.join(os.path.dirname(HERE), "srs_tpu_torch", "models", "checkpoints")


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _run(tmp_path, fault=None, seed=5, config=cpu_cell.CONFIG):
    torch.set_num_threads(2)
    return run.run_cell(cpu_cell.CELL, config, cpu_cell.TRAFFIC, cpu_cell.END_TO_END,
                        [], seed, 0.0, False, device="cpu", cache_dir=str(tmp_path / "cache"),
                        log=lambda s: None, fault=fault)


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"], res["check"]
    assert res["attempted"] == cpu_cell.TRAFFIC["jobs_per_call"] and res["failed"] == 0
    assert list(res)[-1] == "check"


def test_seeded_weights_run_correct_and_clip_little(tmp_path):
    """The toy with seeded espcn weights: the program, handed them as a
    checkpoint directory, agrees with the reference, which draws them
    itself; two draws are equal; under 1% of the net's output clips."""
    cfg = cpu_cell.SEEDED_CONFIG
    res = _run(tmp_path, config=cfg)
    assert res["correct"], res["check"]
    a, b = weights.seeded(cfg), weights.seeded(cfg)
    assert list(a) == [("espcn", 3)]
    for k, v in a[("espcn", 3)].items():
        torch.testing.assert_close(v, b[("espcn", 3)][k], atol=0, rtol=0)
    nets = reference.Nets(reference.Store(STORE, "cpu", a), cfg["nets"])
    pool = inputs.load_pool(cpu_cell.TRAFFIC["input"], str(tmp_path / "cache"))
    with torch.inference_mode():
        x = torch.stack([torch.from_numpy(img) for img in pool.values()])
        for _step in cfg["route"]["ladder"]:
            y = nets.forward("espcn", 3, x)
            assert float(((y < 0) | (y > 255)).float().mean()) < 0.01
            x = y.clamp(0, 255)


def test_weights_of_another_seed_are_not_correct(tmp_path):
    """The program served another seed's espcn, the route unchanged."""
    other = weights.seeded({**cpu_cell.SEEDED_CONFIG,
                            "nets": {"espcn": {**cpu_cell.CONFIG["nets"]["espcn"],
                                               "weights": {"seed": 12}}}})

    def swap(pipe):
        pipe.sr_module.weights[("espcn", 3)] = other[("espcn", 3)]
        pipe.sr_module._nets.clear()  # the nets the warm-up built

    res = _run(tmp_path, fault=swap, config=cpu_cell.SEEDED_CONFIG)
    assert not res["correct"]
    assert res["check"]["route_differs"]["value"] == 0
    tiff = res["check"]["tiff_mean_abs_lsb"]
    assert tiff["value"] > tiff["limit"], res["check"]


def _answer_altered(pipe):
    """One tile's answer altered where the SR stage produces it."""
    sr = pipe.sr_module
    orig = sr.upscale_tiles

    def altered(tiles, scale, *a, **k):
        out = orig(tiles, scale, *a, **k)
        if out.shape[1] == 9 * 128:
            out[0] = (out[0] + 8.0).clamp_(0, 255)
        return out

    sr.upscale_tiles = altered


def _half_left_out(pipe):
    """Half of the tile batch skips the nets (served as bicubic)."""
    from srs_tpu_torch.ops.resize import resize_bicubic_up

    sr = pipe.sr_module
    orig = sr.upscale_tiles

    def half(tiles, scale, *a, **k):
        n = tiles.shape[0] // 2
        out = orig(tiles[:n], scale, *a, **k)
        rest = resize_bicubic_up(tiles[n:], scale).clamp(0, 255)
        return torch.cat([out, rest])

    sr.upscale_tiles = half


def _band_altered(monkeypatch):
    """The writer's first band altered where the save produces it."""
    from srs_tpu_torch.io import native

    orig = native.TiffStreamWriter.write
    seen = {}

    def write(self, rows):
        if id(self) not in seen:
            seen[id(self)] = True
            rows = np.clip(rows.astype(np.int16) + 6, 0, 255).astype(np.uint8)
        return orig(self, rows)

    monkeypatch.setattr(native.TiffStreamWriter, "write", write)


def _lpips_half_resolution(pipe):
    """LPIPS scored on 2x2 means of the pair, a cheaper distance."""
    import torch.nn.functional as F

    full = pipe.quality_module._lpips

    def half(x):
        return F.avg_pool2d(x.permute(2, 0, 1)[None], 2)[0].permute(1, 2, 0)

    class Half:
        def __call__(self, a, b, net="vgg"):
            return full(half(a), half(b), net=net)

    pipe.quality_module._lpips = Half()


def _ssim_subsampled(monkeypatch):
    """SSIM on every second row and column."""
    from srs_tpu_torch.qa import module

    full = module.M.ssim
    monkeypatch.setattr(module.M, "ssim", lambda a, b: full(a[::2, ::2], b[::2, ::2]))


def _qa_value_left_out(monkeypatch):
    """The report without its Alex LPIPS distance."""
    from srs_tpu_torch.qa.module import QualityAssessmentModule

    full = QualityAssessmentModule.evaluate_full_reference

    def without(self, *a, **k):
        out = full(self, *a, **k)
        out.pop("lpips_alex", None)
        return out

    monkeypatch.setattr(QualityAssessmentModule, "evaluate_full_reference", without)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "band_altered",
                                   "lpips_half_resolution", "ssim_subsampled",
                                   "qa_value_left_out"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    hooks = {"answer_altered": _answer_altered, "half_left_out": _half_left_out,
             "lpips_half_resolution": _lpips_half_resolution}
    patches = {"band_altered": _band_altered, "ssim_subsampled": _ssim_subsampled,
               "qa_value_left_out": _qa_value_left_out}
    hook = hooks.get(fault) or (lambda pipe: patches[fault](monkeypatch))
    res = _run(tmp_path, fault=hook)
    assert not res["correct"], res["check"]


def test_a_failed_job_is_not_correct(tmp_path):
    def fail(pipe):
        def boom(*a, **k):
            raise RuntimeError("injected")

        pipe.sr_module.upscale_tiles = boom
    res = _run(tmp_path, fault=fail)
    assert not res["correct"] and res["failed"] == res["attempted"]


def test_the_control_fails_the_fusion_limits():
    """The reference with float8 convolutions, put in the program's place,
    against the reference: the fusion tier's nets and limits on a 24x40
    input (tiles of 16 to 9x)."""
    import control

    torch.set_num_threads(4)
    cfg = _config("fusion-100mp")
    cfg = {**cfg, "pipeline": {**cfg["pipeline"], "block_size": 16,
                               "target_resolution": "360x216"}}
    img = inputs.render_crop(2, 40, [10, 34])
    rows = control.control_rows(img, cfg, STORE, "cpu")
    values = {n: (v, lim) for n, v, lim in rows}
    assert values["route_differs"][0] == 0 and values["layout_differs"][0] == 0
    assert not check.verdict(rows), values
    assert values["tiff_mean_abs_lsb"][0] > values["tiff_mean_abs_lsb"][1]


def _reference_record(cfg):
    return {"route": {k: cfg["route"][k] for k in ("provider", "model", "ladder", "steps")},
            "layout": {"num_tiles": 6, "block": 512, "overlap": 128}, "target": [4, 5],
            "tiff": np.zeros((4, 5, 3), np.uint8), "probe": None,
            "qa": {"psnr": 40.0, "ssim": 0.99, "ms_ssim": 0.999, "lpips_vgg": 0.01,
                   "lpips_alex": 0.005}}


def test_the_check_reads_a_missing_record_as_a_failure():
    cfg = _config("fusion-100mp")
    rows = check.compare(cfg, None, None, None, _reference_record(cfg), 0)
    assert not check.verdict(rows)
    assert all(np.isfinite(v) for _n, v, _l in rows)
    values = {n: v for n, v, _l in rows}
    assert values["qa_keys_differ"] == len(cfg["qa_keys"])
    assert values["qa_lpips_alex_gap"] == check.MISSING


def test_the_check_holds_the_report_to_the_stated_keys_and_values():
    import control

    cfg = _config("fusion-100mp")
    ref = _reference_record(cfg)
    info = control.as_program_record(ref)
    report = control.as_program_report(ref, cfg)
    tiff = ref["tiff"].copy()
    assert check.verdict(check.compare(cfg, info, tiff, report, ref, 0))
    extra = check.compare(cfg, info, tiff, {**report, "extra": 1.0}, ref, 0)
    assert {n: v for n, v, _l in extra}["qa_keys_differ"] == 1
    moved = check.compare(cfg, info, tiff, {**report, "ssim": 0.98}, ref, 0)
    assert not check.verdict(moved)


def test_the_worst_image_decides():
    a = [("x", 0.1, 0.5), ("y", 0.0, 0.0)]
    b = [("x", 0.7, 0.5), ("y", 0.0, 0.0)]
    assert check.worst([a, b]) == [("x", 0.7, 0.5), ("y", 0.0, 0.0)]
    assert check.worst([a, b[:1]])[1] == ("y", check.MISSING, 0.0)
