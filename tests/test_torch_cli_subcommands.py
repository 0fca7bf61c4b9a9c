"""Port parity: the operator subcommands of ``python -m srs_tpu_torch``
(``info``, ``warmup``, ``generate``, ``bench``) against the JAX package's
``srs_tpu/cli.py`` and the repository's ``bench.py``, on the CPU.

``info`` has the reference's keys and net names; ``warmup`` runs a tiny
configuration; ``generate`` with the procedural switch writes exactly the
reference's float32 array (the reference's branch without PIL) and the
same PNG pixels; the bench's input is the reference's array, pixel for
pixel, and a small CPU run of each bench (the same knobs; the input and
the target cut to 48x64 -> 144x192, every net untrained on both sides)
prints a line with the reference's keys.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import srs_tpu.models.generate as jgen
import srs_tpu.pipeline as jax_pipeline
from srs_tpu.cli import main as jax_main
from srs_tpu_torch import bench
from srs_tpu_torch.cli import main
from srs_tpu_torch.io.image import load_image
from srs_tpu_torch.models import registry
from srs_tpu_torch.utils.flops import chip_peak_flops
from torch_packaged import packaged_in

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_bench():
    """The repository's bench.py as a module."""
    spec = importlib.util.spec_from_file_location("reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [[], ["--config"]])
def test_info_has_the_reference_keys_and_nets(args, capsys, tmp_path):
    assert jax_main(["info", *args]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["info", *args, "--checkpoint-dir", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"version", "backend", "devices", "models", "config"}
    assert got["version"] == want["version"]
    # the reference's nets, the port's generator, and the nets the reference
    # does not have (HAT), which the store does not ship
    assert sorted(got["models"]) == sorted([*want["models"], "ark_gen", *registry.PORT_ONLY])
    stored = registry.store_manifest()
    for name, entry in got["models"].items():
        assert set(entry) == {"description", "trained_scales"}
        if name in registry.PORT_ONLY:
            assert isinstance(entry["trained_scales"], str), name  # untrained
            continue
        # the store's scales of the net, each packaged in the reference too
        scales = sorted(s for s in (1, 2, 3, 4) if registry.store_name(name, s) in stored)
        assert scales and entry["trained_scales"] == scales, name
        if name != "ark_gen":
            assert set(entry) == set(want["models"][name])
            assert scales == want["models"][name]["trained_scales"], name
    # fusion's members, the pinned quality nets and the generator at every
    # scale the reference packages
    for name, scales in (("edsr_xl", [2, 3, 4]), ("edsr_l", [2, 3]), ("rcan", [2, 3, 4]),
                         ("edsr_m", [2, 3, 4]), ("espcn", [2, 3, 4]), ("ark_gen", [1])):
        assert got["models"][name]["trained_scales"] == scales, name
    if torch.cuda.is_available():
        assert got["backend"] == "cuda"
    else:
        assert got["backend"] == "cpu" and got["devices"] == ["cpu"]
    if args:
        assert set(got["config"]) == set(want["config"])
    else:
        assert got["config"] == want["config"] == "use --config"


def test_info_counts_the_nets_saved_in_the_checkpoint_dir(capsys, tmp_path, monkeypatch):
    packaged_in(monkeypatch, tmp_path / "none")  # the store's nets would join them
    for f in ("espcn_x2.pt", "espcn_x4.pt", "edsr_xl_x3.pt", "ark_gen_x1.pt", "notes.txt"):
        (tmp_path / f).write_bytes(b"")
    assert main(["info", "--checkpoint-dir", str(tmp_path)]) == 0
    models = json.loads(capsys.readouterr().out)["models"]
    assert models["espcn"]["trained_scales"] == [2, 4]
    assert models["edsr_xl"]["trained_scales"] == [3]
    assert models["ark_gen"]["trained_scales"] == [1]
    assert models["rcan"]["trained_scales"] == "untrained (bicubic floor + IBP)"


def test_warmup_runs_a_tiny_configuration(capsys):
    rc = main(["warmup", "--source", "160x120", "--target", "320x240", "--provider", "bicubic",
               "--block-size", "64", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("warmed 160x120 -> 320x240") and "XLA" not in out


def test_generate_procedural_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SRS_ARK_PROCEDURAL", "1")
    flags = ["--size", "96x64", "--category", "fashion", "--watermark"]
    assert jax_main(["generate", "a weave pattern", str(tmp_path / "ref.png"), *flags]) == 0
    monkeypatch.setattr(jgen, "Image", None)  # the reference's branch without PIL: np.save
    assert jax_main(["generate", "a weave pattern", str(tmp_path / "ref.npy"), *flags]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    for out in ("out.npy", "out.png"):
        assert main(["generate", "a weave pattern", str(tmp_path / out), *flags,
                     "--device", "cpu", "--checkpoint-dir", str(tmp_path / "none")]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split(" (")[1].split(",")[:3] == ref_line.split(" (")[1].split(",")[:3]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), np.load(tmp_path / "ref.npy"))
    with Image.open(tmp_path / "ref.png") as im:
        np.testing.assert_array_equal(load_image(str(tmp_path / "out.png")),
                                      np.asarray(im, np.float32))


@pytest.mark.parametrize("kind", ["render", "mosaic"])
def test_bench_input_is_the_reference_array(kind, ref_bench, tmp_path, monkeypatch):
    monkeypatch.setenv("SRS_BENCH_INPUT", kind)
    ref_bench.make_input(str(tmp_path / "ref.png"))
    bench.make_input(str(tmp_path / "out.png"))
    got = load_image(str(tmp_path / "out.png"))
    with Image.open(tmp_path / "ref.png") as im:
        want = np.asarray(im, np.float32)
    assert got.shape == want.shape == (720, 1280, 3)
    np.testing.assert_array_equal(got, want)


def _small_input(path):
    img = np.random.default_rng(4).uniform(0, 255, (48, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(path)


def test_bench_line_has_the_reference_keys(ref_bench, tmp_path, monkeypatch, capsys):
    """One small run of each bench on the CPU with the same knobs: the
    port's line has exactly the reference's keys, and neither writes a
    log row."""
    from test_torch_tile_store import load_reference_native

    load_reference_native()
    log_before = os.path.getsize(os.path.join(REPO, "BENCH_LOCAL.md"))
    for k, v in {"SRS_BENCH_CPU_OK": "1", "SRS_BENCH_NO_LOG": "1", "SRS_BENCH_PER_SCALE": "0",
                 "SRS_BENCH_QMODEL": "edsr_m", "SRS_BENCH_BLOCK": "32"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    # every net untrained on both sides: the reference's packaged nets hidden
    packaged_in(monkeypatch, tmp_path / "none")
    real_cfg = jax_pipeline.PipelineConfig

    monkeypatch.setattr(jax_pipeline, "PipelineConfig",
                        lambda **kw: real_cfg(**{**kw, "target_resolution": "192x144"}))
    monkeypatch.setattr(ref_bench, "make_input", _small_input)
    monkeypatch.setenv("SRS_BENCH_DIR", str(tmp_path / "ref"))
    ref_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    real_port_cfg = bench.bench_config
    monkeypatch.setattr(bench, "bench_config", lambda device: dataclasses.replace(
        real_port_cfg(device), target_resolution="192x144"))
    monkeypatch.setattr(bench, "make_input", _small_input)
    monkeypatch.setenv("SRS_BENCH_DIR", str(tmp_path / "port"))
    assert main(["bench"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert set(got) == set(want)
    for key in ("metric", "unit", "provider", "quality_model", "batch", "output_mp",
                "routed_model", "step_models"):
        assert got.get(key) == want.get(key), key
    assert set(got["stage_times"]) == set(want["stage_times"])
    assert {"mfu_pct", "fullres_niqe", "input_niqe", "value_compute_bound"} <= set(got)
    assert got["value"] > 0 and got["chip_kind"] == chip_peak_flops()[1]
    assert os.path.getsize(os.path.join(REPO, "BENCH_LOCAL.md")) == log_before
    assert not os.path.exists(tmp_path / "home" / ".cache" / "srs_tpu_torch")


def test_bench_logs_outside_the_repository(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("SRS_BENCH_NO_LOG", "0")
    monkeypatch.setenv("SRS_BENCH_QA", "0")
    before = os.path.getsize(os.path.join(REPO, "BENCH_LOCAL.md"))
    path = bench.log_row({"metric": "m", "value": 1.0})
    assert path == str(tmp_path / ".cache" / "srs_tpu_torch" / "BENCH_LOCAL.md")
    with open(path) as f:
        row = f.read()
    assert "[SRS_BENCH_QA=0]" in row and '{"metric": "m", "value": 1.0}' in row
    assert os.path.getsize(os.path.join(REPO, "BENCH_LOCAL.md")) == before
    monkeypatch.setenv("SRS_BENCH_NO_LOG", "1")
    assert bench.log_row({"metric": "m"}) is None


def test_bench_needs_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SRS_BENCH_CPU_OK", raising=False)
    assert main(["bench"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("args", [["warmup", "--source", "64x48", "--target", "128x96"],
                                  ["generate", "a weave pattern", "o.png", "--size", "64x64"],
                                  ["process", "in.png", "o.tiff", "--profile", "trace"]])
def test_subcommands_need_the_card_unless_asked_for_the_cpu(args, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert not os.listdir(tmp_path)
