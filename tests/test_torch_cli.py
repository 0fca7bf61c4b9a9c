"""Port parity: the command line (``python -m srs_tpu_torch process``)
against the JAX package's pipeline, on the CPU.

Both sides serve an untrained ladder: no weights are handed to the port,
and the reference is pointed at an empty checkpoint directory (its
packaged checkpoints hidden for the test), so every net is the zero-tail
bicubic net and IBP runs on the last step, as on the card. The reference
writes a PNG (PIL), the port its TIFF; the pixels are compared.

Tolerance: the outputs differ by at most 1 LSB, on under 1% of samples
(float32 sums in another order flip rounding ties; the gradient-domain
blends integrate through two FFT libraries).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.cli import main
from srs_tpu_torch.io.image import save_image
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from torch_packaged import packaged_in

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLENDS = ["laplacian", "multi_band", "weighted", "feather", "gradient_domain", "poisson"]
# 48x64 -> 192x256 on an x4 ladder of 32-px tiles (a 3x2 grid)
FLAGS = ["--target", "256x192", "--block-size", "32", "--quality-model", "edsr_m",
         "--pin-quality-model", "--no-qa", "--device", "cpu"]


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 7), 127 + 90 * np.cos(yy / 5),
                    127 + 90 * np.sin((xx + yy) / 4)], -1)
    img[10:22, 30:52] = (240, 20, 40)  # a hard-edged salient block
    img = np.clip(img + rng.normal(0, 30, img.shape), 0, 255).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("cli") / "in.png")
    save_image(path, img)
    return path


def _reference(png, out, monkeypatch, tmp_path, blend, post=False):
    """The reference's output as int16, its nets untrained."""
    packaged_in(monkeypatch, tmp_path / "none")
    cfg = JaxConfig(block_size=32, target_resolution="256x192", quality_model="edsr_m",
                    per_scale_selection=False, enable_qa=False, blend_method=blend,
                    enable_seam_repair=post, enable_color_correction=post, content_aware=post)
    pipe = JaxPipeline(cfg)
    pipe._ensure_engine()
    # a directory of its own keys the registry's cache away from other tests
    pipe.sr_module.config.checkpoint_dir = str(tmp_path / "empty")
    res = pipe.process(png, out)
    assert res.success, res.error_message
    assert pipe.sr_module.trained_scales() == set()
    with Image.open(out) as im:
        return np.asarray(im).astype(np.int16), pipe


def _close(got, ref):
    assert got.shape == ref.shape == (192, 256, 3)
    diff = np.abs(got.astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("blend", BLENDS)
def test_process_matches_reference_for_every_blend(png, tmp_path, monkeypatch, blend, capsys):
    ref, jpipe = _reference(png, str(tmp_path / "ref.png"), monkeypatch, tmp_path, blend)
    out = str(tmp_path / "out.tiff")
    assert main(["process", png, out, "--blend", blend, *FLAGS]) == 0
    assert capsys.readouterr().out.startswith(f"OK {out} (")
    assert jpipe.last_run_info["ladder"] == [4]
    _close(read_tiff(out), ref)


def test_post_passes_match_reference(png, tmp_path, monkeypatch):
    """multi_band with seam repair, colour correction and content-aware
    seams, as the card's cli_path runs them."""
    ref, _ = _reference(png, str(tmp_path / "ref.png"), monkeypatch, tmp_path, "multi_band",
                        post=True)
    out = str(tmp_path / "out.tiff")
    assert main(["process", png, out, "--blend", "multi_band", "--seam-repair",
                 "--color-correction", "--content-aware", *FLAGS]) == 0
    _close(read_tiff(out), ref)
    plain = str(tmp_path / "plain.tiff")
    assert main(["process", png, plain, "--blend", "multi_band", *FLAGS]) == 0
    # the passes changed the output
    assert np.abs(read_tiff(plain).astype(np.int16) - ref).mean() > 1.0


def test_main_writes_what_process_writes(png, tmp_path):
    out = str(tmp_path / "cli.tiff")
    assert main(["process", png, out, "--steps", "3", "--seam-repair", *FLAGS]) == 0
    cfg = PipelineConfig(block_size=32, target_resolution="256x192", quality_model="edsr_m",
                         per_scale_selection=False, enable_qa=False, ibp_steps=3,
                         enable_seam_repair=True, device="cpu")
    res = SuperResolutionPipeline(cfg).process(png, str(tmp_path / "api.tiff"))
    assert res.success, res.error_message
    np.testing.assert_array_equal(read_tiff(out), read_tiff(res.output_path))


def test_png_output_and_qa_report(png, tmp_path, capsys):
    out = str(tmp_path / "out.png")
    flags = [f for f in FLAGS if f != "--no-qa"]
    assert main(["process", png, out, "--bit-depth", "16", *flags]) == 0
    printed = capsys.readouterr().out
    assert "quality score:" in printed and "  save:" in printed
    with Image.open(out) as im:
        assert im.size == (256, 192) and im.mode == "RGB"
    assert os.path.isfile(str(tmp_path / "out_qa_report.json"))


def test_mesh_flag_writes_what_the_run_without_it_writes(png, tmp_path, capsys):
    """``--mesh data=2,space=2`` on the CPU: the CPU repeated four times,
    the batch split over data and the blend over space (the 3x2 grid's
    two tile rows), within 1 LSB of the run without it on all but 1e-3 of
    samples."""
    out, plain = str(tmp_path / "mesh.tiff"), str(tmp_path / "plain.tiff")
    assert main(["process", png, out, *FLAGS, "--mesh", "data=2,space=2"]) == 0
    assert capsys.readouterr().out.startswith(f"OK {out} (")
    assert main(["process", png, plain, *FLAGS]) == 0
    got, ref = read_tiff(out).astype(np.int16), read_tiff(plain).astype(np.int16)
    diff = np.abs(got - ref)
    assert got.shape == (192, 256, 3)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("mesh", ["data=x", "data"])
def test_malformed_mesh_fails_as_the_reference_parser(png, tmp_path, mesh):
    out = str(tmp_path / "o.tiff")
    with pytest.raises(ValueError):
        main(["process", png, out, *FLAGS, "--mesh", mesh])
    assert not os.path.exists(out)


def test_profile_writes_a_trace(png, tmp_path, capsys):
    """``--profile DIR`` wraps the job in ``utils/profiling.device_trace``:
    the job's output as without it, and a torch.profiler trace in DIR."""
    trace_dir = tmp_path / "trace"
    out = str(tmp_path / "o.tiff")
    assert main(["process", png, out, *FLAGS, "--profile", str(trace_dir)]) == 0
    printed = capsys.readouterr().out
    assert f"profiler trace written to {trace_dir}" in printed and f"OK {out}" in printed
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(trace_dir / traces[0]) > 0
    plain = str(tmp_path / "plain.tiff")
    assert main(["process", png, plain, *FLAGS]) == 0
    np.testing.assert_array_equal(read_tiff(out), read_tiff(plain))


@pytest.mark.parametrize("args", [["--provider", "zssr", "--zssr-steps", "2"],
                                  ["--zssr-steps", "10"]])
def test_zssr_flags_run(tmp_path, capsys, args):
    """``--provider zssr`` tunes the net on the input (its 48-px patches need
    a 96-px input at x2) and serves it; ``--zssr-steps`` without it changes
    nothing (the quality path), as in the reference."""
    rng = np.random.default_rng(12)
    png = str(tmp_path / "in.png")
    save_image(png, rng.integers(0, 256, (96, 112, 3)).astype(np.uint8))
    flags = ["--target", "224x192", "--block-size", "64", "--quality-model", "edsr_m",
             "--pin-quality-model", "--no-qa", "--device", "cpu",
             "--checkpoint-dir", str(tmp_path / "none")]
    out = str(tmp_path / "o.tiff")
    assert main(["process", png, out, *flags, *args]) == 0
    assert "OK" in capsys.readouterr().out and read_tiff(out).shape == (192, 224, 3)
    if "--provider" not in args:
        plain = str(tmp_path / "plain.tiff")
        assert main(["process", png, plain, *flags]) == 0
        np.testing.assert_array_equal(read_tiff(out), read_tiff(plain))


def test_failure_exits_one(tmp_path, capsys):
    assert main(["process", str(tmp_path / "missing.png"), str(tmp_path / "o.tiff"),
                 *FLAGS]) == 1
    assert capsys.readouterr().err.startswith("FAILED:")


def test_python_dash_m_runs_in_a_subprocess(png, tmp_path):
    out = str(tmp_path / "sub.tiff")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "srs_tpu_torch", "process", png, out, "--steps", "2", *FLAGS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"OK {out}")
    assert read_tiff(out).shape == (192, 256, 3)
