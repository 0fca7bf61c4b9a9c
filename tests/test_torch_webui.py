"""Port parity: the web UI's headless logic (``srs_tpu_torch/webui``) and
``utils/logging.py`` against ``srs_tpu.webui`` and ``srs_tpu.utils.
logging``, on the CPU; modelled on tests/test_webui_cli.py. Neither side
needs Streamlit.

Tolerances: the session, the estimates (for the same ``mp_per_sec``,
without the self-ensemble, whose factor is the card's own), the crop
presets and the image metadata equal; exports decoded within 1 LSB of
the reference's export of the same file at the export's bit depth; the
worker's TIFF within 1 LSB of the reference worker's.
"""

import io
import json
import logging
import sys

import numpy as np
import pytest
from PIL import Image

from srs_tpu.utils import logging as jax_logging
from srs_tpu.webui import estimator as jax_estimator
from srs_tpu.webui import session as jax_session
from srs_tpu.webui.pages import monitor_page as jax_monitor
from srs_tpu.webui.pages import result_page as jax_result
from srs_tpu.webui.pages import upload_page as jax_upload
from srs_tpu_torch.cli import main as cli_main
from srs_tpu_torch.io.image import decode_png
from srs_tpu_torch.io.native import read_tiff, write_tiff
from srs_tpu_torch.utils.logging import setup_logging
from srs_tpu_torch.utils.paths import CHECKOUT_DIR
from srs_tpu_torch.webui import estimator, session
from srs_tpu_torch.webui.pages import monitor_page, result_page, upload_page
from test_torch_tile_store import load_reference_native


@pytest.fixture(autouse=True)
def fresh_state():
    """Each case starts from default sessions and an idle worker."""
    for mod in (session, jax_session):
        mod._fallback_state.clear()
        mod.reset_session_state()
    monitor_page._worker = None
    monitor_page._log_buffer.clear()
    yield
    if monitor_page._worker is not None:
        monitor_page._worker.join(timeout=60)
    monitor_page._worker = None
    monitor_page._log_buffer.clear()
    for mod in (session, jax_session):
        mod._fallback_state.clear()


def test_session_roundtrip_matches_reference():
    assert session.DEFAULT_SESSION_STATE == jax_session.DEFAULT_SESSION_STATE
    for mod in (session, jax_session):
        mod.initialize_session_state()
        assert mod.get_state("tile_size") == 1024
        mod.set_state("tile_size", 2048)
        mod.set_state("model_version", "fast")
    assert session.get_config_summary() == jax_session.get_config_summary()
    assert session._fallback_state == jax_session._fallback_state
    for mod in (session, jax_session):
        mod.reset_session_state()
    assert session.get_state("tile_size") == jax_session.get_state("tile_size") == 1024
    assert session.get_state("missing", 7) == jax_session.get_state("missing", 7) == 7


@pytest.mark.parametrize("w,h,target,tile,overlap,chips", [
    (1280, 720, 100_000_000, 1024, 0.2, 1),
    (1280, 720, 100_000_000, 1024, 0.2, 8),
    (720, 1280, 150_000_000, 512, 0.1, 1),
    (3840, 2160, 200_000_000, 2048, 0.3, 4),
    (640, 480, 4_000_000, 4096, 0.25, 2),
])
def test_estimates_match_reference(w, h, target, tile, overlap, chips):
    kw = dict(mp_per_sec=7.5, num_chips=chips)
    got = estimator.calculate_estimates(w, h, target, tile, overlap, **kw)
    assert got == jax_estimator.calculate_estimates(w, h, target, tile, overlap, **kw)
    ens = estimator.calculate_estimates(w, h, target, tile, overlap, self_ensemble=True, **kw)
    assert ens["estimated_seconds"] == pytest.approx(
        got["estimated_seconds"] * estimator.SELF_ENSEMBLE_FACTOR)
    default = estimator.calculate_estimates(w, h, target, tile, overlap)
    assert default["estimated_chip_seconds"] == pytest.approx(
        target / 1e6 / estimator.DEFAULT_MP_PER_SEC)


@pytest.mark.parametrize("w,h", [(1280, 720), (720, 1280), (100, 100), (7, 3)])
def test_crop_presets_match_reference(w, h):
    assert upload_page.crop_presets(w, h) == jax_upload.crop_presets(w, h)


def test_image_info_matches_reference():
    img = Image.new("RGB", (100, 50))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    png = Image.open(io.BytesIO(buf.getvalue()))
    for im in (img, png):
        assert upload_page.extract_image_info(im, "a.png", 1234) == \
            jax_upload.extract_image_info(im, "a.png", 1234)
    arr = upload_page.extract_image_info(np.zeros((50, 100, 3), np.uint8), "a.png", 1234)
    ref = jax_upload.extract_image_info(img, "a.png", 1234)
    assert arr == {**ref, "format": None}
    assert upload_page.extract_image_info(np.zeros((5, 4), np.float32))["mode"] == "L"


def _source(tmp_path, kind):
    img = (np.random.default_rng(1).random((40, 60, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / f"res.{kind}")
    if kind == "png":
        Image.fromarray(img).save(path)
    else:
        write_tiff(path, img)
    return path


def _decode(data, name):
    if name.endswith(".tiff"):
        buf = name + ".bin"
        with open(buf, "wb") as f:
            f.write(data)
        return read_tiff(buf)
    return decode_png(data)


@pytest.mark.parametrize("src", ["png", "tiff"])
@pytest.mark.parametrize("fmt,bits", [("tiff", 8), ("tiff", 16), ("png", 8)])
@pytest.mark.parametrize("space", ["sRGB", "AdobeRGB"])
def test_build_export_matches_reference(tmp_path, src, fmt, bits, space):
    load_reference_native()
    path = _source(tmp_path, src)
    got, name = result_page.build_export(path, fmt, space, bits)
    want, ref_name = jax_result.build_export(path, fmt, space, bits)
    assert name == ref_name
    a = _decode(got, str(tmp_path / ("got_" + name))).astype(np.int32)
    b = _decode(want, str(tmp_path / ("ref_" + name))).astype(np.int32)
    assert a.shape == b.shape == (40, 60, 3)
    assert a.dtype == b.dtype
    assert np.abs(a - b).max() <= 1


def test_jpeg_export_needs_pil(tmp_path, monkeypatch):
    path = _source(tmp_path, "png")
    data, name = result_page.build_export(path, "jpeg", "sRGB", 8, quality=80)
    assert name == "res.jpg" and data == jax_result.build_export(path, "jpeg", "sRGB", 8, 80)[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs PIL"):
        result_page.build_export(path, "jpeg", "sRGB", 8)


def _worker_state(mod):
    return {k: v for k, v in mod._fallback_state.items()}


def test_run_pipeline_matches_reference(tmp_path):
    """The worker's job (bicubic, 80x60 -> 160x120, tile 64, QA on) on both
    sides: its TIFF within 1 LSB, the same state keys and report keys."""
    load_reference_native()
    img = (np.random.default_rng(0).random((60, 80, 3)) * 255).astype(np.uint8)
    cfg = {"tile_size": 64, "overlap_ratio": 0.2, "target_resolution": "160x120",
           "model_version": "bicubic", "fusion_algorithm": "laplacian"}
    jax_monitor._run_pipeline(img, {**cfg, "output_path": str(tmp_path / "ref.tiff")})
    monitor_page._run_pipeline(img, {**cfg, "output_path": str(tmp_path / "got.tiff"),
                                     "device": "cpu"})
    ref, got = _worker_state(jax_session), _worker_state(session)
    assert got["current_stage"] == ref["current_stage"] == "done"
    assert set(got) == set(ref)
    assert got["progress"] == ref["progress"] == 1.0 and got["processing"] is False
    assert set(got["qa_report"]) >= {"psnr", "ssim", "overall_score"}
    assert set(got["qa_report"]) == set(ref["qa_report"])
    a, b = read_tiff(got["result_path"]).astype(np.int16), read_tiff(ref["result_path"])
    assert a.shape == b.shape == (120, 160, 3)
    assert np.abs(a - b).max() <= 1


def test_start_worker_logs_and_records_failures(tmp_path):
    img = np.full((60, 80, 3), 128, np.uint8)
    cfg = {"tile_size": 64, "overlap_ratio": 0.2, "target_resolution": "160x120",
           "model_version": "bicubic", "fusion_algorithm": "laplacian", "device": "cpu",
           "output_path": str(tmp_path / "o.tiff")}
    monitor_page.start_worker(img, cfg)
    monitor_page._worker.join(timeout=120)
    assert session.get_state("current_stage") == "done"
    assert any("Stage 1" in msg for _, _, msg in monitor_page._log_buffer)
    monitor_page.start_worker(img, {**cfg, "model_version": "no_such"})
    monitor_page._worker.join(timeout=60)
    assert session.get_state("current_stage").startswith("failed: ")
    assert session.get_state("processing") is False
    handlers = logging.getLogger("srs_tpu_torch.pipeline").handlers
    assert sum(isinstance(h, monitor_page._BufferHandler) for h in handlers) == 1


def test_cancel_stops_the_worker_at_a_stage_boundary(tmp_path, monkeypatch):
    from srs_tpu_torch.pipeline import SuperResolutionPipeline

    orig = SuperResolutionPipeline._upscale_batch

    def cancel_during_sr(self, *args, **kwargs):
        monitor_page.cancel()
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(SuperResolutionPipeline, "_upscale_batch", cancel_during_sr)
    cfg = {"tile_size": 64, "overlap_ratio": 0.2, "target_resolution": "160x120",
           "model_version": "bicubic", "fusion_algorithm": "laplacian", "device": "cpu",
           "output_path": str(tmp_path / "o.tiff")}
    monitor_page._run_pipeline(np.zeros((60, 80, 3), np.uint8), cfg)
    stage = session.get_state("current_stage")
    assert stage.startswith("failed: ") and "cancelled" in stage
    assert session.get_state("cancelled") is True


def test_setup_logging_matches_reference(tmp_path):
    got_log, ref_log = tmp_path / "got.log", tmp_path / "ref.log"
    loggers = []
    try:
        for setup, name, path in ((setup_logging, "srs_tpu_torch", got_log),
                                  (jax_logging.setup_logging, "srs_tpu", ref_log)):
            root = setup(log_file=str(path), stream=False)
            loggers.append(root)
            assert root.name == name and root.level == logging.INFO
            logging.getLogger(f"{name}.pipeline").info("stage %d", 1)
            logging.getLogger(f"{name}.pipeline").debug("hidden")
    finally:
        for root in loggers:
            for h in list(root.handlers):
                root.removeHandler(h)
                h.close()
            root.setLevel(logging.NOTSET)
    got, ref = got_log.read_text().splitlines(), ref_log.read_text().splitlines()
    assert len(got) == len(ref) == 1
    assert got[0].split(" - ", 1)[1] == ref[0].split(" - ", 1)[1].replace("srs_tpu.",
                                                                            "srs_tpu_torch.")


def test_webui_subcommand_needs_streamlit(capsys, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "streamlit" else real(name, *a))
    assert cli_main(["webui", "--port", "8600"]) != 0
    assert "Streamlit" in capsys.readouterr().err


def test_webui_modules_import_without_streamlit_or_pil():
    import subprocess

    code = ("import sys; sys.modules['PIL'] = None; sys.modules['streamlit'] = None; "
            "import srs_tpu_torch.webui.app, srs_tpu_torch.webui.pages, "
            "srs_tpu_torch.webui.estimator, srs_tpu_torch.utils.logging; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=CHECKOUT_DIR)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert json.dumps(estimator.calculate_estimates(80, 60, 19200))  # plain floats
