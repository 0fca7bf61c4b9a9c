"""Port parity: the full-width drivers (``srs_tpu_torch/drivers/``
``proof_200mp``, ``quality_bench`` and ``photo_eval.load_panel``) against
the reference's scripts under ``scripts/``, loaded with importlib.

- The TIFF header: both readers give the same (width, height, bits,
  strips) on the port's deflated and uncompressed 16-bit files. The
  reference's condition (file size >= the raw pixel bytes) is false on the
  deflated one and the port's strip check true; both are true on the raw
  one; a truncated file fails the port's check.
- The proof: ``main`` on a small input to a custom target that runs the
  [3, 4] ladder, 16-bit, QA on, against the reference pipeline with the
  proof's configuration on the same input (every net untrained on both
  sides: the reference's packaged checkpoints hidden, so every net is
  exact bicubic with IBP whatever its size; the reference's QA, routing
  and selection off and edsr_m for edsr_xl, none of which changes a pixel
  of an untrained ladder, to save its compiles): the TIFFs within 16 in
  16-bit units (1 measured; one 8-bit LSB is 257).
- ``quality_bench``: ``main`` at ``--n 1 --size 192 --no-photo`` with the
  packaged espcn x2 the only trained net (converted for the port), so
  ``fast`` serves it and zssr tunes it (three steps): the bicubic and
  fast rows within 0.05 dB of the reference pipeline's on the same input
  (bfloat16 nets; zssr's tuning is held in tests/test_torch_zssr.py, and
  the card runs all seven rows).
- ``load_panel``: the same four 420x504 crops as the reference's; a
  missing package raises ``PhotoDataMissing`` naming it.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import srs_tpu.models.registry as jax_registry
from srs_tpu.pipeline import PipelineConfig as JaxConfig, SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.drivers import photo_eval, proof_200mp, quality_bench
from srs_tpu_torch.io.native import read_tiff, write_tiff
from srs_tpu_torch.models import photo_data
from srs_tpu_torch.models.photo_data import PhotoDataMissing
from srs_tpu_torch.models.train import save_checkpoint
from test_torch_providers import converted
from test_torch_tile_store import load_reference_native
from torch_driver_helpers import (ReferenceGuard, load_script, one_torch_thread,  # noqa: F401
                                  reference_checkpoints_in)

GUARD = ReferenceGuard()
QBENCH_DB = 0.05  # bfloat16 nets on both sides
# The proof's 16-bit TIFFs against the reference pipeline's: far below one
# 8-bit LSB (257 units), so a port that wrote 8-bit pixels scaled to 16
# bits would fail.
PROOF_UNITS = 16


def test_guard_snapshot():
    GUARD.snapshot()


def _smooth16(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 65535
    return img.astype(np.uint16)


@pytest.mark.parametrize("compress", [True, False], ids=["deflate", "raw"])
def test_header_matches_reference_and_checks_the_file(tmp_path, compress):
    ref = load_script("proof_200mp")
    path = str(tmp_path / "x.tiff")
    h, w = 1200, 300  # three strips of (1 << 20) // (w * 6) rows
    write_tiff(path, _smooth16(h, w), bit_depth=16, compress=compress)
    assert proof_200mp.tiff_header_info(path) == ref.tiff_header_info(path) == (w, h, 16, 3)
    size = os.path.getsize(path)
    tags = proof_200mp.tiff_header_tags(path)
    ref_ok = bool(w > 0 and h > 0 and size >= w * h * 3 * 2)  # proof_200mp.py:104
    assert tags["compression"] == (8 if compress else 1)
    assert proof_200mp.header_ok(tags, size, 16)
    assert ref_ok is not compress  # the reference's check fails on a deflated file
    np.testing.assert_array_equal(read_tiff(path), _smooth16(h, w))


def test_header_check_fails_on_a_truncated_deflated_file(tmp_path):
    path = str(tmp_path / "x.tiff")
    write_tiff(path, _smooth16(1200, 300), bit_depth=16, compress=True)
    tags = proof_200mp.tiff_header_tags(path)
    last = tags["strip_offsets"][-1] + tags["strip_byte_counts"][-1]
    assert proof_200mp.header_ok(tags, last, 16)
    assert not proof_200mp.header_ok(tags, last - 1, 16)
    assert not proof_200mp.header_ok({**tags, "strip_offsets": tags["strip_offsets"][:-1],
                                      "strip_byte_counts": tags["strip_byte_counts"][:-1]},
                                     last, 16)


@pytest.fixture
def small_scene(monkeypatch):
    """The proof's 768-px scene rendered at 96 px on both sides (the render
    itself is held in tests/test_torch_corpus.py)."""
    import srs_tpu_torch.models.corpus as corpus

    real = corpus.render_photo
    monkeypatch.setattr(corpus, "render_photo", lambda seed, size: real(seed, 96))


def test_proof_input_is_the_references(small_scene):
    import cv2

    from srs_tpu.models.corpus import render_photo

    want = cv2.resize(render_photo(42, 96), (128, 72), interpolation=cv2.INTER_AREA)
    got = proof_200mp.proof_input(128, 72)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.uint8)).max() <= 1


def test_proof_main_matches_reference_on_the_3_4_ladder(tmp_path, monkeypatch, capsys,
                                                       small_scene):
    """The proof at a custom target on a 32x18 input: 13x, ladder [3, 4]."""
    load_reference_native()
    reference_checkpoints_in(monkeypatch, tmp_path / "none")
    report = proof_200mp.main(["--device", "cpu", "--source", "32x18", "--target", "416x234",
                               "--block-size", "32", "--out", str(tmp_path / "port"),
                               "--checkpoint-dir", str(tmp_path / "none")])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "PROOF OK" and json.loads(out[-2])["header_ok"]
    assert report["ladder"] == [3, 4] and report["sr_attempts"] == 1
    assert report["sr_degradations"] == 0
    assert (report["width"], report["height"], report["bits_tag"]) == (416, 234, 16)
    assert report["compression"] == 8 and report["quality_score"] is not None
    got = read_tiff(report["output"])
    assert got.dtype == np.uint16 and got.shape == (234, 416, 3)
    ref_mod = load_script("proof_200mp")
    assert ref_mod.tiff_header_info(report["output"]) == (416, 234, 16, report["strip_count"])

    # untrained, every net is exact bicubic with IBP: edsr_m stands in for
    # edsr_xl (smaller programs to compile), routing and selection serve
    # the same untrained net either way
    jpipe = JaxPipeline(JaxConfig(target_resolution="416x234", bit_depth=16, enable_qa=False,
                                  block_size=32, quality_model="edsr_m", auto_route=False,
                                  per_scale_selection=False))
    res = jpipe.process(os.path.join(tmp_path, "port", "in.png"), str(tmp_path / "ref.tiff"))
    assert res.success, res.error_message
    assert jpipe.last_run_info["ladder"] == [3, 4]
    want = read_tiff(str(tmp_path / "ref.tiff"))
    assert want.dtype == np.uint16
    units = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    assert units <= PROOF_UNITS, units


def test_quality_bench_matches_reference(tmp_path, monkeypatch):
    """``main`` against the reference's rows (quality_bench.py:76-108) for
    bicubic and fast, each a pipeline of the reference with the same
    configuration on the same input; the packaged espcn x2 is the only
    trained net on both sides (converted for the port), so ``fast`` serves
    it and zssr tunes it from the same patches."""
    import cv2

    from srs_tpu.models.corpus import render_image

    packaged = jax_registry.PACKAGED_CHECKPOINT_DIR
    (tmp_path / "ref").mkdir()
    os.symlink(os.path.join(packaged, "espcn_x2"), tmp_path / "ref" / "espcn_x2")
    reference_checkpoints_in(monkeypatch, tmp_path / "ref")
    save_checkpoint(converted("espcn", 2), "espcn", 2, str(tmp_path / "port"))
    # three of the seven rows, zssr at 3 steps (each row is the same loop;
    # the card runs all seven at full length)
    monkeypatch.setattr(quality_bench, "PROVIDERS", [("bicubic", {}), ("fast", {}),
                                                     ("zssr", {"zssr_steps": 3})])
    got = quality_bench.main(["--cpu", "--n", "1", "--size", "192", "--no-photo",
                              "--checkpoint-dir", str(tmp_path / "port")])
    assert [r["provider"] for r in got] == ["bicubic", "fast", "zssr"]
    assert all(r["n"] == 1 and r["hr"] == 192 and np.isfinite(r["psnr_min"]) for r in got)
    hr = render_image(880_000, 192)
    lr = cv2.resize(hr, (96, 96), interpolation=cv2.INTER_AREA)
    rows = {r["provider"]: r for r in got}
    for prov, extra in (("bicubic", {}), ("fast", {})):
        res = JaxPipeline(JaxConfig(block_size=128, target_resolution="192x192", provider=prov,
                                    enable_qa=False, **extra)).process(
            lr, str(tmp_path / f"{prov}.png"))
        assert res.success, res.error_message
        want = _psnr(Image.open(tmp_path / f"{prov}.png"), hr)
        assert abs(rows[prov]["psnr_mean"] - want) <= QBENCH_DB, (prov, rows[prov], want)
    # the trained fast net is not bicubic, and zssr tuned it
    assert abs(rows["fast"]["psnr_mean"] - rows["bicubic"]["psnr_mean"]) > 0.05
    assert rows["zssr"]["psnr_mean"] != rows["fast"]["psnr_mean"]


def _psnr(img, hr):
    mse = np.mean((np.asarray(img, np.float64) - hr) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_load_panel_is_the_references():
    want = load_script("photo_eval").load_panel()
    got = photo_eval.load_panel()
    assert [t for t, _ in got] == [t for t, _ in want] == ["portrait", "flower", "wood",
                                                           "darkwood"]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == (420, 504, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert [t for t, _ in photo_eval.load_panel(["wood", "portrait"])] == ["portrait", "wood"]


@pytest.mark.parametrize("gone", ["matplotlib", "PIL", "sklearn", "gymnasium_robotics"])
def test_panel_without_its_packages_raises_the_named_error(monkeypatch, gone):
    real = photo_data._package_dir
    monkeypatch.setattr(photo_data, "_package_dir", lambda pkg: None if pkg == gone else real(pkg))
    with pytest.raises(PhotoDataMissing, match=gone):
        photo_eval.load_panel()
    if gone in ("matplotlib", "PIL"):  # the portrait: quality_bench's photo row
        with pytest.raises(PhotoDataMissing, match=gone):
            quality_bench.main(["--cpu", "--n", "0", "--size", "64"])


def test_training_photos_missing_raise_the_named_error(monkeypatch):
    monkeypatch.setattr(photo_data, "_package_dir", lambda pkg: None)
    with pytest.raises(PhotoDataMissing, match="gymnasium_robotics, pygame, sklearn"):
        photo_data.require_photo_paths()


def test_guard_reference_unchanged():
    GUARD.check()
