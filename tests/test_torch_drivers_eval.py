"""Port parity: the evaluation drivers (``srs_tpu_torch/drivers/``
``photo_eval``, ``reeval``, ``routed_panel``, ``cond_panel``,
``eval_ark``, ``gen_quality``) against the reference's scripts under
``scripts/``, loaded with importlib, on the same weights: the reference's
packaged checkpoints, converted with ``convert_flax_params`` into a
checkpoint directory in ``tmp_path`` for the port. Nets run in bfloat16
on both sides, so PSNRs are held within 0.05 dB; bicubic and other
float32 numbers within 1e-3 dB.

- ``photo_eval``: the bicubic and net rows on the portrait.
- ``reeval``: the converted espcn x2 scores what the reference's
  ``eval_on_holdout`` gives the packaged one.
- ``routed_panel``: the routed default, every net untrained on both sides
  (the packaged checkpoints hidden): the same served provider and nets,
  PSNR within 0.05 dB.
- ``cond_panel``: the rows with the packaged conditioned polish.
- ``routed_panel`` and ``cond_panel`` run on a 96x120 crop of the
  portrait on both sides (their loops over the panel are the same for
  every image; ``load_panel`` itself is held in
  tests/test_torch_drivers_proof.py).
- ``eval_ark``: ``features`` equal to the reference's; ``main`` on a
  generator the port trains here (sampling draws differ, so the
  accuracy is held by its range) writes the reference's fields; without
  a generator it refuses.
- ``gen_quality``: ``niqe_of`` within relative 2e-2 (the NIQE tolerance)
  of the reference's on the same crops; ``main`` writes the reference's
  keys.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import srs_tpu.models.registry as jax_registry
from srs_tpu_torch.drivers import (cond_panel, eval_ark, gen_quality, photo_eval, reeval,
                                   routed_panel, train_ark)
from srs_tpu_torch.models.train import save_checkpoint
from test_torch_providers import converted
from torch_packaged import port_store_in
from torch_driver_helpers import (ReferenceGuard, load_script, one_torch_thread,  # noqa: F401
                                  reference_checkpoints_in)

GUARD = ReferenceGuard()


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_guard_snapshot():
    GUARD.snapshot()


def test_photo_eval_matches_reference(tmp_path, monkeypatch, capsys):
    args = ["--models", "espcn", "--images", "portrait"]
    monkeypatch.setattr("sys.argv", ["photo_eval.py", "--cpu", *args])
    load_script("photo_eval").main()
    want = _json_lines(capsys.readouterr().out)
    ck = str(tmp_path / "ck")
    save_checkpoint(converted("espcn", 2), "espcn", 2, ck)
    got = photo_eval.main(["--cpu", *args, "--checkpoint-dir", ck])
    assert [r["model"] for r in got] == [r["model"] for r in want] == ["bicubic", "espcn"]
    bg, bw = got[0]["per_image"]["portrait"], want[0]["per_image"]["portrait"]
    assert abs(bg["psnr"] - bw["psnr"]) <= 1e-3
    for g, w in zip(got[1:], want[1:]):
        assert g["trained"] and w["trained"]
        assert abs(g["per_image"]["portrait"]["psnr"] - w["per_image"]["portrait"]["psnr"]) \
            <= 0.05, g["model"]
        assert set(g) == set(w)


def test_reeval_matches_reference(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from srs_tpu.models.train import eval_on_holdout as jax_eval

    # the port's store hidden: reeval scores every trained net, the stored
    # ones too, as the reference's scores its packaged ones
    port_store_in(monkeypatch, tmp_path / "none")
    save_checkpoint(converted("espcn", 2), "espcn", 2, str(tmp_path))
    got = reeval.main(["--cpu", str(tmp_path)])
    assert list(got) == ["espcn_x2"]
    module, params = jax_registry.build_model("espcn", 2, dtype=jnp.bfloat16)
    want = jax_eval(module, params, 2, n=12, size=256)
    for k, tol in (("psnr_bicubic", 1e-3), ("psnr_bicubic_ibp", 1e-3), ("psnr_net", 0.05),
                   ("psnr_net_ibp", 0.05)):
        assert abs(got["espcn_x2"][k] - want[k]) <= tol, k
    with open(tmp_path / "EVAL.json") as f:
        assert json.load(f)["espcn_x2"] == got["espcn_x2"]
    assert reeval.main(["--cpu", "--only", "rcan_x2", str(tmp_path)]) == {}


def _one_image_panel(monkeypatch, ref, loader):
    """Both sides' panel cut to the portrait's central 96x120: the drivers'
    loops over the panel are the same for every image."""
    panel = [(tag, hr[162:258, 192:312].copy()) for tag, hr in photo_eval.load_panel(
        ["portrait"])]
    monkeypatch.setattr(photo_eval, "load_panel", lambda names=None: panel)
    monkeypatch.setattr(ref, loader, lambda: SimpleNamespace(
        load_panel=lambda names=None: panel, psnr=load_script("photo_eval").psnr)
        if loader == "_photo_eval" else panel)


def test_routed_panel_matches_reference(tmp_path, monkeypatch, capsys):
    reference_checkpoints_in(monkeypatch, tmp_path / "none")
    ref = load_script("routed_panel")
    _one_image_panel(monkeypatch, ref, "_photo_eval")
    # the reference writes its PNGs to a fixed /tmp path: send them to tmp_path
    real_join = os.path.join
    monkeypatch.setattr(ref, "os", SimpleNamespace(path=SimpleNamespace(
        join=lambda a, *b: real_join(str(tmp_path), *b) if a == "/tmp" else real_join(a, *b),
        dirname=os.path.dirname, abspath=os.path.abspath)))
    monkeypatch.setattr("sys.argv", ["routed_panel.py", "--cpu", "--routes", "bicubic",
                                     "--no-write"])
    ref_rc = ref.main()
    want = [r for r in _json_lines(capsys.readouterr().out) if "image" in r]
    got = routed_panel.main(["--cpu", "--routes", "bicubic", "--no-write",
                             "--checkpoint-dir", str(tmp_path / "none")])
    rows = got["routed_panel"]["rows"]
    assert [r["image"] for r in rows] == [r["image"] for r in want]
    for g, w in zip(rows, want):
        assert (g["provider"], g["models"]) == (w["provider"], w["models"]), g["image"]
        assert abs(g["psnr"] - w["psnr"]) <= 0.05 and abs(g["delta"] - w["delta"]) <= 0.05
    assert got["ok"] == (ref_rc == 0)
    assert not os.path.exists(tmp_path / "none" / "EVAL.json")


def test_cond_panel_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["cond_panel.py", "--cpu", "--no-write"])
    ref = load_script("cond_panel")
    _one_image_panel(monkeypatch, ref, "_load_panel")
    assert ref.main() == 0
    lines = _json_lines(capsys.readouterr().out)
    want_rows, want_summary = lines[:-1], lines[-1]
    assert cond_panel.main(["--cpu", "--no-write", "--checkpoint-dir",
                            str(tmp_path)]) == {"ok": False}
    save_checkpoint(converted("cond_polish", 1), "cond_polish", 1, str(tmp_path))
    got = cond_panel.main(["--cpu", "--checkpoint-dir", str(tmp_path)])
    assert got["ok"] and [r["image"] for r in got["rows"]] == [r["image"] for r in want_rows]
    for g, w in zip(got["rows"], want_rows):
        assert abs(g["distorted"] - w["distorted"]) <= 1e-3, g["image"]
        for k in ("conditioned", "blind", "clean_passthrough"):
            assert abs(g[k] - w[k]) <= 0.05, (g["image"], k)
    assert got["summary"]["cond_beats_blind"] == want_summary["cond_beats_blind"]
    with open(tmp_path / "EVAL.json") as f:
        assert json.load(f)["cond_polish_x1"]["cond_panel"] == got["summary"]


@pytest.fixture(scope="module")
def tiny_generator(tmp_path_factory):
    """A generator the port trains in seconds (base 8, depth 1, 16 px)."""
    d = str(tmp_path_factory.mktemp("ark"))
    train_ark.main(["--cpu", "--steps", "2", "--scan-chunk", "2", "--n-per-class", "1",
                    "--size", "16", "--base", "8", "--depth", "1", "--batch", "4",
                    "--dtype", "float32", "--out", d])
    return d


def test_eval_ark_features_and_main(tiny_generator, tmp_path):
    from srs_tpu.models.generative import render_class

    ref = load_script("eval_ark")
    for c in (0, 5):
        img = render_class(1000 + c, c, 32)
        np.testing.assert_array_equal(eval_ark.features(img), ref.features(img))
    assert eval_ark.main(["--cpu", "--checkpoint-dir", str(tmp_path)]) == {"ok": False}
    got = eval_ark.main(["--cpu", "--k", "2", "--real-n", "2", "--steps", "2",
                         "--checkpoint-dir", tiny_generator])
    assert got["ok"] and 0.0 <= got["class_accuracy"] <= 1.0 and got["eval_size"] == 16
    with open(os.path.join(tiny_generator, "EVAL.json")) as f:
        entry = json.load(f)["ark_gen_x1"]
    assert {"class_accuracy", "chance", "diversity_ratio_vs_real", "eval_k", "eval_steps",
            "eval_guidance", "eval_size"} <= set(entry)


def test_gen_quality_niqe_and_main(tiny_generator):
    ref = load_script("gen_quality")
    img = gen_quality.portrait()[:300, :400]
    got = gen_quality.niqe_of(img, 2, np.random.default_rng(11))
    want = ref.niqe_of(img, 2, np.random.default_rng(11))
    assert abs(got - want) <= 2e-2 * abs(want)
    out = gen_quality.main(["--cpu", "--prompts", "woven fabric texture", "--size", "48x48",
                            "--steps", "2", "--crops", "1", "--no-write",
                            "--checkpoint-dir", tiny_generator])
    assert set(out) == {"gen2k_niqe", "real_photo_niqe", "gen2k_prompts", "gen2k_crops"}
    assert out["real_photo_niqe"] is not None and out["gen2k_prompts"] == 1


def test_guard_reference_unchanged():
    GUARD.check()
