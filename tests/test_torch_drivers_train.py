"""Port parity: the training drivers (``srs_tpu_torch/drivers/``
``pretrain``, ``train_polish``, ``train_cond``, ``train_lpips``,
``fit_fusion``, ``fit_qa_models``, ``train_ark``) against the reference's
scripts under ``scripts/``, loaded with importlib, every output path in
``tmp_path``. The port's draws come from ``torch.Generator`` and the
reference's from ``jax.random``, so trained weights are not compared;
what is deterministic is, and weights cross over through
``convert_flax_params``:

- ``pretrain``: both ``main``s on the packaged espcn x2 (each trainer
  stubbed to return it, converted for the port) give EVAL.json entries
  with the same keys, the held-out bicubic and bicubic+IBP PSNR within
  1e-3 dB and the net's within 0.05 dB (bfloat16 nets on both sides);
  ``--only`` with an unknown key exits non-zero on both;
  ``--skip-existing`` skips a committed net; the port's trainer runs
  three real steps and saves; a photo mix without the photo packages
  raises ``PhotoDataMissing``.
- ``train_polish`` and ``train_cond``: both ``main``s take two clipped
  SGD steps (``optax.adam`` and the port's Adam swapped for SGD, so a step
  is the clipped gradient) from the reference's initial net on the same
  batches (a corpus of one crop-sized image; the reference's producer and
  distortion draws handed to the port), every net in float32: the same
  update of every parameter (within 1e-4 of the largest) and the same
  held-out EVAL.json rows (within 1e-3 dB; the reference's held-out draws
  handed to the port). Each also trains, saves and reloads at a few
  steps; the FiLM layer trains; its out-of-place arm equals the serving
  path's in-place arm bit for bit; one FiLM step's loss and gradients
  equal the reference's on the same batch (float32, relative 1e-5 and
  1e-4 of the largest gradient).
- ``train_lpips``: ``build_pairs`` equal to the reference's,
  ``ranking_accuracy`` likewise; both ``main``s train alex for one chunk
  of clipped SGD steps on one triplet from the same initial features:
  the chunk's loss within relative 1e-4, the update within 1e-2 of the
  largest change, the EVAL.json entries equal; saved features reload
  through ``LPIPSMetric(params=...)``.
- ``fit_fusion``: ``crops_of`` equal; members' and fusion's fit-set PSNR
  within 0.05 dB of the reference's on the same (converted) nets and the
  same three photo crops.
- ``fit_qa_models``: ``distort`` equal at every kind and level,
  ``_sigma_field`` within relative 1e-5 (and 1e-4) where it is large and
  its mean within 1e-4, ``pristine_pool`` within relative 2e-2
  (the NIQE tolerance) on a cut-down pool; the fitted files keep the
  reference's keys.
- ``train_ark``: the checkpoint and ``ark_meta.json`` reload equal.

Every saved file reloads equal to the state the driver returned.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu_torch.drivers import (fit_fusion, fit_qa_models, pretrain, train_ark, train_cond,
                                   train_lpips, train_polish)
from srs_tpu_torch.models import photo_data
from srs_tpu_torch.models.photo_data import PhotoDataMissing
from srs_tpu_torch.models.registry import build_model, convert_flax_params
from srs_tpu_torch.models.train import save_checkpoint
from test_torch_providers import converted
from torch_driver_helpers import REPO, ReferenceGuard, load_script, one_torch_thread  # noqa: F401

GUARD = ReferenceGuard()


def test_guard_snapshot():
    GUARD.snapshot()


def _reloads_equal(path, state):
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert set(saved) == set(state)
    assert all(torch.equal(saved[k], state[k]) for k in state)


def _eval(d):
    with open(os.path.join(d, "EVAL.json")) as f:
        return json.load(f)


def test_pretrain_main_matches_reference(tmp_path, monkeypatch):
    """Both mains on the packaged espcn x2 (the trainer stubbed to return it:
    the reference's 50 compiled bf16 steps take minutes on the CPU): the
    same EVAL.json keys and held-out numbers."""
    import srs_tpu.utils.tpu_guard as tpu_guard
    import srs_tpu_torch.models.train as port_train
    from srs_tpu.models.corpus import make_corpus as jax_corpus
    from srs_tpu.models.registry import build_model as jax_build

    ref = load_script("pretrain")
    monkeypatch.setattr(tpu_guard, "require_tpu", lambda: None)
    # the reference's corpus cache is a fixed /tmp path: make it directly
    monkeypatch.setattr(ref, "load_corpus", lambda n, mix: jax_corpus(n, 64, seed=0, mix=mix))
    params = jax_build("espcn", 2)[1]
    monkeypatch.setattr(ref, "train_synthetic", lambda *a, **k: (params, 0.25))
    args = ["--only", "espcn_x2", "--steps", "50", "--corpus-n", "2", "--mix", "proc"]
    monkeypatch.setattr("sys.argv", ["pretrain.py", *args, str(tmp_path / "ref")])
    ref.main()
    want = _eval(tmp_path / "ref")["espcn_x2"]

    state = converted("espcn", 2)

    def stub(name, scale, checkpoint_dir=None, **_kw):
        save_checkpoint(state, name, scale, checkpoint_dir)
        return state, 0.25

    monkeypatch.setattr(port_train, "train_synthetic", stub)
    monkeypatch.setenv("HOME", str(tmp_path))
    got = pretrain.main([*args, "--device", "cpu", str(tmp_path / "port")])["eval"]["espcn_x2"]
    assert set(got) == set(want)
    for k in ("psnr_bicubic", "psnr_bicubic_ibp"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    for k in ("psnr_net", "psnr_net_ibp"):  # bf16 nets on both sides
        assert abs(got[k] - want[k]) <= 0.05, k
    for k in ("mix", "degradation", "final_loss"):
        assert got[k] == want[k], k
    assert _eval(tmp_path / "port")["espcn_x2"] == got

    # --skip-existing skips the committed net; an unknown key exits non-zero
    skipped = pretrain.main(["--only", "espcn_x2", "--skip-existing", "--mix", "proc",
                             "--corpus-n", "2", "--device", "cpu", str(tmp_path / "port")])
    assert skipped["eval"]["espcn_x2"] == got and skipped["states"] == {}
    with pytest.raises(SystemExit) as e:
        pretrain.main(["--only", "espcn_x9", "--device", "cpu", str(tmp_path)])
    monkeypatch.setattr("sys.argv", ["pretrain.py", "--only", "espcn_x9", "--corpus-n", "2",
                                     "--mix", "proc", str(tmp_path)])
    with pytest.raises(SystemExit) as e_ref:
        ref.main()
    assert e.value.code not in (0, None) and e_ref.value.code not in (0, None)


def test_pretrain_trains_and_saves(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    rep = pretrain.main(["--only", "espcn_x2", "--steps", "3", "--scan-chunk", "1",
                         "--corpus-n", "2", "--mix", "proc", "--device", "cpu", "--dtype",
                         "float32", str(tmp_path)])
    got = rep["eval"]["espcn_x2"]
    assert np.isfinite(got["final_loss"]) and got["psnr_net"] > 0
    _reloads_equal(os.path.join(tmp_path, "espcn_x2.pt"), rep["states"]["espcn_x2"])
    assert set(rep["states"]["espcn_x2"]) == set(converted("espcn", 2))
    # the corpus was cached under the home directory, not beside the checkout
    assert os.listdir(tmp_path / ".cache" / "srs_tpu_torch" / "corpus")


def test_photo_mixes_without_photos_raise_the_named_error(tmp_path, monkeypatch):
    monkeypatch.setattr(photo_data, "_package_dir", lambda pkg: None)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(PhotoDataMissing, match="sklearn"):
        pretrain.main(["--only", "espcn_x2", "--corpus-n", "2", "--device", "cpu",
                       str(tmp_path)])
    for main, args in ((train_polish.main, ["--cpu"]), (train_cond.main, ["--cpu"]),
                       (train_lpips.main, ["--cpu"]), (fit_fusion.main, ["--cpu"]),
                       (fit_qa_models.main, ["--device", "cpu", "--out", str(tmp_path)])):
        with pytest.raises(PhotoDataMissing):
            main(args)


def _small_corpora(monkeypatch):
    """The training corpus and held-out set made of two 64-px renders."""
    import srs_tpu_torch.models.corpus as corpus

    real = corpus.make_corpus
    monkeypatch.setattr(corpus, "make_corpus", lambda n, size=256, seed=0, mix="proc":
                        real(min(n, 2), 64, seed, mix))


def test_train_polish_trains_and_saves(tmp_path, monkeypatch):
    from srs_tpu_torch.models.registry import seeded_params

    monkeypatch.setenv("HOME", str(tmp_path))
    _small_corpora(monkeypatch)
    ck = str(tmp_path / "ck")
    save_checkpoint(seeded_params("espcn", 2, seed=1), "espcn", 2, ck)
    rep = train_polish.main(["--cpu", "--steps", "4", "--scan-chunk", "2", "--batch", "4",
                             "--patch", "24", "--mix", "proc", "--corpus-n", "4", "--out", ck])
    assert rep["steps_run"] == 4 and len(rep["chunk_losses"]) == 2
    assert np.isfinite(rep["chunk_losses"]).all()
    _reloads_equal(rep["path"], rep["state"])
    assert set(rep["eval"]) == {"holdout_sr", "holdout_polished", "sr_producer", "steps",
                                "train_seconds"}
    assert np.isfinite(rep["eval"]["holdout_polished"])


def _reference_takes_sgd_steps(monkeypatch, corpus):
    """A reference trainer script made to take plain steps: its corpus is
    ``corpus``, its compile cache is off, and ``optax.adam`` is
    ``optax.sgd(1.0)``, so each step moves the parameters by exactly the
    clipped gradient. Returns the dict its ``save_checkpoint`` fills with
    the trained parameters."""
    import importlib

    import optax

    import srs_tpu.models.train as jax_train
    import srs_tpu.utils.compile_cache as compile_cache

    scripts_pretrain = importlib.import_module("scripts.pretrain")
    monkeypatch.setattr(scripts_pretrain, "load_corpus", lambda *a, **k: corpus)
    monkeypatch.setattr(compile_cache, "enable_compilation_cache", lambda *a, **k: None)
    sgd = optax.sgd
    monkeypatch.setattr(optax, "adam", lambda lr, *a, **k: sgd(1.0))
    saved = {}
    monkeypatch.setattr(jax_train, "save_checkpoint",
                        lambda params, *a, **k: saved.update(params=params))
    return saved


def _port_takes_sgd_steps(monkeypatch, name, init_tree):
    """The port's trainers likewise: ``name`` starts from the reference's
    initial parameters, and the optimizer clips as before, then takes
    ``SGD(1.0)`` steps."""
    import srs_tpu_torch.models.registry as registry
    import srs_tpu_torch.models.train as port_train

    init = _converted_tree(init_tree)
    real_init, real_state = registry.init_params, port_train.init_train_state
    monkeypatch.setattr(registry, "init_params", lambda n, scale, seed=0:
                        init if n == name else real_init(n, scale, seed))

    def sgd_state(net, lr=2e-4):
        net, opt = real_state(net, lr)
        opt.adam = torch.optim.SGD(opt.params, lr=1.0)
        opt.schedule = lambda _count: 1.0
        return net, opt

    monkeypatch.setattr(port_train, "init_train_state", sgd_state)
    return init


def _float32_nets(monkeypatch):
    """Every net of both sides computes in float32 (the drivers' logic does
    not depend on the compute type, and bfloat16 rounds a producer's pixel
    near 255 by up to one level, far above what a parity check can see)."""
    import dataclasses
    import functools

    import srs_tpu.models.conditioning as jax_cond
    import srs_tpu.models.registry as jax_registry
    import srs_tpu_torch.models.registry as registry

    real_jax, real_port = jax_registry.build_model, registry.build_model
    monkeypatch.setattr(jax_registry, "build_model", lambda name, scale=2, **kw: real_jax(
        name, scale, **{**kw, "dtype": jnp.float32}))
    spec = jax_registry.MODEL_REGISTRY["espcn_polish"]
    monkeypatch.setitem(jax_registry.MODEL_REGISTRY, "espcn_polish", dataclasses.replace(
        spec, kwargs={**dict(spec.kwargs), "dtype": jnp.float32}))
    monkeypatch.setattr(jax_cond, "CondPolish",
                        functools.partial(jax_cond.CondPolish, dtype=jnp.float32))
    monkeypatch.setattr(registry, "build_model", lambda name, scale=2, params=None, **kw:
                        real_port(name, scale, params, **{**kw, "dtype": "float32"}))


def _converted_tree(tree, convert=convert_flax_params):
    return convert(jax.tree_util.tree_map(np.asarray, tree))


def _step_keys(seed, steps):
    """Each step's four keys, as the reference trainers split them."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return [jax.random.split(k, 4) for k in jax.random.split(sub, steps)]


def _small_holdouts(monkeypatch):
    """Both sides' held-out sets: two 48-px images, not eight of 192 px."""
    import srs_tpu.models.corpus as jax_corpus
    import srs_tpu_torch.models.corpus as corpus

    for mod in (jax_corpus, corpus):
        real = mod.make_corpus
        monkeypatch.setattr(mod, "make_corpus", lambda n, size=256, seed=0, mix="proc",
                            real=real: real(min(n, 2), 48, seed, mix))


def _assert_same_update(state, init, want, rtol):
    """The port's change of each parameter against the reference's (its
    trained state, converted), within ``rtol`` of the largest change."""
    assert set(state) == set(want)
    delta = {k: state[k] - init[k] for k in state}
    want_delta = {k: want[k] - init[k] for k in state}
    scale = max(float(d.abs().max()) for d in want_delta.values())
    assert scale > 0
    err = max(float((delta[k] - want_delta[k]).abs().max()) for k in state)
    assert err <= rtol * scale, (err, scale)


def test_train_polish_matches_reference(tmp_path, monkeypatch):
    """Both trainers take two clipped SGD steps on the same batches from the
    reference's initial polish (one 16-px image, so every crop is the
    image; the reference's producer draws handed to the port), behind the
    packaged edsr_xl and espcn x2, every net in float32: the same update
    of every parameter (within 1e-4 of the largest), and the same held-out
    PSNR of the SR and of its polish (within 1e-3 dB)."""
    from srs_tpu.models.registry import MODEL_REGISTRY

    monkeypatch.setenv("HOME", str(tmp_path))
    _small_holdouts(monkeypatch)
    _float32_nets(monkeypatch)
    img = np.random.default_rng(5).integers(0, 256, (1, 16, 16, 3)).astype(np.float32)
    saved = _reference_takes_sgd_steps(monkeypatch, img)
    spec = MODEL_REGISTRY["espcn_polish"]
    init_tree = spec.ctor(**dict(spec.kwargs)).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 16, 16, 3), jnp.float32))
    args = ["--steps", "2", "--scan-chunk", "2", "--batch", "1", "--patch", "8"]
    ref = load_script("train_polish")
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr("sys.argv", ["train_polish.py", "--cpu", *args,
                                     "--out", str(tmp_path / "ref")])
    ref.main()
    want = _eval(tmp_path / "ref")["espcn_polish_x1"]

    init = _port_takes_sgd_steps(monkeypatch, "espcn_polish", init_tree)
    use_q = iter([torch.from_numpy(np.array(jax.random.bernoulli(k[3], 0.6, (1, 1, 1, 1))))
                  for k in _step_keys(11, 2)])
    real_inputs = train_polish.polish_inputs
    monkeypatch.setattr(train_polish, "polish_inputs",
                        lambda hr, q, f, _use_q: real_inputs(hr, q, f, next(use_q)))
    monkeypatch.setattr(pretrain, "load_corpus", lambda *a, **k: img)
    ck = str(tmp_path / "port")
    for name in ("edsr_xl", "espcn"):
        save_checkpoint(converted(name, 2), name, 2, ck)
    rep = train_polish.main(["--cpu", *args, "--out", ck])
    _assert_same_update(rep["state"], init, _converted_tree(saved["params"]), 1e-4)
    assert set(rep["eval"]) == set(want)
    for k in ("holdout_sr", "holdout_polished"):
        assert abs(rep["eval"][k] - want[k]) <= 1e-3, (k, rep["eval"][k], want[k])
    assert rep["eval"]["sr_producer"] == want["sr_producer"] and rep["eval"]["steps"] == 2


def test_train_cond_matches_reference(tmp_path, monkeypatch):
    """Both trainers take two clipped SGD steps from the reference's initial
    cond_polish on the same batches (one 8-px image; the reference's
    distortion draws handed to the port), every net in float32: the same
    update of every parameter (within 1e-4 of the largest), the FiLM
    layer's too, and the same held-out rows within 1e-3 dB (the
    reference's held-out draws handed to the port)."""
    import srs_tpu.models.conditioning as jax_cond
    import srs_tpu_torch.models.conditioning as cond

    monkeypatch.setenv("HOME", str(tmp_path))
    _small_holdouts(monkeypatch)
    _float32_nets(monkeypatch)
    img = np.random.default_rng(6).integers(0, 256, (1, 8, 8, 3)).astype(np.float32)
    saved = _reference_takes_sgd_steps(monkeypatch, img)
    init_tree = jax_cond.CondPolish().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                           jnp.zeros((jax_cond.COND_DIM,)))
    args = ["--steps", "2", "--scan-chunk", "2", "--batch", "1", "--patch", "8",
            "--mix", "proc"]
    ref = load_script("train_cond")
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr("sys.argv", ["train_cond.py", "--cpu", *args,
                                     "--out", str(tmp_path / "ref")])
    ref.main()
    want = _eval(tmp_path / "ref")["cond_polish_x1"]

    init = _port_takes_sgd_steps(monkeypatch, "cond_polish", init_tree)
    keys = iter([k[3] for k in _step_keys(13, 2)])

    def reference_draws(hr, _gen, zero_frac=0.3):
        key = jax.random.PRNGKey(77) if zero_frac == 0.0 else next(keys)
        dist, c = jax_cond.degrade_conditioned(jnp.asarray(hr.numpy()), key, zero_frac)
        return torch.from_numpy(np.array(dist)), torch.from_numpy(np.array(c))

    monkeypatch.setattr(cond, "degrade_conditioned", reference_draws)
    monkeypatch.setattr(pretrain, "load_corpus", lambda *a, **k: img)
    rep = train_cond.main(["--cpu", *args, "--out", str(tmp_path / "port")])
    _assert_same_update(rep["state"], init, _converted_tree(saved["params"]), 1e-4)
    assert rep["film_weight_moved"] > 0
    assert set(rep["eval"]) == set(want)
    for k in ("holdout_distorted", "holdout_conditioned", "holdout_blind",
              "clean_passthrough"):
        assert abs(rep["eval"][k] - want[k]) <= 1e-3, (k, rep["eval"][k], want[k])
    assert (rep["eval"]["steps"], rep["eval"]["mix"]) == (want["steps"], want["mix"])


def test_train_cond_trains_the_film_layer(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    _small_corpora(monkeypatch)
    rep = train_cond.main(["--cpu", "--steps", "4", "--scan-chunk", "2", "--batch", "4",
                           "--patch", "32", "--mix", "proc", "--corpus-n", "4",
                           "--out", str(tmp_path)])
    assert rep["film_weight_moved"] > 0 and np.isfinite(rep["chunk_losses"]).all()
    _reloads_equal(rep["path"], rep["state"])
    assert {"holdout_distorted", "holdout_conditioned", "holdout_blind", "clean_passthrough",
            "steps", "mix", "train_seconds"} == set(rep["eval"])


def test_film_arms_agree_and_one_film_step_matches_reference():
    """The training arm (out of place) and the serving arm (in place) give
    the same bits, so the served ``food`` polish is unchanged; one FiLM
    step's loss and gradients equal the reference's."""
    from srs_tpu.models.conditioning import CondPolish as JaxCondPolish
    from srs_tpu.models.train import charbonnier_loss as jax_loss
    from srs_tpu_torch.models.conditioning import cond_vector
    from srs_tpu_torch.models.registry import seeded_params
    from srs_tpu_torch.models.train import charbonnier_loss

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32))
    for dtype in ("bfloat16", "float32"):
        net, _ = build_model("cond_polish", 1, seeded_params("cond_polish", 1, seed=4),
                             dtype=dtype, device="cpu")
        with torch.inference_mode():
            served = net(x, cond_vector("food"))
        with torch.enable_grad():
            net.requires_grad_(True)
            trained = net(x, cond_vector("food"))
        assert torch.equal(served, trained.detach())

    jmod = JaxCondPolish(dtype=jnp.float32)
    c = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    hr = rng.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 24, 3)), jnp.zeros((3,)))
    # flax zeroes conv_out, which would zero the FiLM gradient: give it weights
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    kernel = jparams["params"]["conv_out"]["kernel"]
    jparams["params"]["conv_out"]["kernel"] = rng.normal(0, 0.05, kernel.shape).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss(jmod.apply(p, jnp.asarray(x.numpy()), jnp.asarray(c)),
                           jnp.asarray(hr)))(jparams)
    net, _ = build_model("cond_polish", 1, convert_flax_params(jax.tree_util.tree_map(
        np.asarray, jparams)), dtype="float32", device="cpu", master_weights=True)
    with torch.enable_grad():
        net.requires_grad_(True)
        loss = charbonnier_loss(net(x, torch.from_numpy(c)), torch.from_numpy(hr))
        loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = np.asarray(jgrads["params"]["film"]["kernel"]).T  # flax Dense is (in, out)
    got = net.film.weight.grad.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_lpips_pairs_and_ranking_match_reference(tmp_path, monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setenv("HOME", str(tmp_path))
    ref = load_script("train_lpips")
    # the reference caches its pairs at a fixed /tmp path: never read or write it
    monkeypatch.setattr(ref, "os", SimpleNamespace(path=SimpleNamespace(exists=lambda p: False)))
    monkeypatch.setattr(np, "savez", lambda *a, **k: None)
    want = ref.build_pairs(1, 48, ref.SEED0)
    monkeypatch.undo()
    monkeypatch.setenv("HOME", str(tmp_path))
    got = train_lpips.build_pairs(1, 48, train_lpips.SEED0)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8, 48, 48, 3)
        np.testing.assert_allclose(g, w, atol=1e-3)

    def acc(r, lo, hi):
        return np.abs(r - lo).mean(axis=(1, 2, 3)) < np.abs(r - hi).mean(axis=(1, 2, 3))

    assert train_lpips.ranking_accuracy(acc, *got, chunk=3) == \
        ref.ranking_accuracy(acc, *got, chunk=3)


def test_train_lpips_matches_reference(tmp_path, monkeypatch, capsys):
    """Both trainers take one chunk (100 steps) of alex from the reference's
    initial features, each optimizer clipping as before and then taking
    plain SGD steps (Adam's step is the sign of a gradient near 0, which
    rounding flips). Every training pair is one triplet with its
    severities swapped (so the hinge is active), so a batch does not depend
    on the draws: the chunk's mean loss within relative 1e-4 of the
    reference's (it prints six decimals), every parameter's change within
    1e-2 of the largest (100 float32 steps), and the held-out ranking accuracy of the initial
    and of the trained features equal."""
    import re
    import zlib
    from types import SimpleNamespace

    import optax
    import orbax.checkpoint as ocp

    import srs_tpu.utils.compile_cache as compile_cache
    import srs_tpu_torch.models.lpips as port_lpips
    import srs_tpu_torch.models.train as port_train
    from srs_tpu.models.lpips import _ARCHS as JAX_ARCHS, _FeatureNet

    monkeypatch.setenv("HOME", str(tmp_path))
    ref = load_script("train_lpips")
    with monkeypatch.context() as m:  # the reference's pair cache is a fixed /tmp path
        m.setattr(ref, "os", SimpleNamespace(path=SimpleNamespace(exists=lambda p: False)))
        m.setattr(np, "savez", lambda *a, **k: None)
        refs, lows, highs = ref.build_pairs(1, 16, ref.SEED0 + 10_000)
    pairs = {ref.SEED0: tuple(np.repeat(a[:1], 8, axis=0) for a in (refs, highs, lows)),
             ref.SEED0 + 10_000: (refs, lows, highs)}
    monkeypatch.setattr(ref, "build_pairs", lambda n, size, seed0: pairs[seed0])
    monkeypatch.setattr(train_lpips, "build_pairs",
                        lambda n, size, seed0, mix="v3": pairs[seed0])
    monkeypatch.setattr(compile_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(optax, "adam", optax.sgd)
    real_opt = port_train.make_optimizer

    def sgd_optimizer(params, lr=2e-4, clip=1.0):
        opt = real_opt(params, lr, clip)
        opt.adam = torch.optim.SGD(opt.params, lr=lr)
        return opt

    monkeypatch.setattr(port_train, "make_optimizer", sgd_optimizer)
    saved = {}

    class Captured:
        def save(self, path, params, force=False):
            saved["params"] = params

        def wait_until_finished(self):
            pass

    monkeypatch.setattr(ocp, "StandardCheckpointer", Captured)
    args = ["--net", "alex", "--steps", "100", "--size", "16", "--batch", "1", "--lr", "1e-2"]
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr("sys.argv", ["train_lpips.py", "--cpu", *args,
                                     "--out", str(tmp_path / "ref")])
    ref.main()
    want_loss = float(re.search(r"\[alex\] step 0: loss ([0-9.]+)",
                                capsys.readouterr().out).group(1))
    want = _eval(tmp_path / "ref")["lpips_alex"]

    seed = zlib.crc32(b"alex") % (2**31)
    init = _converted_tree(_FeatureNet(**JAX_ARCHS["alex"]).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3), jnp.float32)),
        convert=port_lpips.convert_lpips_params)
    monkeypatch.setattr(port_lpips, "seeded_lpips_params", lambda net: init)
    rep = train_lpips.main(["--cpu", *args, "--out", str(tmp_path / "port")])
    got = rep["nets"]["alex"]
    assert want_loss > 0
    assert abs(got["chunk_losses"][0] - want_loss) <= 1e-4 * want_loss
    _assert_same_update(got["state"], init, _converted_tree(
        saved["params"], convert=port_lpips.convert_lpips_params), 1e-2)
    assert _eval(tmp_path / "port")["lpips_alex"] == want


def test_train_lpips_saves_features_lpips_reads(tmp_path, monkeypatch):
    from srs_tpu_torch.models.lpips import _ARCHS, FeatureNet, LPIPSMetric

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(train_lpips, "CHUNK", 2)
    rep = train_lpips.main(["--cpu", "--net", "alex", "--steps", "2", "--size", "32",
                            "--pairs-n", "1", "--holdout-n", "1", "--mix", "proc",
                            "--out", str(tmp_path)])
    net = rep["nets"]["alex"]
    assert np.isfinite(net["chunk_losses"]).all() and 0 <= net["rank_acc_trained"] <= 1
    _reloads_equal(net["path"], net["state"])
    assert set(_eval(tmp_path)["lpips_alex"]) == {"rank_acc_random", "rank_acc_trained",
                                                  "steps", "pairs"}
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 255, (32, 32, 3)).astype(np.float32) for _ in range(2))
    loaded = torch.load(net["path"], weights_only=True)
    module = FeatureNet(**_ARCHS["alex"])
    module.load_state_dict(loaded)
    with torch.no_grad():
        d = train_lpips.distance(module, torch.from_numpy(a[None]), torch.from_numpy(b[None]))
    metric = LPIPSMetric(params={"alex": loaded}, device="cpu")
    assert abs(float(metric(a, b, net="alex")) - float(d[0])) <= 1e-6 * float(d[0])


def test_fit_fusion_matches_reference(tmp_path, monkeypatch, capsys):
    import srs_tpu.models.fusion as jax_fusion

    ref = load_script("fit_fusion")
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    img = np.random.default_rng(0).uniform(0, 255, (130, 170, 3)).astype(np.float32)
    for g, w in zip(fit_fusion.crops_of(img, 96, 3, rng_a), ref.crops_of(img, 96, 3, rng_b)):
        np.testing.assert_array_equal(g, w)
    assert fit_fusion.crops_of(img, 200, 2, rng_a) == ref.crops_of(img, 200, 2, rng_b) == []

    import srs_tpu.models.photo_data as jax_photo_data

    # three crops of one training photo stand in for the pool on both sides
    photo = photo_data.load_photos()[0]
    photos = [photo[:100, :120].copy(), photo[100:220, 40:160].copy(), photo[-110:, -130:].copy()]
    monkeypatch.setattr(jax_photo_data, "load_photos", lambda: photos)
    monkeypatch.setattr(photo_data, "load_photos", lambda: photos)
    captured = {}
    monkeypatch.setattr(jax_fusion, "save_fusion", lambda per_scale: captured.update(per_scale))
    args = ["--scales", "2", "--members", "edsr_m,espcn,bicubic", "--crop", "96",
            "--per-photo", "1"]
    monkeypatch.setattr("sys.argv", ["fit_fusion.py", "--cpu", *args])
    ref.main()
    ck = str(tmp_path / "ck")
    for name in ("edsr_m", "espcn"):
        save_checkpoint(converted(name, 2), name, 2, ck)
    got = fit_fusion.main(["--cpu", *args, "--checkpoint-dir", ck])
    (kept, w, meta), (jkept, jw, jmeta) = got[2], captured[2]
    assert kept == jkept and meta["n_crops"] == jmeta["n_crops"] and meta["crop"] == 96
    assert abs(sum(w) - 1.0) <= 1e-6
    for m in kept:
        assert abs(meta["psnr_members"][m] - jmeta["psnr_members"][m]) <= 0.05, m
    assert abs(meta["psnr_fusion"] - jmeta["psnr_fusion"]) <= 0.05
    with open(os.path.join(ck, "FUSION.json")) as f:
        assert json.load(f)["x2"]["members"] == kept


def test_distort_and_sigma_field_match_reference():
    ref = load_script("fit_qa_models")
    from srs_tpu.qa.niqe import _sigma_field as jax_sigma
    from srs_tpu_torch.qa.niqe import _sigma_field

    img = np.random.default_rng(2).uniform(0, 255, (40, 56, 3)).astype(np.float32)
    for kind in ("blur", "noise", "jpeg", "upscale"):
        for level in (1, 2, 3, 4, 5):
            np.testing.assert_array_equal(fit_qa_models.distort(img, kind, level),
                                          ref.distort(img, kind, level))
    with pytest.raises(ValueError):
        fit_qa_models.distort(img, "swirl", 1)
    # the field where it is large (the noise image: 20-70), relative 1e-5;
    # near 0 the square root of float32's cancellation in E[x^2] - E[x]^2
    # differs at 1e-3 on both sides
    g = img.mean(-1)
    np.testing.assert_allclose(_sigma_field(torch.from_numpy(g)).numpy(),
                               np.asarray(jax_sigma(jnp.asarray(g))), rtol=1e-5, atol=1e-4)
    # its mean, what the pool's ranking reads, within 1e-4 on natural renders
    from srs_tpu_torch.models.corpus import render_photo

    for seed in (1, 2, 3):
        im = render_photo(seed, 96)
        assert abs(fit_qa_models._sharpness(im) - ref._sharpness(im)) <= 1e-4


def _small_photo_pool(monkeypatch, ref_mod):
    """Both pools cut down: one 120x150 photo crop, 48-px renders (one
    whole-image feature vector each)."""
    import srs_tpu.models.photo_data as jax_photo_data
    import srs_tpu_torch.models.corpus as corpus

    photo = photo_data.load_photos()[0][:120, :150].copy()
    real_render = corpus.render_photo
    monkeypatch.setattr(jax_photo_data, "load_photos", lambda: [photo])
    monkeypatch.setattr(photo_data, "load_photos", lambda: [photo])
    monkeypatch.setattr(ref_mod, "render_photo", lambda seed, size: real_render(seed, 48))
    for name in ("render_photo", "render_natural", "render_image"):
        real = getattr(corpus, name)
        monkeypatch.setattr(corpus, name, lambda seed, size, real=real: real(seed, 48))


def test_pristine_pool_matches_reference(monkeypatch):
    import srs_tpu.models.photo_data as jax_photo_data

    ref = load_script("fit_qa_models")
    _small_photo_pool(monkeypatch, ref)
    # the renders' arm (the photos' arm is the same feature call per scale)
    monkeypatch.setattr(jax_photo_data, "load_photos", lambda: [])
    monkeypatch.setattr(photo_data, "load_photos", lambda: [])
    monkeypatch.setattr(fit_qa_models, "PRISTINE_RENDERS", 60)
    want = ref.pristine_pool()
    got = fit_qa_models.pristine_pool()
    assert got.shape == want.shape
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-2, atol=1e-3)


def test_fit_qa_models_writes_the_reference_keys(tmp_path, monkeypatch):
    ref = load_script("fit_qa_models")
    _small_photo_pool(monkeypatch, ref)
    for name, v in (("N_BRISQUE", 1), ("PRISTINE_RENDERS", 4), ("HOLDOUT_RENDERS", 4),
                    ("LPIPS_IMAGES", 1)):
        monkeypatch.setattr(fit_qa_models, name, v)
    rep = fit_qa_models.main(["--device", "cpu", "--out", str(tmp_path),
                              "--checkpoint-dir", str(tmp_path / "none")])
    assert rep["brisque"]["samples"] == 21
    packaged = os.path.join(REPO, "srs_tpu", "qa", "data")
    for f in ("niqe_pristine.npz", "brisque_model.npz"):
        with np.load(os.path.join(tmp_path, f)) as got, np.load(os.path.join(packaged, f)) as w:
            assert set(got.files) == set(w.files), f
            assert all(got[k].shape == w[k].shape for k in w.files), f
    for d in (tmp_path, packaged):
        with open(os.path.join(d, "lpips_calib.json")) as f:
            keys = set(json.load(f))
        assert keys == {"lpips_excellent", "lpips_good", "lpips_acceptable",
                        "medians_by_severity"}


def test_train_ark_saves_and_reloads(tmp_path):
    rep = train_ark.main(["--cpu", "--steps", "4", "--scan-chunk", "2", "--n-per-class", "2",
                          "--size", "16", "--base", "8", "--depth", "1", "--batch", "4",
                          "--dtype", "float32", "--out", str(tmp_path)])
    _reloads_equal(rep["path"], rep["state"])
    with open(tmp_path / "ark_meta.json") as f:
        assert json.load(f) == {"size": 16, "base": 8, "depth": 1}
    assert set(rep["eval"]) == {"final_loss", "steps", "base", "size", "n_per_class",
                                "train_seconds"}
    assert np.isfinite(rep["eval"]["final_loss"]) and len(rep["logged"]) == 1


def test_guard_reference_unchanged():
    GUARD.check()
