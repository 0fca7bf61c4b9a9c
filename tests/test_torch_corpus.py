"""Port parity: the training data (``models/corpus.py``,
``models/photo_data.py``), the conditioned polish's training pairs
(``models/conditioning.py``) and the NIQE fit (``qa/niqe.py``) against
the JAX package, on the CPU.

Tolerances: the corpus exactly (the same numpy draws and the same cv2
here); the photographs exactly (the port's PNG decoder against PIL);
JPEG blockiness within 1e-3 on [0, 255] (both round half to even; the
8x8 DCTs sum in another order); the conditioned arms given the same
draws within 1e-3; NIQE features and the fitted pristine model within
relative 2e-2, as tests/test_torch_qa.py holds NIQE (a 0.001-step shape
table: a sample ratio near a step's edge may pick the next entry).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srs_tpu.models.corpus as jax_corpus
import srs_tpu.models.photo_data as jax_photo
from srs_tpu.models import conditioning as jax_cond
from srs_tpu.models import train as jax_train
from srs_tpu.qa import niqe as jax_niqe
from srs_tpu_torch.models import conditioning, corpus, photo_data, train
from srs_tpu_torch.qa.niqe import fit_pristine_model, niqe_features


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: these nets are small, and the suite's parallel
    workers would otherwise each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mix", corpus.CORPUS_MIXES)
def test_render_any_matches_reference(mix):
    assert corpus.CORPUS_MIXES == jax_corpus.CORPUS_MIXES
    for seed in (0, 1, 2):
        got, want = corpus.render_any(seed, 64, mix), jax_corpus.render_any(seed, 64, mix)
        assert got.dtype == np.float32 and got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{mix} seed {seed}")


def test_make_corpus_and_the_other_families_match_reference():
    np.testing.assert_array_equal(corpus.make_corpus(3, 48, seed=5),
                                  jax_corpus.make_corpus(3, 48, seed=5))
    for fn in ("render_natural", "render_photo"):
        np.testing.assert_array_equal(getattr(corpus, fn)(9, 48), getattr(jax_corpus, fn)(9, 48))


def test_photo_paths_match_reference_and_keep_the_holdout_out():
    assert photo_data.photo_paths() == jax_photo.photo_paths()
    assert photo_data.eval_photo_paths() == jax_photo.eval_photo_paths()
    assert photo_data.texture_paths() == jax_photo.texture_paths()
    train_pool = set(photo_data.photo_paths()) | set(photo_data.texture_paths())
    assert not train_pool & set(photo_data.eval_photo_paths())
    assert set(photo_data.EVAL_HOLDOUT_SOURCES).isdisjoint(photo_data.PHOTO_SOURCES)
    assert all("grace_hopper" not in p for p in train_pool)
    for got, want in zip(photo_data.load_photos(), jax_photo.load_photos()):
        np.testing.assert_array_equal(got, want)


def test_missing_sources_are_skipped(monkeypatch):
    found = photo_data.photo_paths()
    monkeypatch.setattr(photo_data, "PHOTO_SOURCES", photo_data.PHOTO_SOURCES + [
        ("no_such_package_for_photos", "a.png"), ("sklearn", "datasets/images/missing.jpg")])
    assert photo_data.photo_paths() == found
    monkeypatch.setattr(photo_data, "_package_dir", lambda pkg: None)
    monkeypatch.setattr(photo_data, "_CACHE", None)
    assert photo_data.photo_paths() == [] and photo_data.photo_mosaic(3, 64) is None
    # no photograph: the photo arms fall through to the procedural families
    monkeypatch.setattr(jax_photo, "load_photos", lambda: [])
    for mix in ("v3", "v4", "photo", "p70"):
        np.testing.assert_array_equal(corpus.render_any(4, 48, mix),
                                      jax_corpus.render_any(4, 48, mix))


def test_corpus_names_cv2_and_training_needs_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    with pytest.raises(ImportError, match="cv2"):
        corpus.render_image(0, 32)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 3, padding=1))
    hr = torch.rand(2, 3, 8, 8) * 255
    net, opt = train.init_train_state(net, 1e-3)
    assert torch.isfinite(train.train_step(net, opt, hr, hr)["loss"])


# -- the conditioned polish's training pairs --------------------------------------------------

def test_jpeg_blockiness_matches_reference():
    x = np.random.default_rng(1).uniform(0, 255, (4, 16, 24, 3)).astype(np.float32)
    strengths = np.array([0.0, 0.3, 1.0, 2.5], np.float32)
    want = np.stack([np.asarray(jax_cond.jpeg_blockiness(jnp.asarray(x[i]), strengths[i]))
                     for i in range(4)])
    got = conditioning.jpeg_blockiness(torch.from_numpy(x), torch.from_numpy(strengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got[0], x[0], atol=1e-3)  # strength 0 is lossless
    one = conditioning.jpeg_blockiness(torch.from_numpy(x[2]), 1.0).numpy()
    np.testing.assert_allclose(one, want[2], atol=1e-3)


def test_degrade_conditioned_arms_match_reference_given_the_draws():
    rng = np.random.default_rng(2)
    hr = rng.uniform(0, 255, (3, 16, 16, 3)).astype(np.float32)
    c = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.8], [1.0, 0.7, 0.2]], np.float32)
    noise = rng.normal(0, 1, hr.shape).astype(np.float32)
    want = []
    for i in range(3):
        bsig = max(1.6 * c[i, 1], 1e-3)
        xs = jnp.arange(-3, 4, dtype=jnp.float32)
        wk = jnp.exp(-0.5 * (xs / bsig) ** 2)
        out = jax_train._sep_blur7(jnp.asarray(hr[i : i + 1]), wk / wk.sum())[0]
        out = jax_cond.jpeg_blockiness(out, 2.5 * c[i, 2])
        want.append(np.asarray(jnp.clip(out + jnp.asarray(noise[i]) * (25.0 * c[i, 0]), 0, 255)))
    got = conditioning.conditioned_distort(torch.from_numpy(hr), torch.from_numpy(c),
                                           torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, np.stack(want), atol=1e-3)
    np.testing.assert_allclose(got[0], hr[0], atol=1e-3)  # c = 0 is the identity


def test_degrade_conditioned_draws_within_their_ranges():
    hr = torch.rand(512, 8, 8, 3) * 255
    out, c = conditioning.degrade_conditioned(hr, torch.Generator().manual_seed(0))
    assert out.shape == hr.shape and c.shape == (512, 3)
    zero = (c == 0).float().mean(dim=0).numpy()
    assert np.all(np.abs(zero - 0.3) < 0.07), zero  # 5 sds of a share of 512
    on = c[c > 0]
    assert float(on.min()) >= 0.1 and float(on.max()) <= 1.0
    d = conditioning.conditioned_draws(512, (8, 8, 3), torch.Generator().manual_seed(0))
    torch.testing.assert_close(c, d["c"], rtol=0, atol=0)
    torch.testing.assert_close(out, conditioning.conditioned_distort(hr, **d), rtol=0, atol=0)


# -- the NIQE fit ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def natural():
    return [corpus.render_natural(s, 192) for s in (11, 12)]


def test_niqe_features_match_reference(natural):
    for select in (0.75, 0.0):
        want = np.asarray(jax_niqe.niqe_features(jnp.asarray(natural[0]), 64, select))
        got = niqe_features(torch.from_numpy(natural[0]), 64, select)
        assert got.shape == want.shape and got.shape[1] == 36
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-6)


def test_fit_pristine_model_matches_reference(natural):
    want = jax_niqe.fit_pristine_model(natural, patch=64, shrink=0.1)
    got = fit_pristine_model(natural, patch=64, shrink=0.1)
    assert got["mu"].dtype == got["cov"].dtype == np.float64
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=2e-2, atol=1e-6)
    scale = np.sqrt(np.outer(np.diag(want["cov"]), np.diag(want["cov"])))
    np.testing.assert_allclose(got["cov"] / scale, want["cov"] / scale, atol=2e-2)
