"""Port parity: the text-to-image API (``srs_tpu_torch.models.generate``)
against the JAX package's ``srs_tpu.models.generate``, on the CPU.

The host code is held exactly: the procedural synthesizer, the size and
seed rules, the procedural switch, the class of a prompt, the guidance
map and the watermark. The learned path is held end to end with the same
weights on both sides (a seeded ``CondUNet(base=8, depth=2)`` given to
the reference in place of its packaged generator, converted for the port;
the reference's packaged ``espcn`` x2 as the ``fast`` SR net, converted),
in float32 on both sides, with the reference's ``jax.random`` draws
handed to the port's ``sample_ark`` and ``refine_ark``: within 1e-3 on
[0, 255] at a target of twice the 16-px base, with and without the
refinement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srs_tpu.models.generate as jgen
import srs_tpu.models.generative as jg
from srs_tpu.config import ModelConfig as JaxModelConfig
from srs_tpu.models.registry import build_model as jax_build_model
from srs_tpu.models.sr_module import SuperResolutionModule as JaxSR
from srs_tpu_torch.config import ModelConfig
from srs_tpu_torch.models import generate as tgen
from srs_tpu_torch.models import generative as tg
from srs_tpu_torch.models.registry import convert_flax_params
from srs_tpu_torch.models.sr_module import SuperResolutionModule

ATOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the nets are small, and the suite's parallel
    workers would otherwise each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_forced_procedural(monkeypatch):
    monkeypatch.delenv("SRS_ARK_PROCEDURAL", raising=False)


@pytest.mark.parametrize("seed,wh", [(0, (64, 48)), (873146385, (31, 17)), (2**31 - 1, (8, 8))])
def test_procedural_matches_reference(seed, wh):
    got = tgen._procedural("p", seed, wh)
    want = jgen._procedural("p", seed, wh)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", ["1K", "2K", "4K", "640x480", "17x5", "huge", "", "3X3"])
def test_resolve_size_matches_reference(size):
    assert tgen._resolve_size(size) == jgen._resolve_size(size)


@pytest.mark.parametrize("model,env", [
    ("ark-gen-v1", None), ("procedural-v1", None), ("Procedural", None), (None, None),
    ("ark-gen-v1", "1"), ("ark-gen-v1", "0"), ("ark-gen-v1", " TRUE "), ("ark-gen-v1", "off"),
])
def test_force_procedural_matches_reference(model, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SRS_ARK_PROCEDURAL", env)
    assert (tgen._force_procedural(tgen.ARKImageConfig(model=model))
            == jgen._force_procedural(jgen.ARKImageConfig(model=model)))


@pytest.mark.parametrize("watermark", [False, True])
def test_procedural_generation_and_watermark_match_reference(watermark, monkeypatch):
    """The seed from the prompt's md5, the image and the watermark: the
    reference returns its uint8 PIL image, the port the float32 array."""
    monkeypatch.setenv("SRS_ARK_PROCEDURAL", "1")
    cfg = dict(size="256x200", watermark=watermark)
    got = tgen.ARKImageGenerator(device="cpu").generate(
        "studio shot of a red bottle", tgen.ARKImageConfig(**cfg))
    want = jgen.ARKImageGenerator().generate("studio shot of a red bottle",
                                             jgen.ARKImageConfig(**cfg))
    assert got.seed == want.seed and got.size == want.size == (256, 200)
    assert got.metadata == want.metadata == {"model": "procedural-v1"}
    assert got.image.dtype == np.float32 and got.image.shape == (200, 256, 3)
    np.testing.assert_array_equal(got.image.astype(np.uint8), np.asarray(want.image))
    r = tgen.generate_image("x", device="cpu", size="64x64", seed=5, watermark=watermark)
    assert r.seed == 5 and r.image.shape == (64, 64, 3)


def test_generator_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.ARKImageGenerator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate_image("x", size="64x64")


def test_untrained_generator_serves_procedural(tmp_path, monkeypatch):
    """No trained generator (an empty checkpoint directory, no weights, the
    store hidden): the reference's rule serves the procedural image."""
    from torch_packaged import port_store_in

    port_store_in(monkeypatch, tmp_path / "no_store")
    gen = tgen.ARKImageGenerator(checkpoint_dir=str(tmp_path), device="cpu")
    r = gen.generate("a weave pattern", tgen.ARKImageConfig(size="64x48", seed=3))
    assert r.metadata == {"model": "procedural-v1"}
    np.testing.assert_array_equal(r.image, jgen._procedural("a weave pattern", 3, (64, 48)))


def test_a_failing_learned_path_raises_instead_of_serving_procedural():
    """The reference serves the procedural image on any exception of the
    learned path; the port raises, so a device fault is never hidden."""
    bad = dict(_ark_pair()[2])
    bad["convs.0.weight"] = bad["convs.0.weight"][:, :2]  # a stem of 2 input channels
    gen = tgen.ARKImageGenerator(weights={("ark_gen", 1): bad}, device="cpu")
    with pytest.raises(RuntimeError):
        gen.generate("x", tgen.ARKImageConfig(size="32x32", extra={"base_size": 16}))


def _ark_pair(seed=1):
    """(float32 flax module, perturbed params, the port's state dict)."""
    m = jg.CondUNet(base=8, depth=2, dtype=jnp.float32)
    p = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
               jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        fan_in = int(np.prod(x.shape[:-1])) if x.ndim > 1 else x.shape[0]
        return (x + rng.normal(0, 0.3, x.shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)

    p = jax.tree_util.tree_map(f, p)
    return m, p, tg.convert_ark_params(p)


@pytest.fixture(scope="module")
def espcn_x2():
    """The reference's packaged espcn x2 params (numpy tree)."""
    _, params = jax_build_model("espcn", 2)
    return jax.tree_util.tree_map(np.asarray, params)


def _with_reference_draws(monkeypatch):
    """The port's sample_ark and refine_ark given the draws the reference
    makes for the same seed: ``PRNGKey(seed)`` for the noise, and for the
    refinement ``PRNGKey(seed ^ 0x5EED)`` split once per chunk."""
    sample, refine = tg.sample_ark, tg.refine_ark

    def sample_ref(module, cls, seed=0, size=64, steps=50, guidance=2.0, batch=1, noise=None):
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (batch, size, size, 3)))
        return sample(module, cls, seed=seed, size=size, steps=steps, guidance=guidance,
                      batch=batch, noise=noise)

    def refine_ref(module, image, cls, seed=0, tile=None, chunk=64, eps=None, **kw):
        from srs_tpu_torch.tiling.geometry import compute_layout

        side = int(tile) if tile else 64
        n = compute_layout(image.shape[1], image.shape[0], block_size=side,
                           overlap_ratio=0.25).num_tiles
        key, draws = jax.random.PRNGKey(seed), []
        for s0 in range(0, n, chunk):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, (min(chunk, n - s0), side, side, 3))))
        return refine(module, image, cls, seed=seed, tile=tile, chunk=chunk,
                      eps=np.concatenate(draws), **kw)

    monkeypatch.setattr(tg, "sample_ark", sample_ref)
    monkeypatch.setattr(tg, "refine_ark", refine_ref)


@pytest.mark.parametrize("refine", [False, True])
def test_learned_path_matches_reference(refine, espcn_x2, monkeypatch):
    m, p, sd = _ark_pair()
    monkeypatch.setattr(jg, "build_ark", lambda *a, **k: (m, p, True))
    monkeypatch.setattr(jgen, "Image", None)  # the reference's float32 branch
    monkeypatch.setattr(jgen, "_SR_SINGLETON",
                        JaxSR(config=JaxModelConfig(compute_dtype="float32")))
    _with_reference_draws(monkeypatch)
    build = tg.build_ark
    monkeypatch.setattr(tg, "build_ark", lambda *a, **k: build(*a, **{**k, "dtype": "float32"}))

    extra = {"steps": 4, "sr_provider": "fast", "base_size": 16, "refine": refine,
             "refine_steps": 3}
    want = jgen.ARKImageGenerator().generate(
        "product shot of a watch", jgen.ARKImageConfig(size="32x32", extra=dict(extra)))
    weights = {("ark_gen", 1): sd, ("espcn", 2): convert_flax_params(espcn_x2)}
    gen = tgen.ARKImageGenerator(weights=weights, device="cpu")
    gen._sr = SuperResolutionModule(ModelConfig(compute_dtype="float32"),
                                    {("espcn", 2): weights[("espcn", 2)]}, device="cpu")
    got = gen.generate("product shot of a watch",
                       tgen.ARKImageConfig(size="32x32", extra=dict(extra)))
    assert want.metadata["model"] == "ark_gen-ddim"
    assert {k: got.metadata[k] for k in want.metadata} == want.metadata
    assert got.metadata["sr_ladder"] == [2] and got.metadata["refined"] is refine
    assert set(got.metadata["stage_seconds"]) >= {"sample", "sr_ladder", "resize"}
    assert got.seed == want.seed and got.image.shape == (32, 32, 3)
    np.testing.assert_allclose(got.image, np.asarray(want.image), atol=ATOL)


def test_learned_path_is_seeded_and_class_steered():
    """The port's own draws: the same prompt twice gives the same image;
    another class with the same seed changes it."""
    _, _, sd = _ark_pair()
    gen = tgen.ARKImageGenerator(weights={("ark_gen", 1): sd}, device="cpu")
    cfg = dict(size="32x32", extra={"steps": 3, "base_size": 16, "sr_provider": "fast"})
    r1 = gen.generate("product shot of a watch", tgen.ARKImageConfig(**cfg))
    r2 = gen.generate("product shot of a watch", tgen.ARKImageConfig(**cfg))
    np.testing.assert_array_equal(r1.image, r2.image)
    r3 = gen.generate("a text poster page", tgen.ARKImageConfig(seed=r1.seed, **cfg))
    assert r3.metadata["class"] == "document" != r1.metadata["class"]
    assert float(np.abs(r3.image - r1.image).mean()) > 1.0
    assert 0.0 <= r1.image.min() and r1.image.max() <= 255.0
