"""Port parity: the serving providers of the SR engine
(srs_tpu_torch.models.sr_module, .fusion, .selection) against the JAX
package, with the packaged trained checkpoints converted.

The reference loads its weights from a checkpoint directory of its own
per test, holding links to exactly the packaged checkpoints the test
names (its packaged directory hidden), and the port gets those
checkpoints converted, so both sides count the same nets as trained.
Both sides run float32 convolutions.

Tolerances: the dihedral ensemble of a plain function exact, of a net
atol 1e-3 (like the nets themselves); ``upscale_tiles`` per provider atol
2e-3 on [0, 255] (fusion weights up to 1.65 in magnitude add the
members' float32 differences; the polishes chain two nets); the
single-image API atol 2e-3, or equal uint8 images except at rounding
ties for PIL input; FUSION.json, its fit and selection exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import srs_tpu.models.fusion as jax_fusion
import srs_tpu.models.registry as jax_registry
from srs_tpu.config import ModelConfig as JaxModelConfig
from srs_tpu.models.selection import panel_best_model as jax_panel_best
from srs_tpu.models.sr_module import SuperResolutionModule as JaxSR
from srs_tpu.models.sr_module import UpscaleConfig as JaxUpscaleConfig
from srs_tpu.models.sr_module import UpscaleProvider as JaxProvider
from srs_tpu.models.sr_module import VeImageXTemplate as JaxTemplate
from srs_tpu.models.sr_module import _dihedral_ensemble as jax_ensemble
from srs_tpu_torch.config import ModelConfig
from srs_tpu_torch.models import fusion
from srs_tpu_torch.models.registry import convert_flax_params
from srs_tpu_torch.models.selection import panel_best_model
from srs_tpu_torch.models.sr_module import (
    SuperResolutionModule,
    UpscaleConfig,
    UpscaleProvider,
    VeImageXTemplate,
    _dihedral_ensemble,
)

ATOL = 2e-3
PACKAGED = jax_registry.PACKAGED_CHECKPOINT_DIR
X2_MEMBERS = ("edsr_xl", "edsr_l", "rcan", "edsr_m", "espcn")

_CONVERTED = {}


def converted(name, scale):
    """The packaged checkpoint of ``name`` at ``scale`` as a port state dict."""
    if (name, scale) not in _CONVERTED:
        if name == "cond_polish":
            from srs_tpu.models.conditioning import build_cond_polish

            params = build_cond_polish(dtype=jnp.float32)[1]
        else:
            params = jax_registry.build_model(name, scale, dtype=jnp.float32)[1]
        _CONVERTED[(name, scale)] = convert_flax_params(
            jax.tree_util.tree_map(np.asarray, params))
    return _CONVERTED[(name, scale)]


def modules(tmp_path, monkeypatch, trained, **cfg):
    """(reference module, port module) with exactly ``trained`` nets
    trained, float32 convolutions, selection off unless asked."""
    weights = {key: converted(*key) for key in trained}
    d = tmp_path / "ckpt"
    d.mkdir()
    for name, s in trained:
        os.symlink(os.path.join(PACKAGED, f"{name}_x{s}"), d / f"{name}_x{s}")
    monkeypatch.setattr(jax_registry, "PACKAGED_CHECKPOINT_DIR", str(tmp_path / "none"))
    cfg.setdefault("per_scale_selection", False)
    cfg.setdefault("quality_model", "edsr_m")
    ref = JaxSR(config=JaxModelConfig(checkpoint_dir=str(d), compute_dtype="float32",
                                      auto_route=False, **cfg))
    port = SuperResolutionModule(ModelConfig(compute_dtype="float32", auto_route=False, **cfg),
                                 weights, device="cpu")
    return ref, port


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    h, w = shape[1], shape[2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 3.0), 128 + 90 * np.cos(yy / 4.0),
                     128 + 70 * np.sin((xx + yy) / 2.5)], -1)
    return np.clip(base + rng.normal(0, 12, shape), 0, 255).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# -- building blocks --------------------------------------------------------


def test_dihedral_ensemble_of_a_plain_function_is_exact():
    """The 8 transforms and their inverses: a per-pixel map (equivariant
    under the group), and a map that adds each pixel's column index, which
    only an exact inverse of each transform returns to the reference's."""
    x = _x(1, (2, 7, 7, 3))

    def f_t(t):
        return t * 2.0 + 1.0

    def f_j(t):
        return t * 2.0 + 1.0
    np.testing.assert_array_equal(_dihedral_ensemble(f_t, torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_ensemble(f_j, jnp.asarray(x))))
    def g_t(t):
        return t + torch.arange(t.shape[2], dtype=t.dtype)[None, None, :, None]

    def g_j(t):
        return t + jnp.arange(t.shape[2], dtype=t.dtype)[None, None, :, None]
    _close(_dihedral_ensemble(g_t, torch.from_numpy(x)), jax_ensemble(g_j, jnp.asarray(x)),
           atol=1e-5)


def test_dihedral_ensemble_of_a_trained_net(tmp_path, monkeypatch):
    ref, port = modules(tmp_path, monkeypatch, [("edsr_m", 2)])
    x = _x(2, (2, 12, 12, 3))
    want = jax_ensemble(ref._net("quality", 2), jnp.asarray(x))
    with torch.inference_mode():
        got = _dihedral_ensemble(port._net("quality", 2), torch.from_numpy(x))
    _close(got, want, atol=1e-3)


@pytest.mark.parametrize("scale", [2, 3, 4, 5])
def test_load_fusion_reads_the_packaged_file(scale):
    assert fusion.load_fusion(scale) == jax_fusion.load_fusion(scale)
    assert fusion.fusion_path() == jax_fusion.fusion_path()


def test_fusion_file_in_checkpoint_dir_comes_first_and_bad_entries_read_as_none(tmp_path):
    per_scale = {2: (["edsr_m+", "bicubic"], [1.2, -0.2], {"crop": 8}),
                 3: (["espcn"], [1.0], {})}
    p = fusion.save_fusion(per_scale, str(tmp_path))
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    jax_fusion.save_fusion(per_scale, str(ref_dir))
    with open(p) as f, open(ref_dir / "FUSION.json") as g:
        assert f.read() == g.read()
    for s in (2, 3, 4):
        assert fusion.load_fusion(s, str(tmp_path)) == jax_fusion.load_fusion(s, str(tmp_path))
    # merged over the scales already there
    fusion.save_fusion({4: (["rcan", "bicubic"], [0.9, 0.1], {})}, str(tmp_path))
    assert fusion.load_fusion(2, str(tmp_path)) == (["edsr_m+", "bicubic"], [1.2, -0.2])
    with open(p, "w") as f:
        json.dump({"x2": {"members": ["a", "b"], "weights": [1.0]}, "x3": {"members": []},
                   "x4": "garbage"}, f)
    for s in (2, 3, 4):
        assert fusion.load_fusion(s, str(tmp_path)) is None
        assert jax_fusion.load_fusion(s, str(tmp_path)) is None


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fit_affine_weights_matches_reference(k):
    rng = np.random.default_rng(k)
    target = rng.random((40, 3)).astype(np.float32) * 255
    outs = [target + rng.normal(0, 3 + i, target.shape).astype(np.float32) for i in range(k)]
    w = fusion.fit_affine_weights(outs, target)
    np.testing.assert_allclose(w, jax_fusion.fit_affine_weights(outs, target), rtol=1e-12)
    assert abs(w.sum() - 1.0) < 1e-9


@pytest.mark.parametrize("trained", [
    [(m, 2) for m in X2_MEMBERS],  # every member: "+" members kept, weights as packaged
    [("edsr_xl", 2), ("espcn", 2)],  # two trained members, renormalised
    [("edsr_m", 2)],  # one trained member: no fusion
    [],
])
def test_fusion_for_drops_untrained_members(tmp_path, monkeypatch, trained):
    ref, port = modules(tmp_path, monkeypatch, trained)
    want, got = ref._fusion_for(2), port._fusion_for(2)
    if want is None:
        assert got is None
        return
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([w for _, w in got], [w for _, w in want], rtol=1e-12)
    assert abs(sum(w for _, w in got) - 1.0) < 1e-9


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("ensemble", [False, True])
def test_selection_reads_the_ensemble_blocks(scale, ensemble):
    """With the self-ensemble on, x3 serves edsr_l (edsr_l+ 1.080 beats
    edsr_xl+ 1.073 on the packaged panel) where edsr_xl wins without it."""
    def trained(name, s):
        return os.path.isdir(os.path.join(PACKAGED, f"{name}_x{s}"))
    got = panel_best_model(scale, "edsr_xl", trained, ensemble=ensemble)
    assert got == jax_panel_best(scale, "edsr_xl", ensemble=ensemble)
    if scale == 3:
        assert got == ("edsr_l" if ensemble else "edsr_xl")


# -- upscale_tiles, provider by provider --------------------------------------

# (provider, scale, trained nets, config, category)
TILE_CASES = {
    "fast": ("fast", 3, [("espcn", 3)], {}, None),
    "fast_untrained_ibp": ("fast", 2, [], {}, None),
    "hybrid_polish": ("hybrid", 2, [("espcn_polish", 1)], {}, None),
    "hybrid_trained_no_polish": ("hybrid", 2, [("edsr_m", 2), ("espcn_polish", 1)], {}, None),
    "fusion_x2": ("fusion", 2, [(m, 2) for m in X2_MEMBERS], {}, None),
    "fusion_ensemble": ("fusion", 2, [("edsr_xl", 2), ("edsr_l", 2)], {"self_ensemble": True},
                        None),
    "fusion_weights_cancel": ("fusion", 3, [("edsr_m", 3), ("espcn", 3)], {}, None),
    "fusion_falls_back": ("fusion", 2, [("edsr_m", 2)], {}, None),
    "quality_ensemble": ("quality", 2, [("edsr_m", 2)], {"self_ensemble": True}, None),
    "rcan": ("quality", 3, [("rcan", 3)], {"quality_model": "rcan"}, None),
    "quality_conditioned": ("quality", 2, [("edsr_m", 2), ("cond_polish", 1)], {}, "food"),
    "bicubic_conditioned": ("bicubic", 2, [("cond_polish", 1)], {}, "3c"),
    "shrink_conditioned": ("shrink", 2, [("edsr_m", 2), ("cond_polish", 1)], {}, "beauty"),
    "category_without_polish": ("quality", 2, [("edsr_m", 2)], {}, "food"),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_upscale_tiles_matches_reference(tmp_path, monkeypatch, case):
    provider, scale, trained, cfg, category = TILE_CASES[case]
    ref, port = modules(tmp_path, monkeypatch, trained, **cfg)
    x = _x(sorted(TILE_CASES).index(case), (2, 10, 10, 3))
    kw = dict(provider=provider, steps=3, category=category)
    if provider == "shrink":
        kw["alpha"] = 0.4
    want = ref.upscale_tiles(jnp.asarray(x), scale, **kw)
    with torch.inference_mode():
        got = port.upscale_tiles(torch.from_numpy(x), scale, **kw)
    _close(got, want)
    members = port.step_members(scale, provider)
    if case == "fusion_x2":
        assert [m for m, _ in members] == ["edsr_xl", "edsr_l", "edsr_xl", "edsr_l", "rcan",
                                           "edsr_m", "espcn"]
        assert [p for _, p in members] == [8, 8, 1, 1, 1, 1, 1]
    elif case == "fusion_ensemble":
        assert members == [("edsr_xl", 8), ("edsr_l", 8), ("edsr_xl", 8), ("edsr_l", 8)]
    elif case in ("fusion_falls_back", "fusion_weights_cancel"):
        # one trained member; or two whose kept weights sum to -0.056 with bicubic's
        assert port._fusion_for(scale) is None and members == [("edsr_m", 1)]
    elif case == "hybrid_polish":
        assert members == [("edsr_m", 1), ("espcn_polish", 1)]
    elif case == "hybrid_trained_no_polish":
        assert members == [("edsr_m", 1)]


def test_conditioned_polish_changes_the_pixels(tmp_path, monkeypatch):
    _, port = modules(tmp_path, monkeypatch, [("edsr_m", 2), ("cond_polish", 1)])
    x = torch.from_numpy(_x(4, (1, 12, 12, 3)))
    with torch.inference_mode():
        plain = port.upscale_tiles(x, 2)
        food = port.upscale_tiles(x, 2, category="food")
        tech = port.upscale_tiles(x, 2, category="3c")
    assert (food - plain).abs().max() > 0.5 and (food - tech).abs().max() > 0.05


# -- the single-image API ------------------------------------------------------


def _pil(seed, h=12, w=14):
    return Image.fromarray(_x(seed, (1, h, w, 3))[0].astype(np.uint8))


@pytest.mark.parametrize("kind", ["array", "pil", "batch"])
def test_deterministic_seed_matches_reference(tmp_path, monkeypatch, kind):
    ref, port = modules(tmp_path, monkeypatch, [])
    image = {"array": _x(5, (1, 70, 90, 3))[0], "pil": _pil(6, 80, 70),
             "batch": _x(7, (2, 20, 30, 3))}[kind]
    for block in ("", "b3"):
        assert port._deterministic_seed(image, block) == ref._deterministic_seed(image, block)
    g1, g2 = port.seed_generator(image, "b3"), port.seed_generator(image, "b3")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert g1.initial_seed() == ref._deterministic_seed(image, "b3")


@pytest.mark.parametrize("provider", ["seedream", "veimagex", "bicubic", "hybrid"])
@pytest.mark.parametrize("kind", ["array", "pil"])
def test_upscale_dispatcher_matches_reference(tmp_path, monkeypatch, provider, kind):
    """x2 for the tiers, x2.5 for bicubic (a non-integer scale); hybrid at
    x4 with an untrained quality net, so the trained polish runs."""
    trained = [("edsr_m", 2), ("espcn", 2), ("cond_polish", 1)]
    if provider == "hybrid":
        trained = [("espcn", 2), ("espcn_polish", 1)]
    ref, port = modules(tmp_path, monkeypatch, trained)
    image = _x(8, (1, 12, 14, 3))[0] if kind == "array" else _pil(8)
    scale = {"bicubic": 2.5, "hybrid": 4.0}.get(provider, 2.0)
    want = ref.upscale(image, JaxUpscaleConfig(provider=JaxProvider(provider),
                                               target_scale=scale, category="food"))
    got = port.upscale(image, UpscaleConfig(provider=UpscaleProvider(provider),
                                            target_scale=scale, category="food"))
    for key in ("original_size", "upscaled_size", "scale_factor", "provider"):
        assert getattr(got, key) == getattr(want, key), key
    if kind == "pil":
        a, b = np.asarray(got.image).astype(int), np.asarray(want.image).astype(int)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-2
    else:
        _close(got.image, want.image)
    if provider == "hybrid":
        stages = [h["stage"] for h in got.metadata["processing_history"]]
        assert stages == [h["stage"] for h in want.metadata["processing_history"]] == [
            "fast_prefilter", "quality_main", "fast_polish"]
        assert "skipped" not in got.metadata["processing_history"][-1]
    if provider == "seedream":
        assert got.metadata["conditioned"] and want.metadata["conditioned"]
        assert got.metadata["seed"] == want.metadata["seed"]


@pytest.mark.parametrize("template,scale", [(VeImageXTemplate.FAST_SR, 1.0),
                                            (VeImageXTemplate.STANDARD_SR, 3.0)])
def test_upscale_veimagex_templates(tmp_path, monkeypatch, template, scale):
    ref, port = modules(tmp_path, monkeypatch, [("espcn", 3), ("espcn_polish", 1)])
    image = _x(9, (1, 11, 13, 3))
    got = port.upscale_veimagex(image, template, scale)
    want = ref.upscale_veimagex(image, JaxTemplate(template.value), scale)
    _close(got.image, want.image)
    assert got.metadata == want.metadata


def test_upscale_seedream_untrained_ladder_back_projects(tmp_path, monkeypatch):
    ref, port = modules(tmp_path, monkeypatch, [])
    image = _x(10, (1, 10, 12, 3))[0]
    got = port.upscale_seedream(image, "p", strength=0.7, target_scale=3.0,
                                num_inference_steps=5)
    want = ref.upscale_seedream(image, "p", strength=0.7, target_scale=3.0,
                                num_inference_steps=5)
    _close(got.image, want.image)
    assert got.metadata["steps"] == want.metadata["steps"] == 5
    assert not got.metadata["conditioned"]


def test_hybrid_quality_failure_falls_back_to_fast(tmp_path, monkeypatch):
    _, port = modules(tmp_path, monkeypatch, [])
    port.RETRY_BASE_DELAY = 0.0
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("device lost")

    monkeypatch.setattr(port, "upscale_seedream", broken)
    res = port.hybrid_upscale(_x(11, (1, 8, 8, 3))[0], target_scale=3.0)
    history = res.metadata["processing_history"]
    assert len(calls) == port.MAX_RETRIES
    assert [h["stage"] for h in history] == ["fast_prefilter", "quality_fallback_fast",
                                             "fast_polish"]
    assert history[1]["reason"] == "device lost" and history[2]["skipped"] == "untrained"
    assert res.upscaled_size == (24, 24)


def test_retry_with_backoff_returns_the_first_success_and_raises_the_last_failure(
        tmp_path, monkeypatch):
    _, port = modules(tmp_path, monkeypatch, [])
    port.RETRY_BASE_DELAY = 0.0
    attempts = []

    def flaky(v):
        attempts.append(v)
        if len(attempts) < 2:
            raise ValueError(f"attempt {len(attempts)}")
        return v * 2

    assert port.retry_with_backoff(flaky, 21) == 42 and len(attempts) == 2
    failures = []

    def always():
        failures.append(1)
        raise KeyError(f"failure {len(failures)}")

    with pytest.raises(KeyError, match="failure 3"):
        port.retry_with_backoff(always)
