"""Port parity: degradation routing, the SR-gain probe and the shrink
provider (srs_tpu_torch.models.routing, .sr_module) against the JAX
reference on the same seeded inputs.

Tolerances:
- ``estimate_degradation``: the same decision and reason; noise sigma and
  band ratio within relative 1e-5 (the statistics are numpy's: median of
  an even count, linear percentile, no Bessel correction);
- the probe runs its nets in bfloat16 on both sides, which round at
  different places: gain within 0.1 dB and alpha within 0.01 (the largest
  differences measured on these inputs are 0.04 dB and 0.003). Decisions
  are compared only on inputs whose reference gain lies at least 0.2 dB
  from the floor, which the test asserts;
- the shrink provider in float32: atol 1e-3 on outputs in [0, 255].
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.config import ModelConfig as RModelConfig
from srs_tpu.models import routing as RR
from srs_tpu.models.corpus import render_photo
from srs_tpu.models.registry import build_model as jax_build
from srs_tpu.models.sr_module import SuperResolutionModule as RSR
from srs_tpu_torch.config import ModelConfig
from srs_tpu_torch.models import routing as TR
from srs_tpu_torch.models.registry import convert_flax_params, seeded_params
from srs_tpu_torch.models.sr_module import SuperResolutionModule
from torch_packaged import packaged_in

EST_RTOL = 1e-5
GAIN_ATOL_DB = 0.1
ALPHA_ATOL = 0.01
MARGIN_DB = 0.2
F32_ATOL = 1e-3


def _clean(seed, size=128):
    hr = render_photo(seed, size * 2)
    return cv2.resize(hr, (size, size), interpolation=cv2.INTER_AREA).astype(np.float32)


def _noisy(seed, sigma=8.0):
    c = _clean(seed)
    return np.clip(c + np.random.default_rng(seed).normal(0, sigma, c.shape),
                   0, 255).astype(np.float32)


def _blurred(seed):
    soft = cv2.GaussianBlur(render_photo(seed, 256), (0, 0), 2.2)
    return cv2.resize(soft, (128, 128), interpolation=cv2.INTER_AREA).astype(np.float32)


def _converted(name, scales):
    out = {}
    for s in scales:
        _, params = jax_build(name, s)
        out[(name, s)] = convert_flax_params(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    return out


@pytest.fixture(scope="module")
def weights():
    return {**_converted("edsr_m", (2, 3)), **_converted("edsr_l", (2,))}


@pytest.mark.parametrize("kind,expect", [("clean", "clean"), ("noisy", "noise"),
                                         ("blurred", "blur")])
@pytest.mark.parametrize("seed", [700, 702])
def test_estimate_degradation_matches_reference(kind, expect, seed):
    image = {"clean": _clean, "noisy": _noisy, "blurred": _blurred}[kind](seed)
    ref = RR.estimate_degradation(image)
    got = TR.estimate_degradation(image, device="cpu")
    assert (got.degraded, got.reason) == (ref.degraded, ref.reason) == (kind != "clean", expect)
    assert got.noise_sigma == pytest.approx(ref.noise_sigma, rel=EST_RTOL, abs=1e-9)
    assert got.band_ratio == pytest.approx(ref.band_ratio, rel=EST_RTOL)
    tensor = TR.estimate_degradation(torch.from_numpy(image))
    assert tensor == got  # a tensor stays on its device


def test_numpy_statistics():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 10, 1001):
        x = rng.random(n).astype(np.float32)
        s = torch.sort(torch.from_numpy(x)).values
        assert TR._np_median(torch.from_numpy(x)) == pytest.approx(float(np.median(x)), rel=1e-7)
        for q in (0, 37.5, 60, 100):
            assert TR._np_percentile(s, q) == pytest.approx(float(np.percentile(x, q)), rel=1e-7)


def test_small_input_reads_clean():
    est = TR.estimate_degradation(np.zeros((12, 40, 3), np.float32), device="cpu")
    assert est == TR.DegradationEstimate(0.0, 1.0, False, "clean")


@pytest.mark.parametrize("h,w,scale,crop", [(1000, 1000, 2, 192), (140, 168, 3, 192),
                                            (105, 126, 4, 192), (64, 64, 2, 192),
                                            (64, 64, 2, 64), (200, 200, 2, 128),
                                            (720, 1280, 3, 192), (96, 112, 3, 192)])
def test_fit_crop_matches_reference(h, w, scale, crop):
    assert TR._fit_crop(h, w, scale, crop) == RR._fit_crop(h, w, scale, crop)


@pytest.mark.parametrize("seed,scale", [(700, 2), (700, 3), (703, 2), (705, 2)])
def test_probe_matches_reference(weights, seed, scale):
    image = _clean(seed, 192)
    ref_gain, ref_alpha = RR.probe_sr_alpha(image, "edsr_m", scale)
    gain, alpha = TR.probe_sr_alpha(image, "edsr_m", scale, weights=weights, device="cpu")
    assert abs(gain - ref_gain) <= GAIN_ATOL_DB
    assert abs(alpha - ref_alpha) <= ALPHA_ATOL and 0.0 <= alpha <= 1.0
    assert TR.probe_sr_gain(image, "edsr_m", scale, weights=weights, device="cpu") == gain
    # the routing decision (gain below the 0 dB floor), away from the edge
    assert abs(ref_gain) >= MARGIN_DB
    assert (gain < 0.0) == (ref_gain < 0.0)


def test_probe_declines_like_reference(weights):
    image = _clean(700, 192)
    assert TR.probe_sr_gain(image[:64, :64], "edsr_m", 2, weights=weights, device="cpu") is None
    assert RR.probe_sr_gain(image[:64, :64], "edsr_m", 2) is None
    # untrained: no weights handed in
    assert TR.probe_sr_alpha(image, "edsr_xl", 2, weights=weights, device="cpu") is None


def test_probe_reuses_its_bf16_nets(weights):
    nets = {}
    image = torch.from_numpy(_clean(701, 192))
    TR.probe_sr_gain(image, "edsr_m", 2, weights=weights, nets=nets)
    (key, net), = nets.items()
    assert key == ("edsr_m", 2, "cpu") and net.head.weight.dtype == torch.bfloat16
    TR.probe_sr_gain(image, "edsr_m", 2, weights=weights, nets=nets)
    assert nets[key] is net


def test_best_shrink_candidate_matches_reference(weights):
    image = _clean(703, 192)
    ref = RR.best_shrink_candidate(image, ("edsr_m", "edsr_l"), 2)
    got = TR.best_shrink_candidate(image, ("edsr_m", "edsr_l", "edsr_xl"), 2,
                                   weights=weights, device="cpu")
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= GAIN_ATOL_DB and abs(got[3] - ref[3]) <= GAIN_ATOL_DB
    assert abs(got[2] - ref[2]) <= ALPHA_ATOL


def test_route_quality_model_matches_reference():
    """Noisy input: the robust net when it is trained (the reference's
    packaged edsr_l_robust x2; the port's handed-in weights), else the
    clean net; a clean input keeps the clean net."""
    noisy = _noisy(701)
    ref_name, ref_est = RR.route_quality_model(noisy, "edsr_l")
    trained = {("edsr_l_robust", 2)}
    name, est = TR.route_quality_model(noisy, "edsr_l", is_trained=lambda n, s: (n, s) in trained,
                                       device="cpu")
    assert (name, est.reason) == (ref_name, ref_est.reason) == ("edsr_l_robust", "noise")
    name, _ = TR.route_quality_model(noisy, "edsr_l", device="cpu")
    assert name == "edsr_l"
    name, est = TR.route_quality_model(_clean(701), "edsr_l", is_trained=lambda n, s: True,
                                       device="cpu")
    assert name == "edsr_l" and not est.degraded


def test_sr_module_route_for():
    weights = {("edsr_l_robust", 2): seeded_params("edsr_l_robust", 2)}
    sr = SuperResolutionModule(ModelConfig(quality_model="edsr_m"), weights, device="cpu")
    name, est = sr.route_for(_noisy(701))
    assert name == "edsr_l_robust" and est.reason == "noise"
    assert sr.route_for(_clean(701))[0] is None
    off = SuperResolutionModule(ModelConfig(quality_model="edsr_m", auto_route=False),
                                weights, device="cpu")
    assert off.route_for(_noisy(701)) == (None, None)


@pytest.mark.parametrize("provider,alpha", [("shrink", 0.37), ("shrink", 0.0), ("bicubic", 1.0)])
def test_upscale_tiles_providers_match_reference(weights, provider, alpha):
    x = (np.random.default_rng(4).random((2, 14, 16, 3)) * 255).astype(np.float32)
    ref_sr = RSR(config=RModelConfig(quality_model="edsr_m", compute_dtype="float32",
                                     per_scale_selection=False))
    ref = np.asarray(ref_sr.upscale_tiles(jnp.asarray(x), 2, provider=provider, alpha=alpha))
    sr = SuperResolutionModule(
        ModelConfig(quality_model="edsr_m", compute_dtype="float32", per_scale_selection=False),
        weights, device="cpu")
    got = sr.upscale_tiles(torch.from_numpy(x), 2, provider=provider, alpha=alpha).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def _small_pipeline(tmp_path, weights, **kw):
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    cfg = dict(block_size=64, target_resolution="384x384", quality_model="edsr_m",
               compute_dtype="float32", ibp_steps=0, enable_qa=False, device="cpu")
    return SuperResolutionPipeline(PipelineConfig(**{**cfg, **kw}), weights)


def test_pipeline_routes_to_bicubic_below_the_floor(tmp_path, weights):
    """sr_gain_route="bicubic": a job whose probe reads below the floor
    serves the bicubic ladder: on a one-step ladder, the pixels of the
    zero-tail (exact bicubic) net within 1 LSB (that net clips its step)."""
    from srs_tpu_torch.io.native import read_tiff

    image = _clean(700, 96)
    pipe = _small_pipeline(tmp_path, weights, sr_gain_route="bicubic", sr_gain_floor=50.0,
                           target_resolution="192x192")
    res = pipe.process(image, str(tmp_path / "b.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert info["provider"] == "bicubic" and info["model"] is None and info["models"] is None
    assert info["routing"]["errors"] == [] and info["sr_gain_probe"] < 50.0
    plain = _small_pipeline(tmp_path, {}, auto_route=False, per_scale_selection=False,
                            target_resolution="192x192")
    res = plain.process(image, str(tmp_path / "p.tiff"))
    diff = np.abs(read_tiff(str(tmp_path / "b.tiff")).astype(np.int16)
                  - read_tiff(res.output_path).astype(np.int16))
    assert diff.max() <= 1


def test_pipeline_shrink_serves_texture_candidate(tmp_path, monkeypatch):
    """A probe-negative job probes the texture candidates trained at every
    ladder scale and serves the predicted winner with its own alpha
    (reference tests/test_routing.py, same monkeypatching)."""
    import srs_tpu_torch.models.routing as routing

    packaged_in(monkeypatch, tmp_path / "none")  # the store holds edsr_l x2
    weights = {(n, 2): seeded_params(n, 2, seed=3) for n in ("edsr_m", "edsr_l_tex")}
    monkeypatch.setattr(routing, "probe_sr_alpha", lambda *a, **k: (-0.5, 0.4))
    seen = []

    def best(image, models, scale, **kw):
        seen.append(tuple(models))
        return ("edsr_l_tex", -0.1, 0.25, 0.05)

    monkeypatch.setattr(routing, "best_shrink_candidate", best)
    pipe = _small_pipeline(tmp_path, weights, target_resolution="192x192",
                           texture_models=("edsr_l_tex", "edsr_l"))
    res = pipe.process(_clean(700, 96), str(tmp_path / "t.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert seen == [("edsr_m", "edsr_l_tex")]  # edsr_l has no weights
    assert (info["provider"], info["model"], info["models"], info["sr_gain_alpha"]) == (
        "shrink", "edsr_l_tex", ["edsr_l_tex"], 0.25)


def test_pipeline_records_a_swallowed_probe_error(tmp_path, weights, monkeypatch):
    """The probe is best-effort, as in the reference: its exception keeps
    the configured provider and is recorded, not hidden."""
    import srs_tpu_torch.models.routing as routing

    def boom(*a, **k):
        raise RuntimeError("probe exploded")

    monkeypatch.setattr(routing, "probe_sr_alpha", boom)
    pipe = _small_pipeline(tmp_path, weights)
    res = pipe.process(_clean(700, 96), str(tmp_path / "e.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert info["provider"] == "quality" and info["sr_gain_alpha"] is None
    assert info["routing"]["errors"] == ["probe: RuntimeError: probe exploded"]
