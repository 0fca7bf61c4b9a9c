"""Port parity: the reference's remote provider names ``seedream`` (served
as the quality tier, routed) and ``veimagex`` (the fast tier), and the
``PipelineConfig`` fields the reference accepts for them, against the
JAX package's pipeline at toy size (the harness of
test_torch_provider_pipeline.py: a 32x48 input, the packaged checkpoints
of exactly the nets a case names, float32 convolutions on both sides).

Tolerance: the TIFF within 1 LSB of the reference's PNG, on under 1% of
samples (float32 sums in another order flip rounding ties).
"""

import dataclasses

import pytest
import torch

from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from srs_tpu_torch.tiling.geometry import compute_layout
from test_torch_provider_pipeline import image, run_both  # noqa: F401 - the fixture

FIELDS = ("seedream_strength", "seedream_steps", "qa_device", "volc_ak", "volc_sk",
          "volc_region")


@pytest.mark.parametrize("auto_route", [False, True])
def test_seedream_serves_the_quality_nets(image, tmp_path, monkeypatch, auto_route):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("edsr_m", s) for s in (2, 3, 4)], 3, provider="seedream",
                                 auto_route=auto_route)
    info, jinfo = pipe.last_run_info, jpipe.last_run_info
    assert info["provider"] == jinfo["provider"] == "seedream"
    assert info["models"] == jinfo["models"] == ["edsr_m"]
    assert info["step_members"] == [[["edsr_m", 1]]]
    # seedream is routed like quality: the degradation estimate ran
    assert (info["routing"]["degradation"] is not None) == auto_route


def test_veimagex_serves_the_fast_net(image, tmp_path, monkeypatch):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("espcn", s) for s in (2, 3, 4)], 3, provider="veimagex")
    info = pipe.last_run_info
    assert info["provider"] == jpipe.last_run_info["provider"] == "veimagex"
    assert info["models"] == jpipe.last_run_info["models"] == ["espcn"]
    assert info["step_members"] == [[["espcn", 1]]]


def test_fallbacks_match_reference():
    from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline

    assert SuperResolutionPipeline._FALLBACK_PROVIDERS == JaxPipeline._FALLBACK_PROVIDERS


@pytest.mark.parametrize("field", FIELDS)
def test_reference_fields_take_its_defaults(field):
    assert getattr(PipelineConfig(device="cpu"), field) == getattr(JaxConfig(), field)
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    assert field in names


def test_credentials_and_seedream_knobs_are_accepted():
    cfg = PipelineConfig(device="cpu", provider="seedream", seedream_strength=0.3,
                         seedream_steps=20, volc_ak="ak", volc_sk="sk", volc_region="r")
    assert (cfg.seedream_strength, cfg.seedream_steps, cfg.volc_region) == (0.3, 20, "r")


@pytest.mark.parametrize("qa_device", ["tpu", "gpu", "cuda", "cpu"])
def test_qa_device_names_the_pipelines_device_or_the_cpu(qa_device):
    pipe = SuperResolutionPipeline(PipelineConfig(device="cpu", qa_device=qa_device))
    assert pipe.quality_module.device == torch.device("cpu")


def test_qa_device_unknown_name_raises():
    with pytest.raises(ValueError, match="qa_device"):
        PipelineConfig(device="cpu", qa_device="npu")


def test_seedream_steps_key_the_tile_store():
    keys = []
    for steps in (50, 20):
        pipe = SuperResolutionPipeline(PipelineConfig(
            device="cpu", provider="seedream", enable_checkpoint=True, seedream_steps=steps,
            per_scale_selection=False, quality_model="edsr_m"))
        keys.append(pipe._resume_key("h", [2], compute_layout(64, 64, 32, 0.2), "seedream",
                                     None, None, None))
    assert keys[0] != keys[1]
