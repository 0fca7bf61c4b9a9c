"""Port parity: ``process()`` with the fast and hybrid providers, the
self-ensemble and RCAN against the JAX package's pipeline (fusion:
test_torch_provider_fusion.py; the prompt: test_torch_conditioning.py),
at toy size: a 32x48 input (two 32-px tiles), routing and QA off,
float32 convolutions on both sides, the packaged trained checkpoints
(converted for the port) for exactly the nets each case names, the
reference loading them from a checkpoint directory of its own (its
packaged directory hidden).

The reference saves a PNG (PIL) and the port its streamed TIFF; the
pixels are compared. Tolerance: at most 1 LSB, on under 1% of samples
(float32 sums in another order flip rounding ties).
"""

import os

import numpy as np
import pytest
from PIL import Image

from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from test_torch_providers import PACKAGED, converted
from torch_packaged import packaged_in

TARGETS = {2: "96x64", 3: "144x96"}


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 5), 127 + 90 * np.cos(yy / 4),
                    127 + 90 * np.sin((xx + yy) / 3)], -1)
    img[8:20, 20:34] = (230, 30, 60)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.float32)


def run_both(image, tmp_path, monkeypatch, trained, scale, prompt=None, hook=None, **cfg):
    """(reference pixels, reference pipeline, port pixels, port pipeline);
    ``hook(pipeline)`` runs on each side's pipeline before its job."""
    d = tmp_path / "ckpt"
    d.mkdir()
    for name, s in trained:
        os.symlink(os.path.join(PACKAGED, f"{name}_x{s}"), d / f"{name}_x{s}")
    weights = {key: converted(*key) for key in trained}
    packaged_in(monkeypatch, tmp_path / "none")
    common = dict(block_size=32, target_resolution=TARGETS[scale], auto_route=False,
                  enable_qa=False, ibp_steps=4)
    common.update(per_scale_selection=False, quality_model="edsr_m")
    common.update(cfg)
    jpipe = JaxPipeline(JaxConfig(**common))
    jpipe._ensure_engine()
    jpipe.sr_module.config.checkpoint_dir = str(d)
    jpipe.sr_module.config.compute_dtype = "float32"
    ref_path = str(tmp_path / "ref.png")
    if hook is not None:
        hook(jpipe)
    res = jpipe.process(image, ref_path, prompt=prompt)
    assert res.success, res.error_message
    with Image.open(ref_path) as im:
        ref = np.asarray(im).astype(np.int16)
    pipe = SuperResolutionPipeline(PipelineConfig(compute_dtype="float32", device="cpu",
                                                  **common), weights)
    if hook is not None:
        hook(pipe)
    res = pipe.process(image, str(tmp_path / "out.tiff"), prompt=prompt)
    assert res.success, res.error_message
    got = read_tiff(res.output_path).astype(np.int16)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())
    assert pipe.last_run_info["ladder"] == jpipe.last_run_info["ladder"] == [scale]
    return ref, jpipe, got, pipe


def test_fast(image, tmp_path, monkeypatch):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("espcn", s) for s in (2, 3, 4)], 3, provider="fast")
    info = pipe.last_run_info
    assert info["provider"] == "fast" and info["models"] == jpipe.last_run_info["models"]
    assert info["step_members"] == [[["espcn", 1]]]


def test_hybrid_polishes_an_untrained_net(image, tmp_path, monkeypatch):
    """edsr_m untrained, espcn_polish trained: the polish, then IBP."""
    ref, _, _, pipe = run_both(image, tmp_path, monkeypatch, [("espcn_polish", 1)], 2,
                               provider="hybrid")
    assert pipe.last_run_info["step_members"] == [[["edsr_m", 1], ["espcn_polish", 1]]]
    # the same job without the polish's weights is another image
    plain = SuperResolutionPipeline(PipelineConfig(
        block_size=32, target_resolution=TARGETS[2], auto_route=False, enable_qa=False,
        ibp_steps=4, per_scale_selection=False, quality_model="edsr_m", provider="hybrid",
        compute_dtype="float32", device="cpu"))
    res = plain.process(image, str(tmp_path / "plain.tiff"))
    assert np.abs(read_tiff(res.output_path).astype(np.int16) - ref).max() > 2


def test_self_ensemble_with_selection(image, tmp_path, monkeypatch):
    """With the ensemble on, selection reads photo_panel_ensemble: x3 serves
    edsr_l (1.080) over edsr_xl (1.073), 8 passes."""
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("edsr_xl", 3), ("edsr_l", 3)], 3, self_ensemble=True,
                                 per_scale_selection=True, quality_model="edsr_xl")
    info = pipe.last_run_info
    assert info["models"] == jpipe.last_run_info["models"] == ["edsr_l"]
    assert info["step_members"] == jpipe.last_run_info["step_members"] == [[["edsr_l", 8]]]
    assert info["self_ensemble"]


def test_fast_with_the_ensemble_serves_the_fast_net(image, tmp_path, monkeypatch):
    """The reference's staged rule (pipeline.py:395-415) reads whether the
    quality net is trained from its cache of built nets: a fresh ``fast``
    job has built none, so both sides serve the fast net (espcn) ensembled,
    though edsr_m, the quality net, is trained at the step."""
    _, _, _, pipe = run_both(image, tmp_path, monkeypatch,
                             [("edsr_m", 3)] + [("espcn", s) for s in (2, 3, 4)], 3,
                             provider="fast", self_ensemble=True)
    info = pipe.last_run_info
    assert info["provider"] == "fast"
    assert info["models"] == ["espcn"] and info["step_members"] == [[["espcn", 8]]]


def _fail_quality(pipe):
    """Each quality-tier SR batch runs, then fails: the quality nets are
    built, and the job degrades to ``fast``."""
    real = pipe._upscale_batch

    def failing(tiles, ladder, provider=None, *args, **kwargs):
        out = real(tiles, ladder, provider, *args, **kwargs)
        if (provider or pipe.config.provider) != "fast":
            raise RuntimeError("injected device failure after the batch")
        return out

    pipe._upscale_batch = failing


def test_fast_fallback_with_the_ensemble_serves_the_built_quality_net(image, tmp_path,
                                                                       monkeypatch):
    """The rule's other side: a quality job with the ensemble fails four
    times and degrades to ``fast``; its quality net is built by then, so
    both sides' staged rule serves edsr_m ensembled on the degraded
    ladder."""
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("edsr_m", 2)] + [("espcn", s) for s in (2, 3, 4)], 2,
                                 self_ensemble=True, hook=_fail_quality)
    info = pipe.last_run_info
    assert info["provider"] == jpipe.last_run_info["provider"] == "fast"
    assert info["sr_degradations"] == jpipe.last_run_info["sr_degradations"] == 1
    assert info["models"] == ["edsr_m"] and info["step_members"] == [[["edsr_m", 8]]]


def test_hybrid_with_the_ensemble_skips_the_polish(image, tmp_path, monkeypatch):
    """The same rule on ``hybrid`` with a trained quality net: the quality
    net ensembled, and no hybrid polish though it is trained."""
    _, _, _, pipe = run_both(image, tmp_path, monkeypatch,
                             [("edsr_m", 2), ("espcn_polish", 1)], 2,
                             provider="hybrid", self_ensemble=True)
    assert pipe.last_run_info["step_members"] == [[["edsr_m", 8]]]


def test_rcan(image, tmp_path, monkeypatch):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("rcan", s) for s in (2, 3, 4)], 3, quality_model="rcan")
    assert pipe.last_run_info["models"] == jpipe.last_run_info["models"] == ["rcan"]
