"""Port parity: the prompt templates, the conditioning vectors and the
prompt-conditioned polish through ``process(prompt=...)``
(srs_tpu_torch.models.prompts, .conditioning, pipeline) against the JAX
package.

Tolerances: templates, prompts, ids and vectors exact; ``process()`` as
tests/test_torch_provider_pipeline.py holds it (float32 convolutions,
at most 1 LSB on under 1% of samples).
"""

import numpy as np
import pytest

from srs_tpu.models.conditioning import CATEGORY_CONDITIONING as JAX_CONDITIONING
from srs_tpu.models.conditioning import COND_DIM as JAX_COND_DIM
from srs_tpu.models.conditioning import cond_vector as jax_cond_vector
from srs_tpu.models.prompts import PromptTemplateManager as JaxTemplates
from srs_tpu.models.prompts import category_id as jax_category_id
from srs_tpu_torch.models.conditioning import (
    CATEGORY_CONDITIONING,
    COND_DIM,
    apply_cond_polish,
    cond_vector,
)
from srs_tpu_torch.models.prompts import PromptTemplateManager, category_id
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from test_torch_provider_pipeline import TARGETS, image, run_both  # noqa: F401 - the fixture
from test_torch_providers import converted

CATEGORIES = list(JaxTemplates.TEMPLATES) + ["no-such-category"]
TRAINED = [("edsr_m", 2), ("cond_polish", 1)]


def test_templates_are_the_reference_templates():
    assert PromptTemplateManager.TEMPLATES == JaxTemplates.TEMPLATES
    assert PromptTemplateManager.list_categories() == JaxTemplates.list_categories()
    assert CATEGORY_CONDITIONING == JAX_CONDITIONING and COND_DIM == JAX_COND_DIM


@pytest.mark.parametrize("category", CATEGORIES)
def test_prompt_id_and_vector_per_category(category):
    for kw in ({}, {"custom_subject": "a teapot"}, {"extra_requirements": "no text"},
               {"include_negative": False}):
        assert PromptTemplateManager.build_prompt(category, **kw) == \
            JaxTemplates.build_prompt(category, **kw)
    assert PromptTemplateManager.get_template(category) == JaxTemplates.get_template(category)
    assert category_id(category) == jax_category_id(category)
    np.testing.assert_array_equal(cond_vector(category).numpy(),
                                  np.asarray(jax_cond_vector(category)))


def test_apply_cond_polish_is_the_identity_without_weights_and_steers_with_them(image):
    import torch

    x = torch.from_numpy(image[None])
    with torch.inference_mode():
        same = apply_cond_polish(x, "food", dtype="float32")
        food = apply_cond_polish(x, "food", converted("cond_polish", 1), dtype="float32")
        tech = apply_cond_polish(x, "3c", converted("cond_polish", 1), dtype="float32")
    torch.testing.assert_close(same, x, atol=1e-4, rtol=0)
    assert (food - x).abs().max() > 1.0 and (food - tech).abs().max() > 0.05


def test_process_with_a_category_prompt_matches_reference(image, tmp_path, monkeypatch):
    ref, jpipe, got, pipe = run_both(image, tmp_path, monkeypatch, TRAINED, 2, prompt="food")
    info = pipe.last_run_info
    assert info["prompt_category"] == "food" and info["conditioned"]
    # the prompt changed the pixels: the same job unconditioned
    res = pipe.process(image, str(tmp_path / "plain.tiff"))
    from srs_tpu_torch.io.native import read_tiff

    plain = read_tiff(res.output_path).astype(np.int16)
    assert np.abs(plain - got).max() > 2
    assert pipe.last_run_info["prompt_category"] is None
    # a prompt that names no category is only text: the unconditioned image
    res = pipe.process(image, str(tmp_path / "text.tiff"), prompt="a red teapot")
    np.testing.assert_array_equal(read_tiff(res.output_path), plain)


def test_prompt_category_in_the_config_and_the_prompt_override(image, tmp_path, monkeypatch):
    """``prompt_category`` conditions every job; a category prompt takes its
    place for one job."""
    _, _, got, _ = run_both(image, tmp_path, monkeypatch, TRAINED, 2, prompt="beauty",
                            prompt_category="3c")
    weights = {k: converted(*k) for k in TRAINED}
    cfg = dict(block_size=32, target_resolution=TARGETS[2], auto_route=False, enable_qa=False,
               ibp_steps=4, per_scale_selection=False, quality_model="edsr_m",
               compute_dtype="float32", device="cpu")
    from srs_tpu_torch.io.native import read_tiff

    a = SuperResolutionPipeline(PipelineConfig(prompt_category="beauty", **cfg), weights)
    res = a.process(image, str(tmp_path / "a.tiff"))
    np.testing.assert_array_equal(read_tiff(res.output_path).astype(np.int16), got)
    b = SuperResolutionPipeline(PipelineConfig(prompt_category="3c", **cfg), weights)
    res = b.process(image, str(tmp_path / "b.tiff"))
    assert b.last_run_info["prompt_category"] == "3c"
    assert np.abs(read_tiff(res.output_path).astype(np.int16) - got).max() > 0
