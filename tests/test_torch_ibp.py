"""Port parity: back-projection (IBP) for untrained nets
(srs_tpu_torch.models.nets.back_project and the IBP branch of
SuperResolutionModule.upscale_tiles) against the JAX reference.

The reference ships no ``edsr_l`` checkpoint at x4, so that net is
untrained on both sides: a zero tail, exact bicubic, followed by IBP.

Tolerance: atol 1e-3 on float32 outputs in [0, 255] (each IBP step is a
bicubic down and up, summed in another order; 10 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.config import ModelConfig as JaxModelConfig
from srs_tpu.models.nets import back_project as jax_back_project
from srs_tpu.models.sr_module import SuperResolutionModule as JaxSR
from srs_tpu_torch.config import ModelConfig
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.models.nets import back_project
from srs_tpu_torch.models.sr_module import SuperResolutionModule
from srs_tpu_torch.ops.resize import resize_bicubic_up
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

ATOL = 1e-3


def _lr(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("degradation", ["bicubic", "area"])
@pytest.mark.parametrize("scale,shape", [(2, (2, 9, 11, 3)), (3, (1, 8, 8, 3)),
                                         (4, (2, 6, 10, 3))])
@pytest.mark.parametrize("steps", [1, 10])
def test_back_project_matches_reference(degradation, scale, shape, steps):
    lr = _lr(shape, seed=scale)
    sr = np.clip(np.asarray(resize_bicubic_up(torch.from_numpy(lr), scale))
                 + _lr((shape[0], shape[1] * scale, shape[2] * scale, 3), 9) / 10 - 12, 0, 255)
    got = back_project(torch.from_numpy(sr), torch.from_numpy(lr), scale, steps=steps,
                       degradation=degradation).numpy()
    ref = np.asarray(jax_back_project(jnp.asarray(sr), jnp.asarray(lr), scale, steps=steps,
                                      degradation=degradation))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_back_project_pulls_towards_lr_consistency():
    lr = _lr((1, 12, 12, 3), 3)
    sr = resize_bicubic_up(torch.from_numpy(lr), 2) + 20.0
    from srs_tpu_torch.ops.resize import resize_area_int

    before = (resize_area_int(sr, 2) - torch.from_numpy(lr)).abs().mean()
    after = (resize_area_int(back_project(sr, torch.from_numpy(lr), 2, steps=10,
                                          degradation="area"), 2)
             - torch.from_numpy(lr)).abs().mean()
    assert after < 0.1 * before


def test_back_project_rejects_unknown_degradation():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="degradation"):
        back_project(x, x[:, :2, :2], 2, degradation="gaussian")


@pytest.mark.parametrize("steps", [0, 3, 8])
def test_untrained_upscale_tiles_runs_ibp_as_reference(steps):
    tiles = _lr((2, 10, 12, 3), 5)
    jsr = JaxSR(config=JaxModelConfig(quality_model="edsr_l", per_scale_selection=False,
                                      auto_route=False))
    ref = np.asarray(jsr.upscale_tiles(jnp.asarray(tiles), 4, steps=steps))
    assert not jsr._net_trained("quality", 4)  # no packaged edsr_l x4
    sr = SuperResolutionModule(ModelConfig(quality_model="edsr_l", per_scale_selection=False,
                                           auto_route=False), device="cpu")
    assert not sr.is_trained("edsr_l", 4)
    got = sr.upscale_tiles(torch.from_numpy(tiles), 4, steps=steps).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    bicubic = np.clip(np.asarray(resize_bicubic_up(torch.from_numpy(tiles), 4)), 0, 255)
    assert (np.abs(got - bicubic).max() > 1.0) == (steps > 0)


def test_default_config_without_weights_writes_a_tiff(tmp_path):
    """The reference's defaults (edsr_xl, routing, per-scale selection, QA,
    8 IBP steps) with no weights handed in: every net is untrained and
    IBP runs on the last ladder step. Small target and block, on the CPU."""
    img = _lr((40, 56, 3), 8)
    cfg = PipelineConfig(device="cpu", target_resolution="168x120", block_size=32)
    assert cfg.ibp_steps == 8 and cfg.quality_model == "edsr_xl"
    pipe = SuperResolutionPipeline(cfg)
    res = pipe.process(img, str(tmp_path / "o.tiff"))
    assert res.success, res.error_message
    assert read_tiff(res.output_path).shape == (120, 168, 3)
    assert pipe.last_run_info["ladder"] == [3]
    assert not pipe.sr_module.is_trained("edsr_xl", 3)
    assert np.isfinite(res.quality_score)
