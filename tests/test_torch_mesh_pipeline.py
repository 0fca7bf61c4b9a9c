"""Port parity: ``process()`` on a device mesh (``PipelineConfig(
mesh_shape=...)``), on the CPU.

The port's mesh on the CPU is the CPU repeated to the mesh's size; the
JAX package's is its 8 virtual CPU devices (``tests/conftest.py``). No
weights on either side (the reference's packaged checkpoints hidden), so
every net is the zero-tail bicubic net with IBP on the last step.

- ``{"data": 8}``, provider ``fast``, at the size of the reference's
  ``test_mesh_pipeline_8dev``: against the JAX pipeline with the same
  mesh, within 1 LSB on under 1% of samples (the command line's parity
  tolerance).
- ``{"data": 2, "space": 2}`` at 3 levels (ny = 4): the sharded blend
  runs; the TIFF is within 1 LSB of the port's single-device ``process()``
  on all but 1e-3 of samples, and within 1 LSB of the JAX package's
  sharded blend and finalize of the very tiles it blended. The JAX
  pipeline's own space-sharded ``process()`` is a ``slow`` test there
  (shard_map compile time), so it is not run here.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import srs_tpu.models.registry as jax_registry
from srs_tpu.parallel import finalize as jax_finalize
from srs_tpu.parallel import halo as jax_halo
from srs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu.tiling.geometry import TileLayout as JaxLayout
from srs_tpu_torch.io.image import save_image
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.parallel import MeshTileDispatcher, make_mesh
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

# tests/test_pipeline.py's _cfg, less the knobs the port lacks
CFG = dict(block_size=64, overlap_ratio=0.2, target_resolution="320x240", provider="bicubic",
           num_pyramid_levels=4, enable_qa=True, ibp_steps=2)


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    """tests/test_pipeline.py's input: 160x120 sine fields and noise."""
    r = np.random.default_rng(5)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 13), 127 + 90 * np.cos(yy / 11),
                    127 + 90 * np.sin((xx + yy) / 7)], -1)
    img = np.clip(img + r.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("mesh") / "input.png")
    save_image(path, img)
    return path


@pytest.fixture(scope="module")
def square_png(tmp_path_factory):
    """tests/test_pipeline.py's space-sharded input: 160x160, ny = 4 at block 64."""
    r = np.random.default_rng(9)
    img = np.clip(127 + 90 * np.sin(np.mgrid[0:160, 0:160][1].astype(np.float32) / 11)[..., None]
                  + r.normal(0, 2, (160, 160, 1)), 0, 255).astype(np.uint8).repeat(3, axis=-1)
    path = str(tmp_path_factory.mktemp("mesh_sq") / "in.png")
    save_image(path, img)
    return path


def _close(got, ref, share):
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


def _port(path, out, **kw):
    pipe = SuperResolutionPipeline(PipelineConfig(**{**CFG, "device": "cpu", **kw}))
    res = pipe.process(path, out)
    assert res.success, res.error_message
    return read_tiff(out), pipe


def test_data_mesh_matches_reference(input_png, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_registry, "PACKAGED_CHECKPOINT_DIR", str(tmp_path / "none"))
    jpipe = JaxPipeline(JaxConfig(**{**CFG, "provider": "fast", "mesh_shape": {"data": 8},
                                     "enable_qa": False}))
    jpipe._ensure_engine()
    jpipe.sr_module.config.checkpoint_dir = str(tmp_path / "empty")
    ref_path = str(tmp_path / "ref.png")
    res = jpipe.process(input_png, ref_path)
    assert res.success, res.error_message
    assert jpipe.dispatcher.num_devices == 8
    with Image.open(ref_path) as im:
        ref = np.asarray(im)

    got, pipe = _port(input_png, str(tmp_path / "out.tiff"), provider="fast",
                      mesh_shape={"data": 8}, enable_qa=False)
    assert pipe.dispatcher is not None and pipe.dispatcher.num_devices == 8
    info = pipe.last_run_info
    assert info["provider"] == "fast" and info["ladder"] == jpipe.last_run_info["ladder"]
    assert info["mesh"]["shape"] == {"data": 8} and info["mesh"]["devices"] == 1
    assert info["mesh"]["sharded_blend"] is False  # no space axis
    assert got.shape == (240, 320, 3)
    _close(got, ref, 1e-2)


SPACE = dict(block_size=64, target_resolution="320x320", provider="fast", enable_qa=False,
             num_pyramid_levels=3)


@pytest.fixture(scope="module")
def space_run(square_png, tmp_path_factory):
    """The 2x2 mesh's run, with the tiles and layout its blend received."""
    tmp = tmp_path_factory.mktemp("space")
    pipe = SuperResolutionPipeline(PipelineConfig(**{**CFG, **SPACE, "device": "cpu",
                                                     "mesh_shape": {"data": 2, "space": 2}}))
    seen = {}
    blend = pipe.dispatcher.laplacian_blend

    def recorded(tiles, profiles, layout, **kw):
        seen.update(tiles=tiles.clone(), profiles=profiles, layout=layout, kw=kw)
        return blend(tiles, profiles, layout, **kw)

    pipe.dispatcher.laplacian_blend = recorded
    out = str(tmp / "mesh.tiff")
    res = pipe.process(square_png, out)
    assert res.success, res.error_message
    return read_tiff(out), pipe, seen


def test_space_mesh_takes_the_sharded_blend(space_run):
    got, pipe, seen = space_run
    mesh = pipe.last_run_info["mesh"]
    assert mesh["sharded_blend"] is True and mesh["gather_fallback"] is False
    assert mesh["shape"] == {"data": 2, "space": 2} and mesh["halo_bytes"] > 0
    assert seen["layout"].ny == 4 and seen["kw"]["collapse_last"] is False
    assert got.shape == (320, 320, 3)


def test_space_mesh_matches_single_device(space_run, square_png, tmp_path):
    got, _pipe, _seen = space_run
    single, spipe = _port(square_png, str(tmp_path / "single.tiff"), **SPACE)
    assert spipe.dispatcher is None
    _close(got, single, 1e-3)


def test_space_mesh_matches_reference_blend_and_finalize(space_run):
    """The tiles the mesh run blended, through the JAX package's sharded
    blend and sharded finalize: the same pixels within 1 LSB."""
    got, pipe, seen = space_run
    lo = seen["layout"]
    jlo = JaxLayout(**dataclasses.asdict(lo))
    sc = jax_halo.sharded_laplacian_blend(
        jnp.asarray(seen["tiles"].numpy()), *seen["profiles"], jlo,
        jax_make_mesh({"space": 2}), levels=SPACE["num_pyramid_levels"], collapse_last=False)
    assert isinstance(sc, jax_finalize.ShardedCanvas)
    assert pipe.last_run_info["ladder"] == [2] and lo.image_h == lo.image_w == 320
    ref = jax_finalize.sharded_finalize_banded(sc, 320, 320, bands=8, crop_h=lo.image_h,
                                               crop_w=lo.image_w, to_uint8=True)
    _close(got, ref, 1.0)


def test_space_mesh_with_seam_repair_blends_on_one_device(square_png, tmp_path):
    _got, pipe = _port(square_png, str(tmp_path / "repair.tiff"), **SPACE,
                       mesh_shape={"data": 2, "space": 2}, enable_seam_repair=True)
    assert pipe.last_run_info["mesh"]["sharded_blend"] is False
    assert "seam_repair" in pipe.last_run_info


def test_virtual_mesh_handed_in_and_qa_proxy(square_png, tmp_path):
    """A dispatcher set on the pipeline after construction serves the job
    (the hook the card's virtual mesh uses); with QA on, the proxy comes
    from the sharded finalize and the report is complete."""
    pipe = SuperResolutionPipeline(PipelineConfig(**{**CFG, **SPACE, "device": "cpu",
                                                     "enable_qa": True}))
    assert pipe.dispatcher is None
    pipe.dispatcher = MeshTileDispatcher(make_mesh({"data": 2, "space": 2},
                                                   [torch.device("cpu")] * 4))
    res = pipe.process(square_png, str(tmp_path / "qa.tiff"))
    assert res.success, res.error_message
    assert pipe.last_run_info["mesh"]["sharded_blend"] is True
    single = SuperResolutionPipeline(PipelineConfig(**{**CFG, **SPACE, "device": "cpu",
                                                       "enable_qa": True}))
    ref = single.process(square_png, str(tmp_path / "qa_single.tiff"))
    for key in ("psnr", "ssim"):
        assert abs(res.quality_report[key] - ref.quality_report[key]) < 1e-2, key


def test_nets_are_copied_once_per_other_device(input_png):
    """A shard on another device gets copies of the built nets, made once
    and reused while the source net is the same. (On the CPU every shard's
    tensors report the one CPU device, so the view is asked for directly.)"""
    pipe = SuperResolutionPipeline(PipelineConfig(**{**CFG, "provider": "fast",
                                                     "device": "cpu"}))
    pipe.sr_module.build_nets([2], "fast")
    other = torch.device("cpu", 0)
    view = pipe._sr_for(other)
    assert pipe._sr_for(torch.device("cpu")) is pipe.sr_module
    (key, net), = pipe.sr_module._nets.items()
    copy1 = view._nets[key]
    assert copy1 is not net and pipe._sr_for(other)._nets[key] is copy1
    for a, b in zip(net.parameters(), copy1.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a net built anew (a retuned zssr net, say) is copied anew
    pipe.sr_module._nets[key] = copy.deepcopy(net)
    assert pipe._sr_for(other)._nets[key] is not copy1
