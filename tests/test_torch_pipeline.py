"""Port parity: the whole quality slice. ``process()`` of the JAX reference
and of srs_tpu_torch on the same input, with the same trained weights (the
packaged checkpoints, converted), at toy size: 80x80 -> 720x720 on a
[3, 3] ladder, block 64, six-level blend, banded finalize and streamed
TIFF. The float32 case serves ``edsr_xl`` as the main path does; the
bfloat16 case serves ``edsr_m``, because XLA's bf16 convolutions on the
CPU are too slow for ``edsr_xl`` in a unit test.

The reference saves a PNG (PIL) and the port its streamed TIFF; the
pixels are compared. Tolerances: float32 nets on both sides: the outputs
differ by at most 1 LSB on under 0.1% of samples (float32 sums in another
order flip rounding ties). bfloat16 nets: PSNR between the outputs >= 45 dB
(the two frameworks round bf16 at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srs_tpu.models.registry import build_model as jax_build
from srs_tpu.models.sr_module import scale_ladder as jax_ladder
from srs_tpu.pipeline import PipelineConfig as JaxConfig, SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.io.native import TiffStreamWriter, read_tiff
from srs_tpu_torch.models.registry import build_model, convert_flax_params
from srs_tpu_torch.models.sr_module import SuperResolutionModule, scale_ladder
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from srs_tpu_torch.tiling.tiling import TilingModule

BF16_PSNR_FLOOR = 45.0
TARGET = "720x720"


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:80, 0:80].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 13), 127 + 90 * np.cos(yy / 11),
                    127 + 90 * np.sin((xx + yy) / 7)], -1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.float32)


def _converted(name):
    """Converted packaged weights of ``name`` at every scale the reference
    ships trained, so both sides choose the same ladder."""
    out = {}
    for s in (2, 3, 4):
        _, params = jax_build(name, s, dtype=jnp.float32)
        out[(name, s)] = convert_flax_params(jax.tree_util.tree_map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def weights():
    return _converted("edsr_m")


def _port(dtype="float32", model="edsr_m", **kw):
    cfg = dict(block_size=64, target_resolution=TARGET, quality_model=model,
               ibp_steps=4, compute_dtype=dtype, device="cpu")
    cfg.update(kw)
    return PipelineConfig(**cfg)


def _reference(image, path, dtype="float32", provider="quality", model="edsr_m"):
    """The reference's output for ``image`` as an int16 array. It saves a
    PNG (PIL), so the reference's own native TIFF build is not involved."""
    cfg = JaxConfig(block_size=64, overlap_ratio=0.2, target_resolution=TARGET,
                    provider=provider, quality_model=model, auto_route=False,
                    per_scale_selection=False, enable_qa=False, ibp_steps=4)
    pipe = JaxPipeline(cfg)
    pipe._ensure_engine()
    pipe.sr_module.config.compute_dtype = dtype
    res = pipe.process(image, path)
    assert res.success, res.error_message
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16), pipe


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_process_matches_reference_float32(image, tmp_path):
    ref, jpipe = _reference(image, str(tmp_path / "ref.png"), model="edsr_xl")
    pipe = SuperResolutionPipeline(_port(model="edsr_xl"), _converted("edsr_xl"))
    res = pipe.process(image, str(tmp_path / "out.tiff"))
    assert res.success, res.error_message
    assert set(res.stage_times) == {"tiling", "super_resolution", "blending", "save"}
    assert pipe.last_run_info["ladder"] == jpipe.last_run_info["ladder"] == [3, 3]
    got = read_tiff(res.output_path).astype(np.int16)
    assert got.shape == ref.shape == (720, 720, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_process_matches_reference_bf16(image, weights, tmp_path):
    ref, _ = _reference(image, str(tmp_path / "ref.png"), dtype="bfloat16")
    res = SuperResolutionPipeline(_port("bfloat16"), weights).process(
        image, str(tmp_path / "out.tiff"))
    assert res.success, res.error_message
    assert _psnr(read_tiff(res.output_path), ref) >= BF16_PSNR_FLOOR


def test_untrained_ladder_matches_reference_bicubic(image, tmp_path):
    """Without weights the zero-tail nets are exact bicubic: the port's
    ladder equals the reference's bicubic provider."""
    ref, _ = _reference(image, str(tmp_path / "ref.png"), provider="bicubic")
    res = SuperResolutionPipeline(_port(ibp_steps=0)).process(image, str(tmp_path / "o.tiff"))
    assert res.success, res.error_message
    diff = np.abs(read_tiff(res.output_path).astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert PipelineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuperResolutionPipeline(PipelineConfig())


@pytest.mark.parametrize("entry", ["sr_module", "build_model", "split_to_batch"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = {
        "sr_module": lambda: SuperResolutionModule(),
        "build_model": lambda: build_model("edsr_m", 2),
        "split_to_batch": lambda: TilingModule(64).split_to_batch(np.zeros((8, 8, 3))),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_process_returns_failure_instead_of_raising(image, tmp_path):
    pipe = SuperResolutionPipeline(_port())
    res = pipe.process(image, str(tmp_path / "o.tiff"))  # untrained, ibp_steps=4
    assert not res.success and "back_project" in res.error_message
    res = pipe.process(image, str(tmp_path / "o.png"))
    assert not res.success and "TIFF" in res.error_message


@pytest.mark.parametrize("field,value", [("enable_qa", True), ("auto_route", True),
                                         ("per_scale_selection", True), ("provider", "fast"),
                                         ("blend_method", "weighted")])
def test_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        PipelineConfig(device="cpu", **{field: value})


@pytest.mark.parametrize("size,target", [((1280, 720), "100MP"), ((720, 1280), "150MP"),
                                         ((1000, 1000), "200MP"), ((80, 80), "720x720"),
                                         ((64, 48), "bogus")])
def test_target_size_matches_reference(size, target):
    got = SuperResolutionPipeline(_port())._calculate_target_size(size, target)
    assert got == JaxPipeline._calculate_target_size(None, size, target)


@pytest.mark.parametrize("trained", [None, {2, 3, 4}, {2, 3}, set()])
def test_scale_ladder_matches_reference(trained):
    for total in (1.0, 1.5, 2.0, 3.2, 4.0, 5.0, 7.9, 9.566, 15.0):
        assert scale_ladder(total, trained=trained) == jax_ladder(total, trained=trained)


@pytest.mark.parametrize("bit_depth,compress", [(8, True), (8, False), (16, True)])
def test_tiff_roundtrip(tmp_path, bit_depth, compress):
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    img = np.random.default_rng(0).integers(0, np.iinfo(dtype).max, (70, 33, 3)).astype(dtype)
    path = str(tmp_path / "r.tiff")
    with TiffStreamWriter(path, 70, 33, bit_depth=bit_depth, compress=compress) as w:
        for r0 in range(0, 70, 16):
            w.write(img[r0 : r0 + 16])
    np.testing.assert_array_equal(read_tiff(path), img)
