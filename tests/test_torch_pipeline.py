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

import json

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
from test_torch_tile_store import load_reference_native
from torch_packaged import packaged_in, port_store_in

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
    # routing, per-scale selection and QA off, as the reference below
    cfg = dict(block_size=64, target_resolution=TARGET, quality_model=model,
               ibp_steps=4, compute_dtype=dtype, device="cpu", auto_route=False,
               per_scale_selection=False, enable_qa=False)
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


def test_untrained_ladder_matches_reference_bicubic(image, tmp_path, monkeypatch):
    """Without weights (the store hidden) the zero-tail nets are exact
    bicubic: the port's ladder equals the reference's bicubic provider."""
    port_store_in(monkeypatch, tmp_path / "none")  # the store holds edsr_m
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
    pipe = SuperResolutionPipeline(_port(target_resolution="160x160"))
    res = pipe.process(str(tmp_path / "missing.png"), str(tmp_path / "o.tiff"))
    assert not res.success and "No such file" in res.error_message
    res = pipe.process(image, str(tmp_path / "o.xyz"))  # neither TIFF, PNG nor a PIL format
    assert not res.success and ".xyz" in res.error_message


@pytest.mark.parametrize("field,value", [("provider", "zssr"), ("sr_gain_route", "zssr")])
def test_zssr_options_are_served(field, value):
    """zssr is ported: the options build a pipeline with the reference's
    defaults (150 tuning steps); tests/test_torch_zssr.py runs them."""
    cfg = PipelineConfig(device="cpu", **{field: value})
    assert getattr(cfg, field) == getattr(JaxConfig(**{field: value}), field) == value
    assert cfg.zssr_steps == JaxConfig().zssr_steps == 150
    assert SuperResolutionPipeline(cfg).config is cfg
    # the reference's remote provider names are served as it serves them
    # (tests/test_torch_provider_aliases.py holds their pixels)
    for name in ("seedream", "veimagex"):
        assert PipelineConfig(device="cpu", provider=name).provider == \
            JaxConfig(provider=name).provider == name


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


# -- the bench path: routing, the SR-gain probe, per-scale selection and QA
# on, as bench.py:69-83 runs it, at toy size. The reference serves its
# packaged checkpoints; the port gets them converted, for the nets the
# reference's selection can serve on this ladder (edsr_xl at x2/x3/x4,
# edsr_l at x2), and the packaged LPIPS features converted.
#
# Tolerances: the TIFF within 1 LSB. Routing: the same decision, ladder and
# ladder models; the probe's gain within 0.1 dB and alpha within 0.01 (its
# nets run in bfloat16 on both sides), on inputs whose reference gain lies
# at least 0.2 dB from the floor. The report: the same keys; with the
# quality route the values within the module tests' tolerances (PSNR 1e-3
# dB, SSIM and MS-SSIM 1e-5, NIQE and BRISQUE relative 2e-2, the rest
# relative 1e-4; tests/test_torch_qa.py says where each comes from). The
# full-resolution panel scores crops of the 8-bit output, which differs by
# 1 LSB at a few samples: its other values within relative 1e-2. With the shrink route the served
# alpha may differ by 0.001 after rounding, which moves the output by
# up to 0.001 x |net - bicubic|: values within relative 2e-2.

BENCH_TARGET = "1008x864"  # 96x112 -> x9, a [3, 3] ladder
GAIN_ATOL_DB, ALPHA_ATOL, MARGIN_DB = 0.1, 0.01, 0.2


def _bench_image(h=96, w=112):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 13), 127 + 90 * np.cos(yy / 11),
                    127 + 90 * np.sin((xx + yy) / 7)], -1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def bench_weights():
    from srs_tpu.models.lpips import LPIPSMetric as JaxLPIPS
    from srs_tpu_torch.models.lpips import convert_lpips_params

    w = {k: v for k, v in _converted("edsr_xl").items()}
    _, params = jax_build("edsr_l", 2, dtype=jnp.float32)
    w[("edsr_l", 2)] = convert_flax_params(jax.tree_util.tree_map(np.asarray, params))
    jl = JaxLPIPS()
    lp = {net: convert_lpips_params(jax.tree_util.tree_map(np.asarray, jl._load_checkpoint(net)))
          for net in ("vgg", "alex")}
    return w, lp


def _bench_port(floor, **kw):
    cfg = dict(block_size=64, target_resolution=BENCH_TARGET, ibp_steps=4,
               compute_dtype="float32", device="cpu", sr_gain_floor=floor)
    return PipelineConfig(**{**cfg, **kw})


def _report_close(got, ref, rel_all=None):
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = got[k]
        if isinstance(v, str) or k == "fullres_crops":
            assert g == v, k
        elif np.isnan(v):
            assert np.isnan(g), k
        elif rel_all is not None:
            assert g == pytest.approx(v, rel=rel_all, abs=1e-6), k
        elif k.startswith("psnr"):
            assert abs(g - v) <= 1e-3, k
        elif k.startswith(("ssim", "ms_ssim")):
            assert abs(g - v) <= 1e-5, k
        elif k in ("niqe", "brisque", "fullres_niqe", "fullres_brisque"):
            assert g == pytest.approx(v, rel=2e-2), k
        elif k.startswith("fullres_"):
            assert g == pytest.approx(v, rel=1e-2), k
        else:
            assert g == pytest.approx(v, rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("floor,route", [(0.0, "quality"), (5.0, "shrink")])
def test_bench_path_matches_reference(bench_weights, tmp_path, floor, route):
    # the reference writes its TIFF with its own native writer, whatever
    # another worker's build did (test_torch_tile_store.load_reference_native)
    load_reference_native()
    image = _bench_image()
    jcfg = JaxConfig(block_size=64, overlap_ratio=0.2, target_resolution=BENCH_TARGET,
                     ibp_steps=4, sr_gain_floor=floor)
    assert jcfg.auto_route and jcfg.per_scale_selection and jcfg.enable_qa
    jpipe = JaxPipeline(jcfg)
    jpipe._ensure_engine()
    jpipe.sr_module.config.compute_dtype = "float32"
    jres = jpipe.process(image, str(tmp_path / "ref.tiff"))
    assert jres.success, jres.error_message
    ref_info = jpipe.last_run_info

    weights, lpips = bench_weights
    cfg = _bench_port(floor)
    assert cfg.auto_route and cfg.per_scale_selection and cfg.enable_qa
    pipe = SuperResolutionPipeline(cfg, weights, lpips)
    res = pipe.process(image, str(tmp_path / "out.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info

    assert abs(ref_info["sr_gain_probe"] - floor) >= MARGIN_DB
    assert abs(info["sr_gain_probe"] - ref_info["sr_gain_probe"]) <= GAIN_ATOL_DB
    for key in ("ladder", "provider", "model", "models"):
        assert info[key] == ref_info[key], key
    assert info["provider"] == route and info["ladder"] == [3, 3]
    assert info["models"] == ["edsr_xl", "edsr_xl"]
    routing = info["routing"]
    assert routing["errors"] == [] and routing["degradation"]["reason"] == "clean"
    if route == "shrink":
        assert abs(info["sr_gain_alpha"] - ref_info["sr_gain_alpha"]) <= ALPHA_ATOL
    else:
        assert info["sr_gain_alpha"] is None is ref_info["sr_gain_alpha"]
    assert set(res.stage_times) == set(jres.stage_times) == {
        "tiling", "super_resolution", "blending", "quality_assessment", "save"}

    got = read_tiff(res.output_path).astype(np.int16)
    ref = read_tiff(jres.output_path).astype(np.int16)
    assert got.shape == ref.shape == (864, 1008, 3)
    assert np.abs(got - ref).max() <= 1

    _report_close(res.quality_report, jres.quality_report,
                  rel_all=2e-2 if route == "shrink" else None)
    assert res.quality_score == res.quality_report["overall_score"]
    with open(str(tmp_path / "out_qa_report.json")) as f:
        written = json.load(f)
    assert set(written) == set(res.quality_report)


def test_shrink_alpha_is_per_job(weights, tmp_path, monkeypatch):
    """Each job serves its own probe's alpha: jobs run in a row give what
    each gives alone (the reference keeps alpha on the pipeline between
    jobs). The store is hidden: its trained robust net would take the
    noisy job."""
    packaged_in(monkeypatch, tmp_path / "none")
    clean = _bench_image()
    noise = (np.random.default_rng(9).random((96, 112, 3)) * 255).astype(np.float32)
    cfg = dict(target_resolution="336x288", quality_model="edsr_m", compute_dtype="float32")

    def run(pipe, image, name):
        res = pipe.process(image, str(tmp_path / name))
        assert res.success, res.error_message
        return read_tiff(res.output_path), dict(pipe.last_run_info), res.quality_report

    pipe = SuperResolutionPipeline(_bench_port(0.0, **cfg), weights)
    in_a_row = [run(pipe, im, f"row{i}.tiff") for i, im in enumerate((noise, clean, noise))]
    alone = [run(SuperResolutionPipeline(_bench_port(0.0, **cfg), weights), im, f"alone{i}.tiff")
             for i, im in enumerate((noise, clean))]
    assert in_a_row[0][1]["provider"] == "shrink" and in_a_row[1][1]["provider"] == "quality"
    assert in_a_row[1][1]["sr_gain_alpha"] is None
    for (img, info, report), (img1, info1, report1) in zip(in_a_row, alone + alone[:1]):
        np.testing.assert_array_equal(img, img1)
        assert info["sr_gain_alpha"] == info1["sr_gain_alpha"]
        assert json.dumps(report, sort_keys=True) == json.dumps(report1, sort_keys=True)
