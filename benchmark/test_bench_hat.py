"""The HAT cell's pieces of the benchmark on the CPU: the plain reference
(``yardstick/nets/hat.py``) against the program's plain route, its FLOP
count, a toy HAT cell through ``run.run_cell`` with seeded weights
(correct, and not correct with another seed's weights), the readers
of the HAT cell on synthetic records, and the float8 control reaching the
attention's products."""

import json
import os
import types

import pytest
import torch

import cpu_cell
import run
from yardstick import flops, reference, weights
from yardstick.nets import load

HERE = os.path.dirname(os.path.abspath(__file__))
hat = load("hat")

# The toy widths (the program's registry entry is patched to them where the
# program serves the toy): embed 24, 2 groups of 2 HABs, 2 heads, window 8,
# overlap 0.5, compress 3, squeeze 4.
TOY = {"kind": "hat", "embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2], "window_size": 8,
       "overlap_ratio": 0.5, "compress_ratio": 3, "squeeze_factor": 4, "conv_scale": 0.01,
       "mlp_ratio": 2, "img_range": 1.0, "num_feat": 16, "channels": 3}
PORT_KW = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8, overlap_ratio=0.5,
               compress_ratio=3, squeeze_factor=4, conv_scale=0.01, mlp_ratio=2.0, num_feat=16)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _toy_input(n=1, h=20, w=28, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, h, w, 3), generator=g) * 255


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_reference_equals_the_programs_plain_route(scale):
    from srs_tpu_torch.models.nets import HAT

    torch.set_num_threads(2)
    sd = hat.init(TOY, scale, torch.Generator().manual_seed(9))
    net = HAT(scale, dtype=torch.float32, **PORT_KW)
    net.load_state_dict(sd)
    x = _toy_input()
    with torch.no_grad():
        got = net.eval()(x)
        want = hat.forward(sd, TOY, scale, x, reference.Ops("fp32"))
    assert got.shape == want.shape == (1, 20 * scale, 28 * scale, 3)
    # float32 on both sides, the same arithmetic in another order
    assert float((got - want).abs().max()) < 1e-3


def test_flops_of_the_configuration():
    cfg = _config("hat-100mp")
    assert hat.flops_per_pixel(cfg["nets"]["hat"], 3) == 49887576
    assert flops.image_flops(cfg) == 49887576 * 512 * 512 * 6 * 10
    assert round(flops.image_flops(cfg) / 1e12, 1) == 784.7
    work = hat.image_attention(cfg)
    # q, k, v and the output in bfloat16, 42 launches a pixel: 951 GB an image
    assert round(sum(b for _f, b in work.values()) / 1e9) == 951
    assert work["hab"][0] / work["hab"][1] == pytest.approx(128.0)
    assert work["ocab"][0] / work["ocab"][1] == pytest.approx(288.0)


def test_convs_follow_the_programs_launch_order(monkeypatch):
    """Each convolution's shape and epilogue form in the order the
    program's ``nets.Conv2d`` calls launch them."""
    from srs_tpu_torch.models import nets
    from srs_tpu_torch.ops.cuda import epilogue

    calls = []

    def plain(y, bias=None, relu=False, residual=None, res_scale=1.0, act=None):
        form = "residual" if residual is not None else act or ("relu" if relu else "bias")
        calls.append((y.shape[1], form))
        return orig(y, bias, relu, residual, res_scale, act)

    orig = epilogue.conv_epilogue_plain
    monkeypatch.setattr(epilogue, "conv_epilogue_plain", plain)
    net = nets.HAT(3, dtype=torch.float32, **PORT_KW)
    with torch.no_grad():
        net(_toy_input(h=16, w=16))
    assert calls == [(co, form) for co, _ci, _kh, _kw, form, _a in hat.convs(TOY, 3)]


# -- a toy HAT cell -----------------------------------------------------------------

# A toy cell at a quarter of the CPU toy's pixels (72x128 to 9x on tiles of
# 64, one job a call): the toy HAT costs ~1 MFLOP a pixel on the CPU.
TOY_TRAFFIC = {"name": "cpu-toy-hat", "entry": "process", "jobs_per_call": 1, "workers": 1,
               "check_jobs": [[0, 0], [1, 1]],
               "input": {"size": 128, "rows": [28, 100], "pool": [2, 21]}}
TOY_CONFIG = {
    **cpu_cell.CONFIG, "name": "cpu-toy-hat",
    "pipeline": {**cpu_cell.CONFIG["pipeline"], "block_size": 64, "target_resolution": "1152x648",
                 "quality_model": "hat", "auto_route": False},
    "route": {"provider": "quality", "model": None, "ladder": [3, 3],
              "steps": [[["hat", 1]], [["hat", 1]]], "tiles": 6, "block": 64},
    "nets": {"hat": {**TOY, "weights": {"seed": 21}}},
    "check": {},  # set below from the toy's own readings
}
# Set from the toy's own readings on the CPU (seeds 5 and 6, the worse of
# the two checked jobs; the program in bfloat16 against the float32
# reference): 0.1258 LSB, 0.0088 dB, SSIM 2.6e-4, MS-SSIM 4.4e-4, LPIPS vgg
# 2.7e-4, alex 6.6e-4; each limit two to four times its reading.
TOY_CONFIG["check"] = {"tiff_mean_abs_lsb": 0.3, "qa_psnr_gap_db": 0.03, "qa_ssim_gap": 8e-4,
                       "qa_ms_ssim_gap": 1e-3, "qa_lpips_vgg_gap": 1e-3,
                       "qa_lpips_alex_gap": 2e-3}


@pytest.fixture
def toy_registry(monkeypatch):
    from srs_tpu_torch.models import nets, registry

    monkeypatch.setitem(registry.MODEL_REGISTRY, "hat",
                        registry.ModelSpec("hat", nets.HAT, dict(PORT_KW), "toy HAT",
                                           in_px_bytes=registry.HAT_IN_PX_BYTES))
    registry.clear_param_cache()
    yield
    registry.clear_param_cache()


def _run(tmp_path, fault=None, seed=5):
    torch.set_num_threads(2)
    return run.run_cell(cpu_cell.CELL, TOY_CONFIG, TOY_TRAFFIC, cpu_cell.END_TO_END, [],
                        seed, 0.0, False, device="cpu", cache_dir=str(tmp_path / "cache"),
                        log=lambda s: None, fault=fault)


def test_a_toy_hat_cell_is_correct(tmp_path, toy_registry):
    res = _run(tmp_path)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["check"]["route_differs"]["value"] == 0


def test_a_toy_hat_cell_with_another_seeds_weights_is_not_correct(tmp_path, toy_registry):
    other = weights.seeded({**TOY_CONFIG, "nets": {"hat": {**TOY, "weights": {"seed": 22}}}})

    def swap(pipe):
        pipe.sr_module.weights[("hat", 3)] = other[("hat", 3)]
        pipe.sr_module._nets.clear()  # the nets the warm-up built

    res = _run(tmp_path, fault=swap)
    assert not res["correct"]
    assert res["check"]["route_differs"]["value"] == 0
    tiff = res["check"]["tiff_mean_abs_lsb"]
    assert tiff["value"] > tiff["limit"], res["check"]


@pytest.mark.parametrize("program", ["without_hat", "not_loaded"])
def test_a_program_without_hat_stops_in_the_set_up(monkeypatch, program):
    """A program whose registry has no ``hat`` would serve the cell by another
    net through its job layer: the weights' draw stops the run first. With no
    program loaded (the reference alone) the draw runs."""
    import sys

    from srs_tpu_torch.models import registry

    cfg = _config("hat-100mp")
    cfg["nets"]["hat"] = {**TOY, "weights": cfg["nets"]["hat"]["weights"]}
    if program == "not_loaded":
        monkeypatch.delitem(sys.modules, "srs_tpu_torch.models.registry")
        assert set(weights.seeded(cfg)) == {("hat", 3)}
        return
    monkeypatch.delitem(registry.MODEL_REGISTRY, "hat")
    with pytest.raises(RuntimeError, match="no 'hat' net"):
        weights.seeded(cfg)


# -- the readers ----------------------------------------------------------------------

def _result(spans, success=True):
    return types.SimpleNamespace(success=success, spans=spans, stage_times={})


def test_the_readers_read_synthetic_records():
    cfg = _config("hat-100mp")
    results = [_result({"super_resolution/hat@x3": 6.0}),
               _result({"super_resolution/hat@x3": 4.0}),
               _result({"super_resolution/hat@x3": 99.0}, success=False)]
    for r, sr in zip(results, (5.0, 4.0, 99.0)):
        r.stage_times["super_resolution"] = sr
    work = hat.image_attention(cfg)
    bound = sum(max(b / 3.35e12, f / 989e12) for f, b in work.values())
    kernels = [(0.0, 1e6 * bound, "void (anonymous namespace)::window_attn_kernel<16>(...)"),
               (1e6 * bound, 3e6 * bound, "void (anonymous namespace)::window_attn_kernel<24>(...)"),
               (0.0, 5e6, "cutlass_gemm")]
    trace = {"kernels": kernels, "lo": 0.0, "hi": 1e9, "window_s": 1000.0}
    image = flops.image_flops(cfg)
    rec = {"config": cfg, "results": results, "window_s": 10.0, "peak_flops": 989e12,
           "bytes_per_s": 3.35e12, "trace": trace, "image_flops": image}
    read = {m: run.load_reader(m) for m in ("sr_s", "sr_mfu_pct", "mfu_pct", "attn_roofline_pct")}
    # HAT's two passes are the SR stage: the accepted readers count its FLOP
    assert read["sr_s"](rec) == pytest.approx(4.5)
    assert read["sr_mfu_pct"](rec) == pytest.approx(100.0 * 15728640 * 49887576 / 4.5 / 989e12)
    assert read["mfu_pct"](rec) == pytest.approx(100.0 * 2 * 15728640 * 49887576 / 10.0 / 989e12)
    # two images done, the kernels ran 3 bounds: 2/3
    assert read["attn_roofline_pct"](rec) == pytest.approx(100.0 * 2 / 3)
    # a trace without the kernel reads nothing
    assert read["attn_roofline_pct"]({**rec, "trace": {**trace, "kernels": kernels[2:]}}) is None


# -- the control ------------------------------------------------------------------------

def test_the_float8_control_reaches_the_attention_products():
    calls = {"conv": 0, "linear": 0, "matmul": 0}

    class Counted(reference.Ops):
        def conv(self, *a, **k):
            calls["conv"] += 1
            return super().conv(*a, **k)

        def linear(self, *a, **k):
            calls["linear"] += 1
            return super().linear(*a, **k)

        def matmul(self, a, b):
            calls["matmul"] += 1
            return super().matmul(a, b)

    sd = hat.init(TOY, 3, torch.Generator().manual_seed(9))
    x = _toy_input(h=16, w=16)
    with torch.no_grad():
        low = hat.forward(sd, TOY, 3, x, Counted("fp8"))
        ref = hat.forward(sd, TOY, 3, x, reference.Ops("fp32"))
    blocks = sum(TOY["depths"]) + len(TOY["depths"])
    assert calls["matmul"] == 2 * blocks  # each HAB's and OCAB's two products, one window block
    assert calls["linear"] == 4 * blocks and calls["conv"] == len(hat.convs(TOY, 3))
    assert float((low - ref).abs().max()) > 0.01
