"""The yardstick's frozen copies and the plain reference, held against the
program as it stands (on the CPU, at small sizes)."""

import importlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from yardstick import flops, inputs, pyramid, reference as R, trace, weights
from yardstick.tiff import read_tiff

HERE = os.path.dirname(os.path.abspath(__file__))
STORE = os.path.join(os.path.dirname(HERE), "srs_tpu_torch", "models", "checkpoints")


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_input_recipe_is_the_programs():
    from srs_tpu_torch.models.corpus import render_photo

    for seed in (2, 21):
        np.testing.assert_array_equal(inputs.render_photo(seed, 96), render_photo(seed, 96))
    crop = inputs.render_crop(9, 96, [20, 70])
    assert crop.shape == (50, 96, 3) and crop.dtype == np.float32


def test_job_order_is_the_pool_in_rounds_checked_image_first():
    pool = [2, 16, 17, 21, 9, 19]
    jobs = inputs.job_order(pool, 2**31 + 5, 14)
    assert [s for s, _ in jobs[:6]][0] == 2 and sorted(s for s, _ in jobs[:6]) == sorted(pool)
    assert jobs[6][0] == 2 and sorted(s for s, _ in jobs[6:12]) == sorted(pool)
    assert jobs == inputs.job_order(pool, 2**31 + 5, 14)
    assert jobs != inputs.job_order(pool, 2**31 + 6, 14)
    img = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    for how in inputs.ORIENTATIONS:
        out = inputs.orient(img, how)
        assert out.shape == img.shape and sorted(out.ravel()) == sorted(img.ravel())


def _default_path():
    """The default path's nets and route: the store's edsr_xl on both x3
    steps over six tiles of 512."""
    nets = {"edsr_xl": _config("fusion-100mp")["nets"]["edsr_xl"]}
    return {"nets": nets, "route": {"ladder": [3, 3], "steps": [[["edsr_xl", 1]]] * 2,
                                    "block": 512, "tiles": 6}}


@pytest.mark.parametrize("name,tflop", [("edsr_xl-100mp", 154.16), ("fusion-100mp", 2216.16)])
def test_flops_match_the_programs_count(name, tflop):
    from srs_tpu_torch.utils.flops import multipass_ladder_flops

    cfg = _default_path() if name == "edsr_xl-100mp" else _config(name)
    ours = flops.image_flops(cfg)
    route = cfg["route"]
    theirs = multipass_ladder_flops(route["steps"], route["ladder"], route["block"],
                                    route["tiles"])
    assert ours == pytest.approx(theirs, rel=1e-12)
    assert round(ours / 1e12, 2) == tflop


def test_checked_jobs_are_drawn_from_the_seed_in_their_ranges():
    ranges = [[0, 0], [1, 3], [6, 29]]
    seen = set()
    for seed in (0, 7, 2**31 + 5, 2**33):
        jobs = inputs.checked_jobs(ranges, seed)
        assert jobs == inputs.checked_jobs(ranges, seed)
        assert jobs[0] == 0 and 1 <= jobs[1] <= 3 and 6 <= jobs[2] <= 29
        seen.add(tuple(jobs))
    assert len(seen) > 1


def test_qa_values_match_the_program():
    from srs_tpu_torch.models.lpips import LPIPSMetric
    from srs_tpu_torch.qa import metrics as M

    torch.manual_seed(0)
    a = torch.from_numpy(inputs.render_crop(2, 128, [28, 100]))
    b = (a + torch.randn_like(a) * 3).clamp(0, 255)
    ours = R.qa(a, b, R.Store(STORE, "cpu"), torch.float64)
    lp = LPIPSMetric(device="cpu")
    theirs = {"psnr": M.psnr(a, b), "ssim": M.ssim(a, b), "ms_ssim": M.ms_ssim(a, b),
              "lpips_vgg": lp(a, b, "vgg"), "lpips_alex": lp(a, b, "alex")}
    assert lp.sources == {"vgg": "store", "alex": "store"}
    for k, v in theirs.items():
        assert ours[k] == pytest.approx(float(v), abs=1e-5), k


def test_pyramid_work_matches_chip_smoke():
    import chip_smoke

    for a, b in (([6, 4608, 4608, 3], [6, 2304, 2304, 3]), ([1, 7, 5, 1], [1, 4, 3, 1])):
        assert pyramid.pyr_down_work(a, b) == chip_smoke.pyr_down_work(a, b)
        assert pyramid.pyr_up_work(b, a) == chip_smoke.pyr_up_work(b, a)
    assert pyramid.bound_seconds("pyr_down", [([6, 4608, 4608, 3], [6, 2304, 2304, 3])],
                                 3.35e12) == pytest.approx(0.570e-3, rel=1e-3)


def test_launch_recorder_sees_every_call():
    from srs_tpu_torch.ops.blend import laplacian_fusion_tiles
    from srs_tpu_torch.ops.weights import layout_weight_profiles
    from srs_tpu_torch.tiling.geometry import compute_layout

    lo = compute_layout(120, 80, 64, 0.25, step_multiple=32)
    tiles = torch.rand(lo.num_tiles, 64, 64, 3) * 255
    with pyramid.recorded_shapes("srs_tpu_torch") as shapes:
        laplacian_fusion_tiles(tiles, lo, layout_weight_profiles(lo), levels=4)
    assert shapes["pyr_down"] and shapes["pyr_up"]
    assert shapes["pyr_down"][0] == [[lo.num_tiles, 64, 64, 3], [lo.num_tiles, 32, 32, 3]]
    import srs_tpu_torch.ops.blend as blend
    from srs_tpu_torch.ops.cuda import pyramid as k12

    assert blend.pyr_up is k12.pyr_up  # restored


def test_union_and_idle_share_match_chip_smoke():
    import chip_smoke

    rng = np.random.default_rng(3)
    spans = [tuple(sorted(rng.uniform(0, 100, 2))) for _ in range(50)]
    assert trace.union(spans) == chip_smoke.busy_intervals(spans)
    assert trace.idle_share([(1, 3), (2, 4), (6, 7)], 0, 10) == pytest.approx(0.6)
    assert trace.gaps([(1, 3), (6, 7)], 0, 10) == [(0, 1), (3, 6), (7, 10)]
    b = trace.breakdown([(1, 3, "k"), (6, 7, "j")], [(0, 5, "stage:a"), (5, 10, "stage:b")],
                        0, 10, 1.0)
    assert b["device_ops"] == [["k", 2], ["j", 1]]
    assert b["idle_gaps"] == [["stage:a", 4], ["stage:b", 3]]


@pytest.mark.parametrize("bits,compress", [(8, True), (8, False), (16, True)])
def test_tiff_reader_reads_the_programs_writer(tmp_path, bits, compress):
    from srs_tpu_torch.io.native import write_tiff

    rng = np.random.default_rng(bits)
    img = rng.integers(0, 2**bits, (37, 53, 3)).astype(np.uint16 if bits == 16 else np.uint8)
    path = str(tmp_path / "x.tiff")
    write_tiff(path, img, bit_depth=bits, compress=compress)
    np.testing.assert_array_equal(read_tiff(path), img)


def test_resize_and_pyramids_match_the_plain_program():
    from srs_tpu_torch.ops.cuda.pyramid import pyr_down_plain, pyr_up_plain
    from srs_tpu_torch.ops.resize import resize_bicubic

    x = torch.rand(2, 19, 23, 3) * 255
    for h, w in ((57, 69), (7, 11), (19, 46)):
        torch.testing.assert_close(R.resize(x, h, w), resize_bicubic(x, h, w), atol=2e-3,
                                   rtol=0)
    torch.testing.assert_close(R.pyr_down(x), pyr_down_plain(x), atol=1e-4, rtol=0)
    y = R.pyr_down(x)
    for hw in ((19, 23), (18, 22)):
        torch.testing.assert_close(R.pyr_up(y, *hw), pyr_up_plain(y, hw), atol=1e-4, rtol=0)


def test_layout_and_tiles_match_the_program():
    from srs_tpu_torch.ops.tiles import extract_tiles, pad_image
    from srs_tpu_torch.tiling.geometry import compute_layout

    for w, h, b in ((1280, 720, 512), (256, 144, 128), (97, 61, 32)):
        ours = R.layout(w, h, b, 0.2)
        theirs = compute_layout(w, h, b, 0.2, step_multiple=32)
        assert [list(p) for p in ours["positions"]] == theirs.positions.tolist()
        assert [list(o) for o in ours["overlaps"]] == theirs.overlaps.tolist()
        assert (ours["padded_h"], ours["padded_w"]) == (theirs.padded_h, theirs.padded_w)
    img = torch.rand(61, 97, 3) * 255
    lo = compute_layout(97, 61, 32, 0.2, step_multiple=32)
    torch.testing.assert_close(R.tiles_of(img, R.layout(97, 61, 32, 0.2)),
                               extract_tiles(pad_image(img, lo, "mirror"), lo))


def test_blend_matches_the_program():
    from srs_tpu_torch.ops.blend import laplacian_fusion_tiles
    from srs_tpu_torch.ops.weights import layout_weight_profiles
    from srs_tpu_torch.tiling.geometry import compute_layout

    lo = R.layout(200, 120, 64, 0.2)
    theirs_lo = compute_layout(200, 120, 64, 0.2, step_multiple=32).scaled(3)
    tiles = torch.rand(lo["nx"] * lo["ny"], 192, 192, 3) * 255
    ours = R.blend(list(tiles), lo, 3, 6)
    theirs = laplacian_fusion_tiles(tiles, theirs_lo, layout_weight_profiles(theirs_lo),
                                    levels=6, clip_range=None)
    torch.testing.assert_close(ours, theirs, atol=2e-3, rtol=0)


@pytest.mark.parametrize("name,scale", [("espcn", 3), ("edsr_m", 3), ("rcan", 2), ("edsr_xl", 4)])
def test_store_reader_and_nets_match_the_program(name, scale):
    from srs_tpu_torch.models.registry import build_model
    from srs_tpu_torch.models.store import load_state

    specs = _config("fusion-100mp")["nets"]
    path = os.path.join(STORE, f"{name}_x{scale}.srsw")
    sd = R.read_store_file(path)
    theirs_sd = load_state(path)
    assert list(sd) == list(theirs_sd)
    for k in sd:
        torch.testing.assert_close(sd[k], theirs_sd[k], atol=0, rtol=0)
    store = R.Store(STORE, "cpu")
    x = torch.rand(2, 12, 12, 3) * 255
    ours = R.Nets(store, specs).forward(name, scale, x)
    net, _ = build_model(name, scale, theirs_sd, dtype="float32", params_dtype="float32",
                         device="cpu")
    with torch.no_grad():
        theirs = net(x)
    torch.testing.assert_close(ours, theirs, atol=2e-3, rtol=0)


def test_routing_selection_and_fusion_match_the_program():
    from srs_tpu_torch.models import routing
    from srs_tpu_torch.models.registry import TrainedWeights
    from srs_tpu_torch.models.selection import panel_best_model
    from srs_tpu_torch.config import ModelConfig
    from srs_tpu_torch.models.sr_module import SuperResolutionModule, scale_ladder

    img = inputs.render_crop(2, 256, [56, 200])
    est = routing.estimate_degradation(img, device="cpu")
    ours = R.degradation(torch.from_numpy(img))
    assert ours["reason"] == est.reason
    assert ours["noise_sigma"] == pytest.approx(est.noise_sigma, rel=1e-4)
    assert ours["band_ratio"] == pytest.approx(est.band_ratio, rel=1e-4)
    store = R.Store(STORE, "cpu")
    w = TrainedWeights(None, None)
    for s in (2, 3, 4):
        assert R.select_net(store, s, "edsr_xl") == panel_best_model(
            s, "edsr_xl", lambda n, sc: (n, sc) in w)
    for total in (9.566, 3.2, 13.5):
        assert R.scale_ladder(total, {2, 3, 4}) == scale_ladder(total, trained={2, 3, 4})
    mod = SuperResolutionModule(ModelConfig(), None, "cpu")
    for s in (2, 3):
        assert R.fusion_members(store, s) == pytest.approx(mod._fusion_for(s))
    # the probe in float32 against the program's bfloat16 probe
    gain, alpha = R.probe(torch.from_numpy(img), R.Nets(store, _config("fusion-100mp")["nets"]),
                          "espcn", 3)
    theirs = routing.probe_sr_alpha(img, "espcn", 3, weights=w, device="cpu")
    assert gain == pytest.approx(theirs[0], abs=0.05)
    assert alpha == pytest.approx(theirs[1], abs=0.02)


TOY = '''"""One 3x3 convolution to channels * scale**2 and a shuffle, on a
bicubic upsample: a kind that lives in this file alone."""
import torch

from . import edsr


def convs(spec, scale):
    return [(3 * scale * scale, 3, 3, 3, "bias", 1)]


def flops_per_pixel(spec, scale):
    return float(2 * 3 * scale * scale * 3 * 9)


def init(spec, scale, generator):
    return {"conv.weight": torch.rand((3 * scale * scale, 3, 3, 3), generator=generator) * 0.01,
            "conv.bias": torch.zeros(3 * scale * scale)}


def forward(sd, spec, scale, x, ops):
    return edsr.bicubic_residual(
        x, scale, lambda h: ops.conv(h, sd["conv.weight"], sd["conv.bias"], 1))
'''


def _yardstick_copy(tmp_path, name):
    """A copy of the yardstick under ``tmp_path``, imported as the package
    ``name``."""
    root = str(tmp_path / "yardstick")
    shutil.copytree(os.path.join(HERE, "yardstick"), root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "__init__.py"),
                                                  submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return root


def test_a_net_kind_is_one_file(tmp_path):
    """A kind dropped in as ``nets/<kind>.py`` runs, counts and draws with
    no other edit; a kind with no file raises naming the file."""
    name = "yardstick_with_toy"
    root = _yardstick_copy(tmp_path, name)
    with open(os.path.join(root, "nets", "toy.py"), "w") as f:
        f.write(TOY)
    try:
        ref = importlib.import_module(f"{name}.reference")
        fl = importlib.import_module(f"{name}.flops")
        w = importlib.import_module(f"{name}.weights")
        spec = {"kind": "toy", "weights": {"seed": 3}}
        cfg = {"nets": {"toy": spec}, "pipeline": {"compute_dtype": "bfloat16"},
               "route": {"ladder": [3], "steps": [[["toy", 2]]], "block": 8, "tiles": 2}}
        assert fl.conv_shapes(spec, 3) == [(27, 3, 3, 3)]
        assert fl.flops_per_pixel(spec, 3) == 2 * 27 * 3 * 9
        assert fl.image_flops(cfg) == 2 * 2 * 27 * 3 * 9 * 8 * 8 * 2
        assert fl.image_epilogue(cfg) == (2, 2 * 2 * 27 * 8 * 8 * 2 * 2)
        seeded = w.seeded(cfg)
        assert list(seeded) == [("toy", 3)]
        store = ref.Store(STORE, "cpu", seeded)
        assert store.has("toy", 3) and not store.has("toy", 2)
        x = torch.rand(1, 5, 7, 3) * 255
        got = ref.Nets(store, cfg["nets"]).forward("toy", 3, x)
        sd = seeded[("toy", 3)]
        r = torch.nn.functional.conv2d((x / 255.0 - 0.5).permute(0, 3, 1, 2), sd["conv.weight"],
                                       sd["conv.bias"], padding=1)
        want = R.resize(x, 15, 21) + torch.nn.functional.pixel_shuffle(r, 3).permute(
            0, 2, 3, 1) * 255.0
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        for call in (lambda: fl.conv_shapes({"kind": "nokind"}, 3),
                     lambda: fl.flops_per_pixel({"kind": "nokind"}, 3),
                     lambda: ref.Nets(store, {"n": {"kind": "nokind"}}).forward("n", 3, x)):
            with pytest.raises(ValueError, match="nets/nokind.py"):
                call()
        with pytest.raises(ValueError, match="nets/toy.py"):
            flops.conv_shapes({"kind": "toy"}, 3)  # the tree's own yardstick has no toy
    finally:
        for key in [k for k in sys.modules if k == name or k.startswith(name + ".")]:
            del sys.modules[key]


def test_seeded_weights_are_the_same_draw_under_the_programs_names():
    """Each kind's ``init`` draws the program's parameter names and shapes,
    the same tensors from the same entry seed in every call, other ones
    for another seed, name or scale."""
    from srs_tpu_torch.models.registry import _make

    specs = _config("fusion-100mp")["nets"]
    for name, spec in specs.items():
        cfg = {"nets": {name: {**spec, "weights": {"seed": 5}}},
               "route": {"ladder": [2, 3], "steps": [[[name, 1]], [[name, 8]]]}}
        a, b = weights.seeded(cfg), weights.seeded(cfg)
        assert list(a) == [(name, 2), (name, 3)]
        for key, sd in a.items():
            theirs = _make(name, key[1], torch.float32).state_dict()
            assert sorted(sd) == sorted(theirs)
            for k, v in sd.items():
                assert v.dtype == torch.float32 and v.shape == theirs[k].shape, k
                torch.testing.assert_close(v, b[key][k], atol=0, rtol=0)
        other = weights.seeded({**cfg, "nets": {name: {**spec, "weights": {"seed": 6}}}})
        for key, sd in a.items():
            assert any(not torch.equal(v, other[key][k]) for k, v in sd.items())
        assert any(not torch.equal(v, a[(name, 3)][k]) for k, v in a[(name, 2)].items()
                   if v.shape == a[(name, 3)][k].shape)
    assert weights.net_seed(5, "edsr_xl", 3) != weights.net_seed(5, "edsr_xl", 2)


def test_epilogue_launches_and_bytes_of_the_fusion_tier():
    """1390 epilogue launches an image (a pass: 35 of edsr_xl and edsr_l,
    43 of rcan, 19 of edsr_m, 3 of espcn), and the bytes of one edsr_xl
    layer at [6, 128, 1536^2] give chip_smoke's bounds: 2.164 ms for the
    bias and ReLU forms, 3.245 ms for the residual."""
    cfg = _config("fusion-100mp")
    launches, nbytes = flops.image_epilogue(cfg)
    assert launches == 1390
    specs = cfg["nets"]
    per_pass = {n: len(flops.conv_shapes(specs[n], 3)) for n in specs}
    assert per_pass == {"edsr_xl": 35, "edsr_l": 35, "edsr_m": 19, "rcan": 43, "espcn": 3}
    one = {"pipeline": cfg["pipeline"], "nets": {"edsr_xl": specs["edsr_xl"]},
           "route": {"ladder": [3], "steps": [[["edsr_xl", 1]]], "block": 1536, "tiles": 6}}
    forms = [c[4] for c in R.kinds.load("edsr").convs(specs["edsr_xl"], 3)]
    bias_ms = 6 * 128 * 1536 ** 2 * 2 * 2 / 3.35e12 * 1e3
    assert round(bias_ms, 3) == 2.164 and round(bias_ms * 1.5, 3) == 3.245
    want = (forms.count("bias") - 1 + forms.count("relu") + 1.5 * forms.count("residual")
            + 27 / 128) * bias_ms
    assert flops.image_epilogue(one)[1] / 3.35e12 * 1e3 == pytest.approx(want, rel=1e-12)
    assert forms.count("residual") == 17 and forms.count("relu") == 16


def test_epilogue_roofline_reads_a_synthetic_trace():
    import run

    class Done:
        success = True

    cfg = _config("fusion-100mp")
    _launches, nbytes = flops.image_epilogue(cfg)
    bound_s = nbytes / 3.35e12
    # two images' epilogue at 80% of the bound, split over launches, one
    # straddling the window's start; other kernels and a launch outside
    kernels = [(1e6, 1e6 + 0.5 * bound_s / 0.8 * 1e6, "void conv_epilogue_kernel<bf16, 1, true>"),
               (3e6, 3e6 + 1.5 * bound_s / 0.8 * 1e6, "void conv_epilogue_kernel<bf16, 2, false>"),
               (5e6, 6e6, "cudnn_conv"), (0.0, 1e5, "void conv_epilogue_kernel<bf16, 0, true>")]
    t = {"kernels": kernels, "lo": 5e4, "hi": 9e6}
    read = run.load_reader("epilogue_roofline_pct")
    got = read({"config": cfg, "results": [Done(), Done()], "trace": t,
                "bytes_per_s": 3.35e12})
    ran = 0.5 * bound_s / 0.8 + 1.5 * bound_s / 0.8 + 0.05
    assert got == pytest.approx(100.0 * 2 * bound_s / ran, rel=1e-9)
    assert read({"config": cfg, "results": [Done()], "trace": {**t, "kernels": kernels[2:3]},
                 "bytes_per_s": 3.35e12}) is None
    assert read({"config": cfg, "results": [], "trace": t, "bytes_per_s": 3.35e12}) is None


def test_ops_round_every_product_in_the_control():
    """The control's float8 reaches linear layers and products as it does
    convolutions; the reference's own precision leaves them exact."""
    g = torch.Generator().manual_seed(1)
    x, w, b = (torch.randn(s, generator=g) for s in ((4, 8), (6, 8), (6,)))
    q = R._fp8
    torch.testing.assert_close(R.Ops("fp8").linear(x, w, b),
                               torch.nn.functional.linear(q(x), q(w), b), atol=0, rtol=0)
    torch.testing.assert_close(R.Ops("fp8").matmul(x, w.T), q(x) @ q(w.T), atol=0, rtol=0)
    torch.testing.assert_close(R.Ops("tf32").matmul(x, w.T), x @ w.T, atol=0, rtol=0)
    assert not torch.equal(R.Ops("fp8").linear(x, w, b), R.Ops("tf32").linear(x, w, b))
    c = torch.randn((2, 3, 5, 5), generator=g)
    k = torch.randn((4, 3, 3, 3), generator=g)
    torch.testing.assert_close(R.Ops("fp8").conv(c, k, None, 1),
                               torch.nn.functional.conv2d(q(c), q(k), None, padding=1),
                               atol=0, rtol=0)
