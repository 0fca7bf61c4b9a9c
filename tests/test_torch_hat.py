"""HAT on the port (``models/nets.HAT``, ``ops/cuda/window_attn``), on the
CPU, against the plain float32 reference in ``tests/torch_hat_reference.py``
(XPixelGroup/HAT's ``hat_arch.py`` step by step; the JAX package has no
HAT). Seeded random weights at a toy size: ``embed_dim`` 24, 2 RHAGs of 2
HABs, 2 heads, window 8, overlap 0.5 (16 keys a side), compress 3,
squeeze 4 (24 / 30 would leave the gate no channel).

- (a) the port's HAT against the reference at x2, x3 and x4, on sides that
  are and are not multiples of the window;
- (b) the attention's plain route against HAT's explicit roll, partition
  and unfold, at the map's edges: shifted HAB windows, padded OCAB ones;
- (c) planted faults, each of which fails (a);
- (d) ``hat_x3.pt`` in a ``checkpoint_dir`` served as trained, and
  ``process()`` with ``quality_model="hat"`` end to end;
- (e) the chunk rule: fusion's 100MP chunk stays six tiles, HAT's is what
  its bytes give;
- (f) HAT's FLOP count;
- (g) the counters of one pass equal ``attention_work``'s.

The kernel itself runs on the card only (``chip_smoke.py``'s ``kernels``
phase holds it against the plain route).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_hat_reference as ref
from srs_tpu_torch.models import nets, registry
from srs_tpu_torch.models.registry import MODEL_REGISTRY, ModelSpec, build_model
from srs_tpu_torch.ops.cuda import window_attn as wa
from srs_tpu_torch.utils import flops, profiling

TOY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8, overlap_ratio=0.5,
           compress_ratio=3, squeeze_factor=4, mlp_ratio=2.0, num_feat=16)
REF_KW = dict(depths=TOY["depths"], heads=TOY["num_heads"], window_size=8, overlap_ratio=0.5)
# (a)'s tolerance: both sides run float32 with TF32 off, the same
# arithmetic in another order (the port gathers windows by index, sums its
# products blockwise and updates the stream in place); the outputs agree
# to 1e-3 LSB of 255 (measured under 2e-4). A planted fault moves them by
# over 0.05 LSB.
ATOL_LSB = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_state(scale: int, seed: int = 0) -> dict:
    """Seeded weights for the toy under HAT's names: every tensor drawn
    (LayerNorms about 1 and 0, biases small, the bias tables at 0.5 so they
    move the softmax), ``conv_last`` at a gain that keeps the output tens
    of LSB about the mean."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ref.shapes(scale, TOY["embed_dim"], TOY["depths"], TOY["num_heads"], 8, 0.5, 3, 4,
                        2.0, TOY["num_feat"])
    sd = {}
    for key, shape in shapes.items():
        z = torch.randn(shape, generator=gen)
        if key.endswith("relative_position_bias_table"):
            sd[key] = 0.5 * z
        elif len(shape) == 1:
            norm = ".norm" in key or key.startswith("norm.") or "norm1" in key or "norm2" in key
            sd[key] = (1.0 + 0.1 * z) if norm and key.endswith("weight") else 0.05 * z
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[key] = z / math.sqrt(fan_in) * (0.3 if key.startswith("conv_last") else 1.0)
    return sd


def port_net(scale: int, seed: int = 0, dtype=torch.float32):
    net = nets.HAT(scale=scale, dtype=dtype, **TOY)
    net.load_state_dict(toy_state(scale, seed))
    return net.eval().requires_grad_(False)


def image(n, h, w, seed=1):
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    base = torch.stack([127 + 90 * torch.sin(xx / 5), 127 + 80 * torch.cos(yy / 4),
                        127 + 70 * torch.sin((xx + yy) / 3)], -1)
    return (base + 8 * torch.randn((n, h, w, 3), generator=gen)).clamp(0, 255)


def run_both(scale, shape, seed=0):
    x = image(*shape)
    with torch.no_grad():
        got = port_net(scale, seed)(x)
        want = ref.forward(toy_state(scale, seed), x, scale, **REF_KW)
    return got, want


@pytest.mark.parametrize("scale,shape", [(2, (1, 16, 24)), (3, (2, 20, 28)), (4, (1, 13, 19)),
                                         (3, (1, 24, 16))],
                         ids=["x2-multiple", "x3-padded", "x4-padded", "x3-multiple"])
def test_port_matches_the_reference(scale, shape):
    got, want = run_both(scale, shape)
    assert got.shape == want.shape == (shape[0], shape[1] * scale, shape[2] * scale, 3)
    assert float(want.std()) > 5.0  # the output varies with the content
    assert float((got - want).abs().max()) <= ATOL_LSB


# -- (b) the plain route against HAT's explicit roll, partition and unfold -------

def explicit_hab(qkv, table, heads, ws, shift):
    """HAT's WindowAttention core on the rolled, partitioned map, reversed."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    win = ref.window_partition(x, ws).view(-1, ws * ws, 3, heads, c // heads)
    q, k, v = win.permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    rpi = ref.calculate_rpi_sa(ws)
    attn = attn + table[rpi.view(-1)].view(ws * ws, ws * ws, -1).permute(2, 0, 1)[None]
    if shift:
        mask = ref.calculate_mask(h, w, ws, shift)
        nw = mask.shape[0]
        attn = (attn.view(-1, nw, heads, ws * ws, ws * ws) + mask[None, :, None]).view(
            -1, heads, ws * ws, ws * ws)
    out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(-1, ws, ws, c)
    out = ref.window_reverse(out, ws, h, w)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def explicit_ocab(qkv, table, heads, ws, ratio):
    """HAT's OCAB core: query windows, nn.Unfold key windows of the zero-padded
    projected k and v."""
    b, h, w, c3 = qkv.shape
    c, d, ext = c3 // 3, c3 // 3 // heads, ws + int(ws * ratio)
    t = qkv.reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    qw = ref.window_partition(t[0].permute(0, 2, 3, 1), ws).view(-1, ws * ws, heads, d)
    kv = torch.nn.Unfold((ext, ext), stride=ws, padding=(ext - ws) // 2)(
        torch.cat((t[1], t[2]), 1))
    nw = kv.shape[-1]
    kv = kv.view(b, 2, c, ext, ext, nw).permute(1, 0, 5, 3, 4, 2).reshape(2, b * nw, ext * ext,
                                                                         heads, d)
    q, k, v = (a.permute(0, 2, 1, 3) for a in (qw, kv[0], kv[1]))
    rpi = ref.calculate_rpi_oca(ws, ratio)
    bias = table[rpi.view(-1)].view(ws * ws, ext * ext, -1).permute(2, 0, 1)
    attn = torch.softmax((q * d ** -0.5) @ k.transpose(-2, -1) + bias[None], -1)
    out = (attn @ v).transpose(1, 2).reshape(-1, ws, ws, c)
    return ref.window_reverse(out, ws, h, w)


@pytest.mark.parametrize("case", ["hab", "hab-shifted", "ocab"])
@pytest.mark.parametrize("hw", [(16, 24), (8, 8), (32, 16)])
def test_plain_route_matches_hat_explicit_windows(case, hw):
    h, w = hw
    heads, ws = 2, 8
    gen = torch.Generator().manual_seed(h * 100 + w)
    qkv = torch.randn((2, h, w, 3 * 12), generator=gen)
    ocab = case == "ocab"
    n_table = (2 * ws + ws // 2 - 1) ** 2 if ocab else (2 * ws - 1) ** 2
    table = torch.randn((n_table, heads), generator=gen)
    shift = ws // 2 if case == "hab-shifted" else 0
    got = wa.window_attn_plain(qkv, table, heads, ws, shift=shift, overlap=ws // 2 if ocab else 0)
    want = (explicit_ocab(qkv, table, heads, ws, 0.5) if ocab
            else explicit_hab(qkv, table, heads, ws, shift))
    assert float((got - want).abs().max()) < 1e-5
    # the edges matter: the mask and the padded keys move the outputs there
    if shift or ocab:
        plain = (explicit_hab(qkv, table, heads, ws, 0) if shift else None)
        if plain is not None:
            assert float((want - plain).abs().max()) > 1e-2


# -- (c) planted faults -----------------------------------------------------------

def _ocab_keys_masked(orig):
    """OCAB's padded keys masked out of the softmax instead of zeroed."""
    def attn(qkv, table, heads, window, shift=0, overlap=0):
        if not overlap:
            return orig(qkv, table, heads, window, shift, overlap)
        b, h, w, c3 = qkv.shape
        c, d = c3 // 3, c3 // 3 // heads
        q_idx, k_idx, _ = wa._plan(h, w, window, 0, overlap)
        rpi = wa.rpi_oca(window, overlap)
        bias = table[rpi.reshape(-1)].reshape(*rpi.shape, heads).permute(2, 0, 1)
        flat = qkv.reshape(b, h * w, 3, heads, d)
        out = torch.empty(b, h * w, heads, d)
        for bi in range(b):
            q = flat[bi, :, 0][q_idx].permute(0, 2, 1, 3)
            k = flat[bi, :, 1][k_idx.clamp(min=0)].permute(0, 2, 1, 3)
            v = flat[bi, :, 2][k_idx.clamp(min=0)].permute(0, 2, 1, 3)
            s = q @ k.transpose(-2, -1) * d ** -0.5 + bias
            s = s.masked_fill((k_idx < 0)[:, None, None, :], float("-inf"))
            out[bi, q_idx.reshape(-1)] = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(
                -1, heads, d)
        return out.reshape(b, h, w, c)
    return attn


FAULTS = {
    "no-shift": lambda mp: mp.setattr(
        wa, "window_attn", (lambda orig: lambda *a, shift=0, **k: orig(*a, shift=0, **k))(
            wa.window_attn)),
    "ocab-keys-masked": lambda mp: mp.setattr(wa, "window_attn_plain",
                                              _ocab_keys_masked(wa.window_attn_plain)),
    "bias-transposed": lambda mp: mp.setattr(
        wa, "rpi_sa", (lambda orig: lambda w: orig(w).T.contiguous())(wa.rpi_sa)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_comparison(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    got, want = run_both(3, (1, 20, 28))
    assert float((got - want).abs().max()) > 50 * ATOL_LSB


# -- (d) served from a checkpoint_dir, and process() end to end -----------------

@pytest.fixture
def toy_registry(monkeypatch):
    monkeypatch.setitem(MODEL_REGISTRY, "hat", ModelSpec("hat", nets.HAT, dict(TOY),
                                                         "toy HAT", in_px_bytes=4096))
    registry.clear_param_cache()
    yield
    registry.clear_param_cache()


def test_saved_weights_are_served_as_trained_and_process_runs(tmp_path, toy_registry):
    from srs_tpu_torch.models.sr_module import SuperResolutionModule
    from srs_tpu_torch.config import ModelConfig
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

    sd = toy_state(3, seed=4)
    torch.save(sd, tmp_path / "hat_x3.pt")
    assert registry.is_pretrained("hat", 3, str(tmp_path))
    sr = SuperResolutionModule(ModelConfig(quality_model="hat", checkpoint_dir=str(tmp_path)),
                               device="cpu")
    assert sr.is_trained("hat", 3) and not sr.is_trained("hat", 2)
    net, trained = build_model("hat", 3, sr.weights[("hat", 3)], dtype="float32", device="cpu")
    assert trained and torch.equal(net.conv_last.weight, sd["conv_last.weight"])

    cfg = PipelineConfig(block_size=32, overlap_ratio=0.25, target_resolution="144x108",
                         provider="quality", quality_model="hat", per_scale_selection=False,
                         auto_route=False, enable_qa=False, compute_dtype="float32",
                         checkpoint_dir=str(tmp_path), device="cpu")
    pipe = SuperResolutionPipeline(cfg)
    src = image(1, 36, 48, seed=3)[0].numpy()
    out = tmp_path / "out.tiff"
    res = pipe.process(src, str(out))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert info["ladder"] == [3] and info["step_members"] == [[["hat", 1]]]
    tiff = read_tiff(str(out))
    assert tiff.shape == (108, 144, 3) and float(tiff.std()) > 5.0
    assert res.spans["count/window_attn.plain"] == 2 * 3  # one chunk: 2 RHAGs of 2 HABs, 1 OCAB
    assert "super_resolution/hat@x3" in res.spans


# -- (e) the chunk rule -------------------------------------------------------------

def test_chunk_rule_reads_each_nets_bytes():
    from srs_tpu_torch.pipeline import _CHUNK_BYTES, PipelineConfig, SuperResolutionPipeline

    fusion = SuperResolutionPipeline(PipelineConfig(provider="fusion", device="cpu"))
    assert fusion.sr_module.step_members(3, "fusion")[0] == ("edsr_xl", 8)
    # the CNNs' 160 bytes and the fusion sum's 24: all six 100MP tiles in one chunk
    assert fusion._chunk_tiles(512, [3, 3], "fusion") == int(_CHUNK_BYTES // (4608 ** 2 * 184))
    assert fusion._chunk_tiles(512, [3, 3], "fusion") >= 6
    hat = SuperResolutionPipeline(PipelineConfig(provider="quality", quality_model="hat",
                                                 per_scale_selection=False, device="cpu"))
    # HAT's bytes per input pixel of its last pass, over the 9 output pixels each becomes
    want = int(_CHUNK_BYTES // (4608 * 4608 * registry.HAT_IN_PX_BYTES / 9))
    assert hat._chunk_tiles(512, [3, 3], "quality") == want and 2 <= want <= 4
    # a CNN's chunk is as it was
    xl = SuperResolutionPipeline(PipelineConfig(provider="quality", quality_model="edsr_xl",
                                                per_scale_selection=False, device="cpu"))
    assert xl._chunk_tiles(512, [3, 3], "quality") == int(_CHUNK_BYTES // (4608 ** 2 * 160))


# -- (f) the FLOP count -------------------------------------------------------------

def test_flop_count_is_hats_own():
    hab, ocab, rhag_conv = 1091520, 933120, 583200
    want = 9720 + 6 * (6 * hab + ocab + rhag_conv) + 583200 + 207360 + 663552 + 31104
    assert want == 49887576
    assert flops._net_flops_per_pixel("hat", 3) == want
    with torch.device("meta"):
        net = nets.HAT(3, dtype=torch.float32)
    # the generic count would take the bias tables for linear layers and miss
    # the attention's two products
    assert flops.conv_flops_per_pixel(net) != want
    assert sum(p.numel() for p in net.parameters()) == 20809435
    assert flops.ladder_flops("hat", [3, 3], 512, 6) * 1e-12 == pytest.approx(784.66, abs=0.01)


# -- (g) the counters ---------------------------------------------------------------

def test_counters_of_a_pass_equal_attention_work():
    net = port_net(3)
    x = image(2, 20, 28)
    with profiling.job() as record, torch.no_grad():
        net(x)
    b, h, w = 2, 24, 32  # padded to the window
    hab = wa.attention_work(b, h, w, 24, 2, 8)
    ocab = wa.attention_work(b, h, w, 24, 2, 8, overlap=4)
    blocks = sum(TOY["depths"])
    c = record.counters
    assert c["window_attn.plain"] == blocks + len(TOY["depths"])
    assert "window_attn.launches" not in c
    assert c["window_attn.flop"] == blocks * hab[0] + 2 * ocab[0]
    assert c["window_attn.bytes"] == blocks * hab[1] + 2 * ocab[1]
    assert hab == (4.0 * b * h * w * 64 * 24, 4.0 * b * h * w * 24 * 2)
