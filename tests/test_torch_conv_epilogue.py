"""The SR convolutions' epilogue (``srs_tpu_torch.ops.cuda.epilogue``) and
the route ``nets.Conv2d`` takes to it, on the CPU: the plain version is
PyTorch's unfused op sequence bit for bit, and the step-by-step rounding
the kernel repeats; the nets' outputs equal a frozen copy of their unfused
forward passes; CPU and autograd inputs take the plain route, a card
without autograd the kernel, and the counters say so; a master-weights
step still reaches the float32 gradients; the kernel's wrapper passes it
each layout and type it takes, and refuses what it does not take. The
kernel itself runs on the card only (``chip_smoke.py``'s ``kernels`` phase
holds it against the plain version)."""

import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from srs_tpu_torch.models import nets
from srs_tpu_torch.models.registry import build_model, seeded_params
from srs_tpu_torch.ops.cuda import epilogue
from srs_tpu_torch.utils import profiling

FORMS = ("bias", "relu", "residual-0.1", "residual-1")


def _nhwc(shape, dtype, gen, lo=-2.0, hi=2.0):
    """A channels_last [N, C, H, W] tensor of uniform draws in ``dtype``."""
    n, c, h, w = shape
    t = torch.rand((n, h, w, c), generator=gen) * (hi - lo) + lo
    return t.to(dtype).permute(0, 3, 1, 2)


def _unfused(y, b, form, x):
    """The ops the nets ran after each conv before the epilogue: PyTorch's
    bias add for a cuDNN conv, then ``F.relu(..., inplace=True)``,
    ``_ResBlock``'s ``x + h * res_scale`` or ``EDSR``'s ``body_out(h) + h0``."""
    y = y.add_(b.reshape(1, -1, 1, 1))
    if form == "relu":
        return F.relu(y, inplace=True)
    if form == "residual-0.1":
        return x + y * 0.1
    if form == "residual-1":
        return y + x
    return y


def _stepwise(y, b, form, x):
    """What the kernel computes: each step in float32, rounded to the
    tensor's type after the bias, the scale (by the float 0.1f) and the
    residual add."""
    def r(t):
        return t.to(y.dtype).float()

    t = r(y.float() + b.float().reshape(1, -1, 1, 1))
    if form == "relu":
        t = t.clamp_min(0.0)
    elif form.startswith("residual"):
        s = torch.tensor(float(form.split("-")[1]), dtype=torch.float32)
        t = r(x.float() + r(t * s))
    return t.to(y.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", [3, 27, 64, 96, 128])
def test_plain_version_is_the_unfused_op_sequence(c, form, dtype):
    gen = torch.Generator().manual_seed(c)
    y = _nhwc((2, c, 5, 7), dtype, gen)
    x = _nhwc((2, c, 5, 7), dtype, gen)
    b = (torch.rand(c, generator=gen) - 0.5).to(dtype)
    kw = {"relu": form == "relu"}
    if form.startswith("residual"):
        kw.update(residual=x, res_scale=float(form.split("-")[1]))
    got = epilogue.conv_epilogue_plain(y.clone(), b, **kw)
    want = _unfused(y.clone(), b, form, x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, _stepwise(y, b, form, x))


# -- the nets against a frozen copy of their unfused forward passes -----------


def _conv(conv, x):
    """The conv as ``nets.Conv2d.forward`` ran it: its bias inside the
    conv call (on the CPU, inside the conv's own kernel)."""
    return conv._conv_forward(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def _conv_then_bias(conv, x):
    """The conv as PyTorch runs a cuDNN conv with a bias: the conv, then
    the bias as its own in-place add."""
    y = conv._conv_forward(x, conv.weight.to(x.dtype), None)
    return y.add_(conv.bias.to(x.dtype).reshape(1, -1, 1, 1))


def _frozen_block(blk, x, cv):
    h = cv(blk.conv1, F.relu(cv(blk.conv0, x), inplace=True))
    if isinstance(blk, nets._CABlock):
        s = h.float().mean(dim=(2, 3), keepdim=True).to(h.dtype)
        s = torch.sigmoid(cv(blk.att1, F.relu(cv(blk.att0, s))))
        return x + h * s * blk.res_scale
    return x + h * blk.res_scale


def _frozen_edsr(net, x, cv=_conv):
    """EDSR's and RCAN's forward pass before the epilogue."""
    base, h = nets._residual(x, net.scale, net.dtype)
    h0 = cv(net.head, h)
    h = h0
    for blk in net.blocks:
        h = _frozen_block(blk, h, cv)
    h = cv(net.body_out, h) + h0
    for conv, f in zip(net.up_convs, net.factors[:-1]):
        h = F.pixel_shuffle(cv(conv, h), f)
    return nets._add_residual(base, cv(net.tail, h), net.factors)


def _frozen_espcn(net, x, cv=_conv):
    """ESPCN's forward pass before the epilogue."""
    base, h = nets._residual(x, net.scale, net.dtype)
    h = F.relu(cv(net.conv_mid, F.relu(cv(net.conv_in, h), inplace=True)), inplace=True)
    for conv, f in zip(net.up_convs, net.factors[:-1]):
        h = F.relu(F.pixel_shuffle(cv(conv, h), f))
    return nets._add_residual(base, cv(net.conv_out, h), net.factors)


def _seeded_net(name, scale, dtype, seed=3):
    """``name`` at ``scale`` with seeded weights and non-zero biases."""
    sd = seeded_params(name, scale, seed=seed, tail_gain=0.5)
    gen = torch.Generator().manual_seed(seed)
    sd = {k: (torch.rand(v.shape, generator=gen) - 0.5) * 0.2 if k.endswith("bias") else v
          for k, v in sd.items()}
    net, _ = build_model(name, scale, sd, dtype=dtype, device="cpu")
    return net


NET_CASES = [("edsr_m", 2), ("edsr_m", 3), ("edsr_m", 4), ("rcan", 3), ("espcn", 2),
             ("espcn", 4)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,scale", NET_CASES)
def test_nets_equal_their_frozen_unfused_forward(name, scale, dtype):
    net = _seeded_net(name, scale, dtype)
    x = torch.rand((2, 10, 12, 3), generator=torch.Generator().manual_seed(5)) * 255
    frozen = _frozen_espcn if name == "espcn" else _frozen_edsr
    with torch.inference_mode():
        got, want = net(x), frozen(net, x)
    assert torch.equal(got, want)
    # and with autograd on, as the trainer runs them
    assert torch.equal(net(x), frozen(net, x))


# -- the route ------------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself on a card, so the route's decision
    can be read without one."""

    is_cuda = True


def _counted(fn):
    with profiling.job() as rec:
        out = fn()
    return out, rec.counters


@pytest.mark.parametrize("case", ["cpu-bf16", "cpu-f32", "cpu-f32-grad", "cpu-bf16-grad"])
def test_cpu_inputs_take_the_plain_route_and_the_counters_say_so(case):
    dtype = "float32" if "f32" in case else "bfloat16"
    net = _seeded_net("rcan", 3, dtype)
    x = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(1)) * 255
    epilogue.reset_launches()
    ctx = torch.enable_grad() if case.endswith("grad") else torch.inference_mode()
    with ctx:
        _out, counters = _counted(lambda: net(x))
    convs = sum(1 for m in net.modules() if isinstance(m, nets.Conv2d))
    want = {"conv_epilogue.plain": convs}
    if case.endswith("grad"):
        want["conv_epilogue.plain_autograd"] = convs
    assert counters == want
    assert epilogue.LAUNCHES["conv_epilogue"] == 0


def _fake_launch(calls):
    """Stands in for the kernel: records its form and runs the plain ops."""
    def launch(y, bias, relu=False, residual=None, res_scale=1.0, act=None):
        calls.append(("residual" if residual is not None else act or ("relu" if relu else "bias"),
                      y.shape[1]))
        epilogue._record(True)
        with profiling.job():  # the plain ops' own count stays out of the caller's record
            return epilogue.conv_epilogue_plain(y, bias, relu, residual, res_scale, act)
    return launch


@pytest.mark.parametrize("dtype,grad,fused", [
    (torch.bfloat16, False, True),   # serving on a card
    (torch.float32, False, True),    # float32 serving
    (torch.bfloat16, True, False),   # autograd: training, zssr's tuning
])
def test_the_route_on_a_card_follows_dtype_and_autograd(monkeypatch, dtype, grad, fused):
    """On a (stand-in) card every conv without autograd takes the kernel,
    whatever its type: each _ResBlock as conv0 with ReLU and conv1 with
    the scaled residual, the head and tail with the bias alone, body_out
    with the residual at scale 1; under autograd none does. Every route
    gives the unfused net's bits (the stand-in kernel's conv adds its bias
    apart, as cuDNN's route does)."""
    calls = []
    monkeypatch.setattr(epilogue, "conv_epilogue", _fake_launch(calls))
    epilogue.reset_launches()
    net = _seeded_net("edsr_m", 3, "bfloat16" if dtype == torch.bfloat16 else "float32")
    x = (torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(2)) * 255)
    ctx = torch.enable_grad() if grad else torch.no_grad()
    with ctx:
        got, counters = _counted(lambda: net(x.as_subclass(_FakeCuda)))
        want = _frozen_edsr(net, x, _conv_then_bias if fused else _conv)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    convs = sum(1 for m in net.modules() if isinstance(m, nets.Conv2d))
    if fused:
        blocks = len(net.blocks)
        assert counters == {"conv_epilogue.fused": convs}
        assert calls == ([("bias", 64)] + [("relu", 64), ("residual", 64)] * blocks
                         + [("residual", 64), ("bias", 27)])
    else:
        assert counters == {"conv_epilogue.plain": convs,
                            "conv_epilogue.plain_autograd": convs} and calls == []
    assert epilogue.LAUNCHES["conv_epilogue"] == (convs if fused else 0)


@pytest.mark.parametrize("name,scale,want", [
    ("espcn", 3, [("relu", 64), ("relu", 32), ("bias", 27)]),
    ("rcan", 3, [("bias", 64)] + [("relu", 64), ("bias", 64), ("bias", 8), ("bias", 64)] * 10
     + [("residual", 64), ("bias", 27)]),
])
def test_espcn_and_rcan_call_sites(monkeypatch, name, scale, want):
    calls = []
    monkeypatch.setattr(epilogue, "conv_epilogue", _fake_launch(calls))
    net = _seeded_net(name, scale, "bfloat16")
    x = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(3)) * 255
    with torch.inference_mode():
        got = net(x.as_subclass(_FakeCuda))
        frozen = _frozen_espcn if name == "espcn" else _frozen_edsr
        assert torch.equal(got.as_subclass(torch.Tensor), frozen(net, x, _conv_then_bias))
    assert calls == want


def test_a_master_weights_step_reaches_the_float32_gradients():
    sd = seeded_params("edsr_m", 2, seed=4, tail_gain=0.5)
    net, _ = build_model("edsr_m", 2, sd, dtype="bfloat16", device="cpu", master_weights=True)
    net.requires_grad_(True)
    x = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(6)) * 255
    with profiling.job() as rec:
        loss = net(x).float().square().mean()
    loss.backward()
    params = dict(net.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    for key in ("head.bias", "blocks.0.conv0.bias", "blocks.0.conv1.weight", "body_out.bias",
                "tail.bias"):
        g = params[key].grad
        assert g is not None and g.dtype == torch.float32 and bool(g.abs().sum() > 0), key
    assert "conv_epilogue.fused" not in rec.counters


# -- the wrapper: what it passes the kernel, and what it refuses -------------------


class _FakeLib:
    """Stands in for the kernel's library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def srs_conv_epilogue(self, y, b, x, s, n, c, inner, dtype, form, stream):
        self.calls.append({"n": n, "c": c, "inner": inner, "dtype": dtype, "form": form,
                           "s": s, "residual": x is not None})
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(epilogue, "load_library", lambda: lib)
    monkeypatch.setattr(epilogue.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(epilogue.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    epilogue.reset_launches()
    return lib


def _flat(t):
    """``t``'s values in the order of its memory."""
    return torch.as_strided(t, (t.numel(),), (1,))


LAYOUT_CASES = {
    # case: (shape, channels_last, dtype, inner the kernel gets)
    "nhwc-bf16": ((2, 12, 5, 7), True, torch.bfloat16, 1),
    "nchw-bf16": ((2, 12, 5, 7), False, torch.bfloat16, 35),
    "nchw-f32": ((1, 3, 4, 6), False, torch.float32, 24),
    "nhwc-f16": ((2, 27, 3, 5), True, torch.float16, 1),
    "gate-nchw": ((2, 16, 1, 1), False, torch.bfloat16, 1),
    "c1-nchw": ((3, 1, 4, 5), False, torch.float32, 1),
}


@pytest.mark.parametrize("form", ["bias", "relu", "residual-0.1"])
@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_the_wrapper_passes_the_kernel_each_layout(fake_lib, case, form):
    """Both dense layouts and the three types reach the kernel, with the
    run of values a channel holds in flat memory (``inner``); value i of
    the memory then has channel (i // inner) mod C, the kernel's rule,
    which this holds against the plain ops."""
    shape, nhwc, dtype, inner = LAYOUT_CASES[case]
    gen = torch.Generator().manual_seed(7)
    y = _nhwc(shape, dtype, gen)
    x = _nhwc(shape, dtype, gen)
    if not nhwc:
        y, x = y.contiguous(), x.contiguous()
    b = (torch.rand(shape[1], generator=gen) - 0.5).to(dtype)
    kw = {"relu": form == "relu"}
    if form.startswith("residual"):
        kw.update(residual=x.as_subclass(_FakeCuda), res_scale=0.1)
    out = epilogue.conv_epilogue(y.as_subclass(_FakeCuda), b, **kw)
    assert out.data_ptr() == y.data_ptr()
    codes = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
    assert fake_lib.calls == [{"n": y.numel(), "c": shape[1], "inner": inner,
                               "dtype": codes[dtype], "form": {"bias": 0, "relu": 1}.get(form, 2),
                               "s": 0.1 if form.startswith("residual") else 1.0,
                               "residual": form.startswith("residual")}]
    assert epilogue.LAUNCHES["conv_epilogue"] == 1
    # the kernel's rule on flat memory, step by step, gives the plain ops' values
    t = (_flat(y).float() + b.float()[(torch.arange(y.numel()) // inner) % shape[1]])
    t = t.to(dtype).float()
    if form == "relu":
        t = t.clamp_min(0.0)
    elif form.startswith("residual"):
        t = _flat(x).float() + (t * torch.tensor(0.1)).to(dtype).float()
    want = epilogue.conv_epilogue_plain(y.clone(), b, **{**kw, "residual": x}
                                        if form.startswith("residual") else kw)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    assert torch.equal(t.to(dtype), _flat(want.contiguous(memory_format=fmt)))


# -- the wrapper's refusals -----------------------------------------------------


def test_the_wrapper_refuses_a_cpu_tensor():
    y = _nhwc((1, 8, 4, 4), torch.bfloat16, torch.Generator().manual_seed(0))
    b = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.conv_epilogue(y, b)


@pytest.mark.parametrize("case", ["strided", "float64", "unaligned", "bias", "residual-nchw",
                                  "residual-shape", "residual-dtype", "relu-and-residual"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fake_lib, case):
    gen = torch.Generator().manual_seed(1)
    y = _nhwc((2, 16, 4, 4), torch.bfloat16, gen)
    x = _nhwc((2, 16, 4, 4), torch.bfloat16, gen)
    b = torch.zeros(16, dtype=torch.bfloat16)
    kw = {}
    if case == "strided":
        y = _nhwc((2, 16, 4, 8), torch.bfloat16, gen)[..., ::2]
    elif case == "float64":
        y = y.double()
    elif case == "unaligned":
        y = torch.empty(y.numel() + 1, dtype=torch.bfloat16)[1:].view(2, 4, 4, 16)
        y = y.permute(0, 3, 1, 2)
    elif case == "bias":
        b = torch.zeros(8, dtype=torch.bfloat16)
    elif case == "residual-nchw":
        kw = {"residual": x.contiguous()}
    elif case == "residual-shape":
        kw = {"residual": x[:1]}
    elif case == "residual-dtype":
        kw = {"residual": x.float()}
    else:
        kw = {"residual": x, "relu": True}
    with pytest.raises(ValueError):
        epilogue.conv_epilogue(y.as_subclass(_FakeCuda), b, **kw)
    assert epilogue.LAUNCHES["conv_epilogue"] == 0 and fake_lib.calls == []
