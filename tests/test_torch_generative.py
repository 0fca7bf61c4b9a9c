"""Port parity: the learned generator (``srs_tpu_torch.models.generative``)
against the JAX package's ``srs_tpu.models.generative``, on the CPU.

Weights: the flax init of ``CondUNet(base=8, depth=1|2)`` with every leaf
perturbed by seeded noise (the init's zero layers would hide half the
net), converted with ``convert_ark_params``. The packaged ``ark_gen_x1``
is held by its key and shape mapping (its orbax metadata, read without
restoring: the restore alone takes about 25 s here); ``base=8, depth=2``
has the same tree layout and carries the numbers.

Tolerances: the UNet in float32 within 1e-4 absolute, in bfloat16 above
35 dB PSNR against the reference's bfloat16 output (both round each
layer's output to bfloat16; the order of the float32 accumulations
differs); GroupNorm, the stride-2 convolution and the attention block
within 1e-5; the timestep embedding within 1e-4 (the two float32 exps
differ by an ulp); the nearest-neighbour upsample, the linspace of the
schedules and the class mapping exactly; ``sample_ark`` (3 DDIM steps) and ``refine_ark``
with the reference's draws handed in within 1e-3 on [0, 255] in float32;
the trainer's loss on one given batch within relative 1e-5 and each
gradient within relative 1e-4 of its largest entry; the EMA update within
relative 1e-6. The port's own draws (``torch.Generator``) cannot match
``jax.random``'s, so they are held by shape, determinism and range.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.models import generative as jg
from srs_tpu_torch.models import generative as tg

PSNR_FLOOR_BF16 = 35.0


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the nets are small, and the suite's parallel
    workers would otherwise each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed):
    """Every leaf plus seeded noise of std 0.3 / sqrt(fan-in) (float32)."""
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        fan_in = int(np.prod(x.shape[:-1])) if x.ndim > 1 else x.shape[0]
        return (x + rng.normal(0, 0.3, x.shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)

    return jax.tree_util.tree_map(f, params)


def _pair(base=8, depth=1, dtype="float32", size=16, seed=1):
    """(flax module, perturbed flax params, port module with them)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    m = jg.CondUNet(base=base, depth=depth, dtype=jdt)
    p = m.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1,)),
               jnp.zeros((1,), jnp.int32))
    p = _perturbed(p, seed)
    tm = tg.CondUNet(base=base, depth=depth, dtype=dtype)
    tm.load_state_dict(tg.convert_ark_params(p))
    return m, p, tm.eval()


def _inputs(n=3, size=16, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    t = rng.uniform(1e-4, 1.0, n).astype(np.float32)
    y = rng.integers(0, 9, n).astype(np.int32)
    return x, t, y


def _psnr(a, b, peak):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


@pytest.mark.parametrize("prompt,category", [
    ("a text poster for a sale", None), ("herringbone weave pattern", None), ("", "jewelry"),
    ("food", None), ("anything else at all", None), ("marble texture closeup", "beauty"),
    ("product shot of a watch", None), ("glossy metallic logo", "3c"), ("FURNITURE ", None),
    ("abstract noise", "fashion"), ("a photograph of a landscape", None), (None, "automotive"),
])
def test_class_for_prompt_matches_reference(prompt, category):
    assert tg.class_for_prompt(prompt, category) == jg.class_for_prompt(prompt, category)
    assert tg.ARK_CLASSES == jg.ARK_CLASSES


def test_render_class_and_corpus_match_reference():
    for cls in range(len(tg.ARK_CLASSES)):
        np.testing.assert_array_equal(tg.render_class(3, cls, 40), jg.render_class(3, cls, 40))
    x, y = tg.make_class_corpus(1, 24, seed=5)
    xr, yr = jg.make_class_corpus(1, 24, seed=5)
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_array_equal(y, yr)
    assert x.dtype == np.float32 and y.dtype == np.int32


def test_make_class_corpus_cache_is_whole_and_reread(tmp_path, monkeypatch):
    """The cache goes to the temporary directory under the port's own name,
    written through a temporary file; a corrupt cache is rendered anew."""
    monkeypatch.setattr(tg.tempfile, "gettempdir", lambda: str(tmp_path))
    x, y = tg.make_class_corpus(1, 16, seed=2)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("srs_tpu_torch_ark_corpus_1x16_s2_")
    x2, y2 = tg.make_class_corpus(1, 16, seed=2)  # read back
    np.testing.assert_array_equal(x, x2)
    with open(tmp_path / files[0], "wb") as f:
        f.write(b"PK\x03\x04 half a file")
    x3, _ = tg.make_class_corpus(1, 16, seed=2)
    np.testing.assert_array_equal(x, x3)
    assert os.listdir(tmp_path) == files


def test_timestep_embed_and_schedule_match_reference():
    """The frequencies' linspace is exact; XLA's float32 exp and torch's
    differ by up to 1 ulp on frequencies up to 1000 (ulp 6.1e-5), which
    sin and cos of t times them carry: within 1e-4."""
    t = np.linspace(0.0, 1.0, 37).astype(np.float32)
    for dim in (16, 128):
        got = tg._timestep_embed(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, np.asarray(jg._timestep_embed(jnp.asarray(t), dim)),
                                   atol=1e-4)
    np.testing.assert_allclose(tg.alpha_bar(torch.from_numpy(t)).numpy(),
                               np.asarray(jg.alpha_bar(jnp.asarray(t))), atol=1e-6)
    for args in ((1.0 - 1e-4, 0.0, 51), (0.22, 0.0, 9), (0.0, np.log(1000.0), 64)):
        np.testing.assert_array_equal(tg._linspace(*args).numpy(),
                                      np.asarray(jnp.linspace(*args), np.float32))


@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (9, 10)])
def test_stride2_conv_pads_as_flax_same(hw):
    """flax's SAME at stride 2 pads (0, 1) on an even side, (1, 1) on an odd."""
    x = np.random.default_rng(3).normal(size=(2, *hw, 4)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), dtype=jnp.float32)
    p = _perturbed(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    want = np.asarray(conv.apply(p, jnp.asarray(x)))
    down = tg._DownConv(4, 6)
    down.load_state_dict(dict(zip(("weight", "bias"), (
        torch.from_numpy(np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(np.asarray(p["params"]["bias"]))))))
    with torch.no_grad():
        got = down(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_group_norm_matches_flax_in_float32_on_bf16_input():
    x = np.random.default_rng(5).normal(2.0, 3.0, size=(2, 6, 7, 24)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gn = fnn.GroupNorm(num_groups=6, dtype=jnp.float32)
    p = _perturbed(gn.init(jax.random.PRNGKey(0), xb), 6)
    want = np.asarray(gn.apply(p, xb))
    norm = tg._GroupNorm(24)
    assert norm.num_groups == 6 and norm.eps == 1e-6
    norm.load_state_dict({"weight": torch.from_numpy(np.asarray(p["params"]["scale"])),
                          "bias": torch.from_numpy(np.asarray(p["params"]["bias"]))})
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = norm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_attention_block_matches_reference():
    x = np.random.default_rng(7).normal(size=(2, 4, 5, 16)).astype(np.float32)
    attn = jg._Attn(jnp.float32)
    p = _perturbed(attn.init(jax.random.PRNGKey(2), jnp.asarray(x)), 8)
    want = np.asarray(attn.apply(p, jnp.asarray(x)))
    ta = tg._Attn(16, torch.float32)
    sd = tg.convert_ark_params({"_Attn_0": p["params"]})
    ta.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ta(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_nearest_upsample_equals_jax_resize():
    h = np.random.default_rng(9).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(h), (2, 10, 14, 3), "nearest"))
    got = torch.from_numpy(h).permute(0, 3, 1, 2)
    got = got.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_reference(depth, dtype):
    m, p, tm = _pair(depth=depth, dtype=dtype)
    x, t, y = _inputs()
    want = np.asarray(m.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    assert np.abs(want).max() > 0.1  # the perturbed zero layers carry signal
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        assert _psnr(got, want, np.abs(want).max()) > PSNR_FLOOR_BF16


def test_untrained_unet_outputs_zero():
    """The zero-initialised last conv: an untrained UNet predicts v = 0."""
    tm = tg.CondUNet(base=8, depth=1, dtype="float32")
    tm.load_state_dict(tg.init_ark_params(tm, seed=3))
    x, t, y = _inputs()
    with torch.no_grad():
        assert not tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)).any()
    sd = tg.init_ark_params(tm, seed=3)
    assert all(not sd[k].any() for k in sd if k.startswith(("attns.0.proj", "resblocks.0.conv1")))
    assert sd["resblocks.0.conv0.weight"].std() > 0 and (sd["norm_out.weight"] == 1).all()


def test_converter_maps_the_packaged_tree():
    """The packaged ark_gen_x1's tree (orbax metadata: names and shapes)
    converts to exactly the port's state dict at the packaged geometry."""
    import orbax.checkpoint as ocp

    from srs_tpu.models.registry import PACKAGED_CHECKPOINT_DIR

    path = os.path.join(PACKAGED_CHECKPOINT_DIR, "ark_gen_x1")
    with open(os.path.join(PACKAGED_CHECKPOINT_DIR, "ark_meta.json")) as f:
        meta = json.load(f)
    md = ocp.StandardCheckpointer().metadata(os.path.abspath(path))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                  getattr(md, "item_metadata", md))
    sd = tg.convert_ark_params(tree)
    tm = tg.CondUNet(base=meta["base"], depth=meta["depth"])
    want = tm.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in want)
    assert tg._geometry(sd) == (meta["base"], meta["depth"])
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == len(sd) == 213


def test_sample_ark_matches_reference_with_its_noise():
    m, p, tm = _pair(depth=2, size=16)
    key = jax.random.PRNGKey(7)
    for cls, guidance in ((2, 2.0), (5, 1.0)):
        want = np.asarray(jg.sample_ark(m, p, cls, key, size=16, steps=3, guidance=guidance))
        noise = np.asarray(jax.random.normal(key, (1, 16, 16, 3)))
        got = tg.sample_ark(tm, cls, size=16, steps=3, guidance=guidance, noise=noise).numpy()
        assert got.shape == (1, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_ark_draws_are_seeded():
    _, _, tm = _pair(depth=1, size=16)
    a = tg.sample_ark(tm, 2, seed=7, size=16, steps=2)
    np.testing.assert_array_equal(a, tg.sample_ark(tm, 2, seed=7, size=16, steps=2))
    b = tg.sample_ark(tm, 2, seed=8, size=16, steps=2)
    assert float((a - b).abs().mean()) > 0.1
    assert 0.0 <= float(a.min()) and float(a.max()) <= 255.0


def test_refine_ark_matches_reference_with_its_eps():
    m, p, tm = _pair(depth=1, size=16)
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    img = np.clip(np.stack([yy * 6, xx * 4, yy * 3 + xx * 2], -1), 0, 255).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jg.refine_ark(m, p, jnp.asarray(img), cls=2, key=key, t0=0.08, steps=3,
                                    tile=16, chunk=8))
    from srs_tpu_torch.tiling.geometry import compute_layout

    n = compute_layout(56, 40, block_size=16, overlap_ratio=0.25).num_tiles
    eps, k = [], key
    for s0 in range(0, n, 8):
        k, sub = jax.random.split(k)
        eps.append(np.asarray(jax.random.normal(sub, (min(8, n - s0), 16, 16, 3))))
    got = tg.refine_ark(tm, img, cls=2, t0=0.08, steps=3, tile=16, chunk=8,
                        eps=np.concatenate(eps)).numpy()
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    # the port's own draws: deterministic by seed, structure kept
    own = tg.refine_ark(tm, img, cls=2, seed=1, t0=0.08, steps=3, tile=16, chunk=8)
    np.testing.assert_array_equal(own, tg.refine_ark(tm, img, cls=2, seed=1, t0=0.08,
                                                     steps=3, tile=16, chunk=8))
    assert np.corrcoef(own.numpy().ravel(), img.ravel())[0, 1] > 0.85


def test_trainer_loss_and_gradients_match_reference():
    m, p, tm = _pair(depth=2, size=16)
    rng = np.random.default_rng(12)
    x0 = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    y = np.asarray([0, 3, 8, 5], np.int32)  # 8: the unconditional token
    t = rng.uniform(1e-4, 1.0, 4).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)

    def loss_fn(pp):
        ab = jg.alpha_bar(jnp.asarray(t))[:, None, None, None]
        xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * eps
        v = m.apply(pp, xt, jnp.asarray(t), jnp.asarray(y))
        return jnp.mean((v - jg._vt_from(jnp.asarray(x0), jnp.asarray(eps), ab)) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(p)
    tm.requires_grad_(True)
    loss = tg.ark_loss(tm, *(torch.from_numpy(a) for a in (x0, y, t, eps)))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_sd = tg.convert_ark_params(want_grads)
    grads = dict(tm.named_parameters())
    assert sorted(grads) == sorted(want_sd)
    for k, g in want_sd.items():
        got = grads[k].grad.numpy()
        np.testing.assert_allclose(got, g.numpy(), rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-12, err_msg=k)


def test_ema_update_matches_reference():
    rng = np.random.default_rng(13)
    ema = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    params = [rng.normal(size=a.shape).astype(np.float32) for a in ema]
    want = jax.tree_util.tree_map(lambda e, q: e * 0.999 + q * (1 - 0.999),
                                  [jnp.asarray(a) for a in ema], [jnp.asarray(a) for a in params])
    got = [torch.from_numpy(a.copy()) for a in ema]
    tg._ema_update(got, [torch.from_numpy(a) for a in params], 0.999)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_train_ark_tiny_saves_reloads_and_warm_starts(tmp_path, monkeypatch):
    from torch_packaged import port_store_in

    port_store_in(monkeypatch, tmp_path / "no_store")  # "none" below finds no generator
    x = np.stack([tg.render_class(i, c, 32) for c in range(8) for i in range(2)])
    y = np.asarray([c for c in range(8) for _ in range(2)], np.int32)
    logged, steps_seen = [], []
    module, ema, loss = tg.train_ark(
        steps=4, size=32, base=8, depth=1, batch=4, scan_chunk=2, corpus=(x, y),
        checkpoint_dir=str(tmp_path), device="cpu", dtype="float32",
        log_fn=lambda s, v: logged.append((s, v)), on_step=lambda s, v: steps_seen.append(s))
    assert np.isfinite(loss) and logged == [(4, loss)] and steps_seen == [0, 1, 2, 3]
    # the sidecar is the one the reference writes (generative.py:459-460)
    with open(tmp_path / "ark_meta.json") as f:
        assert f.read() == json.dumps({"size": 32, "base": 8, "depth": 1})
    assert tg.ark_meta(str(tmp_path)) == {"size": 32, "base": 8, "depth": 1}
    assert tg.is_ark_trained(str(tmp_path)) and not tg.is_ark_trained(str(tmp_path / "none"))
    tg.clear_ark_cache()
    try:
        built, params, trained = tg.build_ark(str(tmp_path), device="cpu", dtype="float32")
        assert trained and built.base == 8 and built.depth == 1
        for k, v in ema.items():
            torch.testing.assert_close(params[k], v, rtol=0, atol=0)
            torch.testing.assert_close(built.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(module.state_dict(), ema, rtol=0, atol=0)
        # the result of a directory is cached until clear_ark_cache
        assert tg.build_ark(str(tmp_path), device="cpu", dtype="float32")[0] is built
        # warm start from the saved checkpoint
        _, ema2, loss2 = tg.train_ark(steps=2, size=32, base=8, depth=1, batch=4, scan_chunk=2,
                                      corpus=(x, y), init_from=str(tmp_path), device="cpu",
                                      dtype="float32")
        assert np.isfinite(loss2) and sorted(ema2) == sorted(ema)
        with pytest.raises(FileNotFoundError):
            tg.train_ark(steps=2, size=32, base=8, depth=1, batch=4, scan_chunk=2,
                         corpus=(x, y), init_from=str(tmp_path / "none"), device="cpu")
        # handed-in weights: base and depth from their shapes, not cached
        m2, _, tr2 = tg.build_ark(params=ema, device="cpu")
        assert tr2 and (m2.base, m2.depth) == (8, 1) and m2.dtype == torch.bfloat16
        assert tg.build_ark(str(tmp_path / "none"), device="cpu") == (None, None, False)
    finally:
        tg.clear_ark_cache()


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, p, _ = _pair(depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.build_ark(params=tg.convert_ark_params(p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.train_ark(steps=1, corpus=(np.zeros((8, 16, 16, 3), np.float32),
                                      np.arange(8, dtype=np.int32)))
