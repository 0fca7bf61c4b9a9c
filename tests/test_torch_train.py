"""Port parity: the trainer (``srs_tpu_torch.models.train``) and the nets'
float32 master weights against the JAX package, on the CPU.

Inputs come from seeded numpy generators. Tolerances: ``area`` and
``bicubic`` degradation and the ``robust`` arm given the same sigma and
noise within 1e-4 on [0, 255]; the Charbonnier loss within relative 1e-6;
five optimizer steps of ``ESPCN(features=16)`` in float32 (weights
converted from the flax init) with loss and gradient norm within relative
1e-4 at every step (float32 sums in another order); the cosine schedule
within relative 1e-6; zssr's tuned output within 5e-3 on [0, 255] in
float32 and above 40 dB PSNR against the reference in bfloat16; the
holdout panel within 1e-3 dB. Random draws the port makes with a
``torch.Generator`` (the robust ladder, the trainer's batches) are held
by their ranges and shares; ``sample_patches`` draws exactly the
reference's values from the same numpy generator.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srs_tpu.models import train as jt
from srs_tpu.models.nets import EDSR as JaxEDSR
from srs_tpu.models.nets import ESPCN as JaxESPCN
from srs_tpu.models.nets import RCAN as JaxRCAN
from srs_tpu_torch.models import registry, train
from srs_tpu_torch.models.conditioning import cond_vector
from srs_tpu_torch.models.nets import ESPCN
from srs_tpu_torch.models.registry import (build_model, convert_flax_params, init_params,
                                           load_checkpoint, seeded_params)
from srs_tpu_torch.models.sr_module import SuperResolutionModule
from srs_tpu_torch.config import ModelConfig

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: these nets are small, and the suite's parallel
    workers would otherwise each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hr(seed, n=4, size=24):
    return np.random.default_rng(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _espcn16(seed=0, tail=0.05):
    """(flax module, flax params, port net) of ESPCN(features=16, x2) in
    float32, the flax init with a non-zero last conv."""
    module = JaxESPCN(scale=2, features=16, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(seed),
                                                            jnp.zeros((1, 12, 12, 3))))
    out = params["params"]["conv_out"]
    rng = np.random.default_rng(seed + 100)
    out["kernel"] = rng.normal(0, tail, out["kernel"].shape).astype(np.float32)
    net = ESPCN(scale=2, features=16, dtype=torch.float32)
    net.load_state_dict(convert_flax_params(params))
    return module, jax.tree_util.tree_map(jnp.asarray, params), net


# -- degradation and loss --------------------------------------------------------------------

@pytest.mark.parametrize("method,size", [("area", 24), ("bicubic", 24), ("area", 26)])
def test_degrade_matches_reference(method, size):
    hr = _hr(1, size=size)
    ref = np.asarray(jt.degrade(jnp.asarray(hr), 12, 2, method))
    got = train.degrade(torch.from_numpy(hr), 12, 2, method).numpy()
    assert got.shape == ref.shape == (4, 12, 12, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("scale", [2, 3])
def test_robust_arm_matches_reference_given_the_draws(scale):
    hr = _hr(2, n=3, size=12 * scale)
    rng = np.random.default_rng(3)
    sigma = np.array([1e-3, 0.7, 1.8], np.float32)
    nsigma = np.array([0.0, 3.5, 8.0], np.float32)
    noise = rng.normal(0, 1, (3, 12, 12, 3)).astype(np.float32)
    ref = []
    for i in range(3):
        xs = jnp.arange(-3, 4, dtype=jnp.float32)
        w = jnp.exp(-0.5 * (xs / sigma[i]) ** 2)
        lr = jt.downsample_area(jt._sep_blur7(jnp.asarray(hr[i : i + 1]), w / w.sum()), scale)[0]
        ref.append(np.asarray(jnp.clip(lr + jnp.asarray(noise[i]) * nsigma[i], 0.0, 255.0)))
    got = train.robust_degrade(torch.from_numpy(hr), scale, torch.from_numpy(sigma),
                               torch.from_numpy(nsigma), torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, np.stack(ref), atol=ATOL)


def test_robust_draws_are_per_image_within_their_ranges():
    gen = torch.Generator().manual_seed(0)
    d = train.robust_draws(512, (6, 6, 3), gen)
    clean = d["clean"].numpy()
    # 30% clean: 153.6 expected, sd 10.4; bounds at five sds
    assert 100 <= clean.sum() <= 207
    sig, nsig = d["sigma"].numpy(), d["nsigma"].numpy()
    assert np.all(sig[clean] == np.float32(1e-3)) and np.all(nsig[clean] == 0.0)
    assert sig[~clean].min() >= 0.2 and sig[~clean].max() <= 1.8
    assert nsig[~clean].min() >= 0.0 and nsig[~clean].max() <= 8.0
    assert np.ptp(sig[~clean]) > 1.4 and np.ptp(nsig[~clean]) > 7.0  # drawn per image
    # degrade draws the same values from the generator it is given
    hr = torch.from_numpy(_hr(4, n=512, size=12))
    got = train.degrade(hr, 6, 2, "robust", generator=torch.Generator().manual_seed(0))
    d = train.robust_draws(512, (6, 6, 3), torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, train.robust_degrade(hr, 2, **d), rtol=0, atol=0)
    clean_lr = got.numpy()[d["clean"].numpy()]
    area = train.downsample_area(hr, 2).numpy()[d["clean"].numpy()]
    np.testing.assert_allclose(clean_lr, area, atol=1e-3)  # the clean arm is the box mean


def test_charbonnier_loss_matches_reference():
    a, b = _hr(5), _hr(6)
    ref = float(jt.charbonnier_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(train.charbonnier_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(ref, rel=1e-6)


# -- the optimizer ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["five_steps", "clip_fires"])
def test_train_step_matches_reference(case):
    """Five steps on random batches (gradient norms well under 1), and
    three where the clip fires: a large last conv, dark inputs and a
    bright target make the gradients add up (norm over 1)."""
    clip = case == "clip_fires"
    module, params, net = _espcn16(tail=2.0 if clip else 0.05)
    tx = jt.make_optimizer(1e-3)
    state = tx.init(params)
    net, opt = train.init_train_state(net, 1e-3)
    rng = np.random.default_rng(7)
    norms = []
    for step in range(3 if clip else 5):
        hr = rng.uniform(0, 255, (8, 24, 24, 3)).astype(np.float32)
        lr = np.asarray(jt.degrade(jnp.asarray(hr), 12, 2))
        if clip:
            lr, hr = lr * 0.1, np.full_like(hr, 250.0)
        params, state, m = jt.train_step(module.apply, params, state, tx, jnp.asarray(lr),
                                         jnp.asarray(hr))
        got = train.train_step(net, opt, torch.from_numpy(lr.copy()), torch.from_numpy(hr))
        assert float(got["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4), step
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-4), step
        norms.append(float(got["grad_norm"]))
    assert (min(norms) > 1.0) if clip else (max(norms) < 1.0), norms
    flat = jax.tree_util.tree_map(np.asarray, params)
    for k, v in convert_flax_params(flat).items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=1e-3, atol=1e-5)


def test_cosine_schedule_matches_optax():
    steps = 300
    ref = optax.cosine_decay_schedule(2e-4, steps, alpha=0.05)
    got = train.cosine_decay_schedule(2e-4, steps, alpha=0.05)
    for count in (0, steps // 2, steps, steps + 7):
        assert got(count) == pytest.approx(float(ref(count)), rel=1e-6), count


def test_optimizer_reads_the_schedule_before_each_update():
    p = torch.nn.Parameter(torch.zeros(3))
    seen = []
    opt = train.make_optimizer([p], lr=lambda c: seen.append(c) or 1e-3)
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    assert seen == [0, 0, 1, 2] and opt.count == 3  # the first read sets up Adam


# -- patches and zssr ------------------------------------------------------------------------

@pytest.mark.parametrize("degradation", ["area", "bicubic", "robust"])
def test_sample_patches_draws_as_the_reference(degradation):
    img = _hr(8, n=1, size=70)[0][:, :61]
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    lr_ref, hr_ref = jt.sample_patches(r1, img, 5, 12, 2, degradation)
    lr, hr = train.sample_patches(r2, img, 5, 12, 2, degradation)
    np.testing.assert_array_equal(hr.numpy(), hr_ref)
    assert r1.integers(0, 2**31) == r2.integers(0, 2**31)
    if degradation != "robust":
        np.testing.assert_allclose(lr.numpy(), lr_ref, atol=ATOL)
    else:
        assert lr.shape == lr_ref.shape and float(lr.min()) >= 0 and float(lr.max()) <= 255


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zssr_finetune_matches_reference(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    module, params, _ = _espcn16(seed=1)
    module = JaxESPCN(scale=2, features=16, dtype=jdt)
    image = _hr(10, n=1, size=40)[0]
    tuned_ref = jt.zssr_finetune(module, params, image, scale=2, steps=5, patch=12, batch=8,
                                 lr=1e-3)
    net = ESPCN(scale=2, features=16, dtype=getattr(torch, dtype)).to(torch.float32)
    net.load_state_dict(convert_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tuned = train.zssr_finetune(net, image, scale=2, steps=5, patch=12, batch=8, lr=1e-3)
    for k, v in net.state_dict().items():  # the caller's weights survive
        assert torch.equal(v, before[k]), k
    assert not torch.equal(tuned.state_dict()["conv_in.weight"], before["conv_in.weight"])
    x = _hr(11, n=2, size=16)
    ref = np.asarray(module.apply(tuned_ref, jnp.asarray(x)))
    with torch.no_grad():
        got = tuned(torch.from_numpy(x)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=5e-3)
    else:
        assert _psnr(got, ref) > 40.0


def test_zssr_finetune_runs_inside_inference_mode():
    _, _, net = _espcn16()
    with torch.inference_mode():
        tuned = train.zssr_finetune(net, _hr(12, n=1, size=30)[0], steps=2, patch=12, batch=2)
    assert not tuned.conv_in.weight.requires_grad


# -- master weights and the from-scratch init --------------------------------------------------

CASES = [("espcn", 2), ("espcn", 3), ("espcn_polish", 1), ("edsr_m", 4), ("rcan", 2),
         ("cond_polish", 1)]


@pytest.mark.parametrize("name,scale", CASES)
def test_master_weights_serve_the_same_bits(name, scale):
    """float32 master weights cast at each conv give bitwise the output of
    the serving net, whose parameters are held in the compute type."""
    sd = seeded_params(name, scale, seed=3)
    x = torch.from_numpy(_hr(13, n=2, size=10))
    for dtype in ("bfloat16", "float32"):
        serving, _ = build_model(name, scale, sd, dtype=dtype, device="cpu")
        master, _ = build_model(name, scale, sd, dtype=dtype, device="cpu", master_weights=True)
        assert all(p.dtype == torch.float32 for p in master.parameters())
        assert all(p.dtype == getattr(torch, dtype) for p in serving.parameters())
        args = (x, cond_vector("food")) if name == "cond_polish" else (x,)
        with torch.no_grad():
            assert torch.equal(serving(*args), master(*args)), dtype


@pytest.mark.parametrize("family,ctor", [("espcn", JaxESPCN), ("edsr_m", JaxEDSR),
                                         ("rcan", JaxRCAN)])
def test_init_params_follow_flax_init(family, ctor):
    """LeCun-normal weights (std sqrt(1/fan_in), truncated at 2 stds), zero
    biases and a zero last conv, as flax's init; the draw is the port's."""
    kwargs = dict(registry.MODEL_REGISTRY[family].kwargs)
    ref = convert_flax_params(jax.tree_util.tree_map(
        np.asarray, ctor(scale=2, **kwargs).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))))
    got = init_params(family, 2, seed=0)
    assert set(got) == set(ref)
    assert torch.equal(init_params(family, 2, seed=0)["head.weight" if family != "espcn"
                                                        else "conv_in.weight"],
                       got["head.weight" if family != "espcn" else "conv_in.weight"])
    for k, v in got.items():
        if k.endswith("bias") or k.startswith(("tail.", "conv_out.")):
            assert not v.any() and not ref[k].any(), k
            continue
        std = math.sqrt(1.0 / v[0].numel())
        assert float(v.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
        if v.numel() >= 2000:
            assert float(v.std()) == pytest.approx(float(ref[k].std()), rel=0.1), k
            assert float(v.std()) == pytest.approx(std, rel=0.1), k


# -- the synthetic trainer, checkpoints and the holdout panel ---------------------------------

@pytest.fixture()
def espcn16(monkeypatch):
    """The registry's espcn at 16 features, for the trainer's tests."""
    spec = registry.MODEL_REGISTRY["espcn"]
    monkeypatch.setitem(registry.MODEL_REGISTRY, "espcn",
                        registry.ModelSpec("espcn", ESPCN, {"features": 16}, spec.description))


def test_train_synthetic_learns_logs_and_saves(espcn16, tmp_path):
    corpus = np.stack([train_corpus_image(i) for i in range(4)])
    logged, losses = [], []
    state, loss = train.train_synthetic(
        "espcn", 2, steps=400, patch=12, batch=16, lr=2e-3, corpus=corpus, scan_chunk=200,
        checkpoint_dir=str(tmp_path), log_fn=lambda s, v: logged.append((s, v)),
        device="cpu", on_step=lambda i, m: losses.append(float(m["loss"])))
    # 400 steps in 2 chunks of 200; the loss is logged at the last chunk only
    # (every max(1, 1000 // 200) = 5th chunk, and the last)
    assert [s for s, _ in logged] == [400] and len(losses) == 400
    assert loss == pytest.approx(np.mean(losses[200:]), rel=1e-5) and logged[0][1] == loss
    assert np.mean(losses[200:]) < np.mean(losses[:200])
    # the net beats its start (bicubic) on the whole corpus
    hr = torch.from_numpy(corpus)
    nets = [build_model("espcn", 2, sd, device="cpu")[0] for sd in (None, state)]
    with torch.no_grad():
        before, after = (float(train.charbonnier_loss(n(train.downsample_area(hr, 2)), hr))
                         for n in nets)
    assert after < 0.98 * before
    saved = load_checkpoint("espcn", 2, str(tmp_path))
    assert set(saved) == set(state)
    for k, v in state.items():
        assert saved[k].dtype == torch.float32 and torch.equal(saved[k], v), k
    # the step count and the log points follow the reference's rule
    assert train._log_points(20, 50) == [50]
    assert train._log_points(4000, 50) == [1000, 2000, 3000, 4000]
    assert train._log_points(2500, 1000) == [1000, 2000]
    sr = SuperResolutionModule(ModelConfig(checkpoint_dir=str(tmp_path), quality_model="espcn"),
                               device="cpu")
    assert sr.is_trained("espcn", 2) and not sr.is_trained("espcn", 3)


def train_corpus_image(seed):
    from srs_tpu_torch.models.corpus import render_image

    return render_image(seed, 64)


def test_train_synthetic_starts_from_init_from(espcn16, tmp_path):
    with pytest.raises(FileNotFoundError, match="espcn_x2"):
        train.train_synthetic("espcn", 2, steps=1, scan_chunk=1, corpus_n=1, corpus_size=32,
                              patch=12, batch=2, init_from=str(tmp_path), device="cpu")
    train.save_checkpoint(init_params("espcn", 2, seed=5), "espcn", 2, str(tmp_path))
    a, _ = train.train_synthetic("espcn", 2, steps=1, scan_chunk=1, corpus_n=1, corpus_size=32,
                                 patch=12, batch=2, lr=0.0, init_from=str(tmp_path),
                                 device="cpu")
    for k, v in init_params("espcn", 2, seed=5).items():
        torch.testing.assert_close(a[k], v, rtol=0, atol=1e-6)


def test_eval_on_holdout_matches_reference():
    module, params, net = _espcn16(seed=2)
    ref = jt.eval_on_holdout(module, params, 2, n=2, size=48, ibp_steps=3)
    got = train.eval_on_holdout(net, 2, n=2, size=48, ibp_steps=3)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-3, k
    assert got["psnr_net"] != got["psnr_bicubic"]


def test_train_from_images_trains_on_png_files(tmp_path):
    from srs_tpu_torch.io.image import save_image

    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"hr{i}.png"))
        save_image(paths[-1], train_corpus_image(i)[:40])
    save_image(str(tmp_path / "small.png"), train_corpus_image(3)[:20, :20])
    state, loss = train.train_from_images(paths + [str(tmp_path / "small.png")], "espcn_polish",
                                          1, steps=3, patch=16, batch=2, log_every=2,
                                          checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    assert np.isfinite(loss) and (tmp_path / "ck" / "espcn_polish_x1.pt").is_file()
    with pytest.raises(ValueError, match="no images large enough"):
        train.train_from_images([str(tmp_path / "small.png")], steps=1, device="cpu")
