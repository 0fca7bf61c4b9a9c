"""Port parity: zero-shot SR (``provider="zssr"``) in the SR engine, the
pipeline and the command line, against the JAX package on the CPU.

The reference loads its trained nets from a checkpoint directory of its
own (links to the packaged checkpoints a case names, its packaged
directory hidden) and the port gets them converted, as in
tests/test_torch_providers.py. Tolerances: the base net and learning
rate exact; the tuned net's output within 5e-3 on [0, 255] in float32
(three optimizer steps from the same weights on the same patches; float32
sums in another order) and above 40 dB PSNR in bfloat16. Pipeline cases
are the port's own (training a net per job on both sides would not fit
the test budget): ``process(provider="zssr")`` equals the quality path
served with the tuned weights bit for bit; the SR-gain route, the batch,
the resume key and the fallback are held by what they record.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srs_tpu.models.train as jax_train
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.cli import main
from srs_tpu_torch.io.image import save_image
from srs_tpu_torch.io.native import read_tiff
from srs_tpu_torch.models.registry import load_checkpoint, seeded_params
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
from srs_tpu_torch.tiling.geometry import compute_layout
from test_torch_providers import modules

TUNE = dict(steps=3, patch=12, batch=4)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: these nets are small, and the suite's parallel
    workers would otherwise each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed=3, h=40, w=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 5), 127 + 90 * np.cos(yy / 4),
                    127 + 90 * np.sin((xx + yy) / 3)], -1)
    img[h // 4 : h // 2, w // 3 : w // 2] = (230, 30, 60)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.float32)


# case: (trained nets, quality net, the base zssr tunes, its learning rate)
BASES = {
    "quality_trained": ([("edsr_m", 2)], "edsr_m", "edsr_m", 1e-4),
    "fast_trained": ([("espcn", 2)], "edsr_m", "espcn", 1e-4),
    "none_trained": ([], "edsr_m", "espcn", 5e-4),
}


@pytest.mark.parametrize("case", list(BASES))
def test_zssr_base_and_learning_rate_match_reference(case, tmp_path, monkeypatch):
    trained, quality, base, lr = BASES[case]
    ref, port = modules(tmp_path, monkeypatch, trained, quality_model=quality)
    seen = {}

    def record(module, params, lr_image, scale=2, steps=200, patch=48, batch=16, lr=1e-3,
               **_kw):
        seen.update(family=type(module).__name__, lr=lr)
        return params

    monkeypatch.setattr(jax_train, "zssr_finetune", record)
    ref.zssr_prepare(_image(), scale=2, **TUNE)
    port.zssr_prepare(_image(), scale=2, **TUNE)
    info = port.zssr_info[2]
    assert (info["base"], info["lr"]) == (base, lr) == port.zssr_base(2)
    assert seen == {"family": "EDSR" if base == "edsr_m" else "ESPCN", "lr": lr}
    assert info["base_trained"] == ((base, 2) in trained)
    assert info["first_loss"] > 0 and info["steps"] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zssr_output_matches_reference(dtype, tmp_path, monkeypatch):
    ref, port = modules(tmp_path, monkeypatch, [("espcn", 2)], quality_model="espcn")
    ref.config.compute_dtype = port.config.compute_dtype = dtype
    image = _image()
    ref.zssr_prepare(image, scale=2, **TUNE)
    port.zssr_prepare(image, scale=2, **TUNE)
    assert port.zssr_info[2]["base"] == "espcn" and port.zssr_info[2]["lr"] == 1e-4
    tiles = _image(seed=4, h=16, w=16)[None].repeat(2, 0)
    tiles[1] = tiles[1, ::-1]
    want = np.asarray(ref.upscale_tiles(jnp.asarray(tiles), 2, provider="zssr", steps=4))
    with torch.inference_mode():
        got = port.upscale_tiles(torch.from_numpy(tiles), 2, provider="zssr", steps=4).numpy()
        plain = port.upscale_tiles(torch.from_numpy(tiles), 2, provider="quality").numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-3)
    else:
        mse = np.mean((got.astype(np.float64) - want) ** 2)
        assert 10 * np.log10(255.0**2 / mse) > 40.0
    assert np.abs(got - plain).max() > 1e-3  # tuning changed the net


def test_zssr_serves_only_the_tuned_scale(tmp_path, monkeypatch):
    """At a scale it did not tune, zssr serves the quality net (with IBP
    when untrained), as the reference falls through."""
    _, port = modules(tmp_path, monkeypatch, [("espcn", 2)], quality_model="espcn")
    port.zssr_prepare(_image(), scale=2, steps=1, patch=12, batch=2)
    tiles = torch.from_numpy(_image(seed=5, h=12, w=12)[None])
    with torch.inference_mode():
        for scale in (3, 4):
            torch.testing.assert_close(port.upscale_tiles(tiles, scale, provider="zssr", steps=2),
                                       port.upscale_tiles(tiles, scale, steps=2), rtol=0, atol=0)
    assert port.step_members(3, "zssr") == [("espcn", 1)] and 3 not in port.zssr_info


# -- the pipeline ----------------------------------------------------------------------------

PIPE = dict(block_size=64, target_resolution="224x192", auto_route=False, enable_qa=False,
            per_scale_selection=False, quality_model="edsr_m", compute_dtype="float32",
            device="cpu", ibp_steps=4)


@pytest.fixture(scope="module")
def big():
    """A 96x112 input: zssr cuts 48-px LR patches from it at x2."""
    return _image(seed=6, h=96, w=112)


def test_process_zssr_equals_quality_with_the_tuned_weights(big, tmp_path):
    pipe = SuperResolutionPipeline(PipelineConfig(provider="zssr", zssr_steps=2, **PIPE))
    res = pipe.process(big, str(tmp_path / "zssr.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert info["provider"] == "zssr" and info["ladder"] == [2]
    assert info["step_members"] == [[["espcn", 1]]]
    assert (info["zssr"]["base"], info["zssr"]["lr"], info["zssr"]["steps"]) == ("espcn", 5e-4, 2)
    tuned = pipe.sr_module.zssr_nets[2].state_dict()
    quality = SuperResolutionPipeline(PipelineConfig(**{**PIPE, "quality_model": "espcn"}),
                                      {("espcn", 2): tuned})
    res_q = quality.process(big, str(tmp_path / "quality.tiff"))
    assert res_q.success, res_q.error_message
    # the tuned net counts as trained: no IBP on either side, 0 LSB apart
    np.testing.assert_array_equal(read_tiff(res.output_path), read_tiff(res_q.output_path))
    untrained = SuperResolutionPipeline(PipelineConfig(**PIPE))  # bicubic with IBP
    res_u = untrained.process(big, str(tmp_path / "untrained.tiff"))
    assert np.abs(read_tiff(res_u.output_path).astype(int) - read_tiff(res.output_path)).max() > 0


def test_sr_gain_route_zssr_on_a_probe_negative_input(big, tmp_path):
    cfg = PipelineConfig(**{**PIPE, "auto_route": True, "sr_gain_route": "zssr",
                            "sr_gain_floor": 50.0, "zssr_steps": 1})
    pipe = SuperResolutionPipeline(cfg, {("edsr_m", 2): seeded_params("edsr_m", 2, seed=1)})
    res = pipe.process(big, str(tmp_path / "routed.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert info["sr_gain_probe"] is not None and info["sr_gain_probe"] < 50.0
    assert info["provider"] == info["requested_provider"] == "zssr"
    assert info["routing"]["provider"] == "zssr" and info["routing"]["errors"] == []
    assert (info["zssr"]["base"], info["zssr"]["lr"]) == ("edsr_m", 1e-4)


def test_process_batch_runs_zssr_on_one_worker(big, tmp_path):
    pipe = SuperResolutionPipeline(PipelineConfig(provider="zssr", zssr_steps=1, **PIPE))
    threads, real = [], pipe.sr_module.zssr_prepare

    def traced(*args, **kwargs):
        threads.append(threading.current_thread())
        return real(*args, **kwargs)

    pipe.sr_module.zssr_prepare = traced
    jobs = [{"input": big, "output": str(tmp_path / f"b{i}.tiff")} for i in range(2)]
    results = pipe.process_batch(jobs, max_concurrent=2)
    assert all(r.success for r in results), [r.error_message for r in results]
    assert threads == [threading.main_thread()] * 2


def _zssr_key(steps, weights, provider="zssr"):
    pipe = SuperResolutionPipeline(PipelineConfig(provider=provider, zssr_steps=steps,
                                                  enable_checkpoint=True, **PIPE), weights)
    if provider == "zssr":
        pipe.sr_module.zssr_prepare(_image(seed=6, h=96, w=112), scale=2, steps=1, batch=2)
    layout = compute_layout(112, 96, 64, 0.2, step_multiple=32)
    return pipe._resume_key("h0", [2], layout, provider, None, None, None)


def test_resume_key_holds_zssr_steps_and_the_base_weights():
    w1 = {("edsr_m", 2): seeded_params("edsr_m", 2, seed=1)}
    w2 = {("edsr_m", 2): seeded_params("edsr_m", 2, seed=2)}
    assert _zssr_key(10, w1) == _zssr_key(10, w1)
    assert _zssr_key(10, w1) != _zssr_key(20, w1)
    assert _zssr_key(10, w1) != _zssr_key(10, w2)
    assert _zssr_key(10, w1) != _zssr_key(10, w1, provider="quality")
    assert _zssr_key(10, w1, "quality") == _zssr_key(20, w1, "quality")


def test_zssr_falls_back_to_fast(big, tmp_path):
    assert SuperResolutionPipeline._FALLBACK_PROVIDERS["zssr"] == \
        JaxPipeline._FALLBACK_PROVIDERS["zssr"] == "fast"
    pipe = SuperResolutionPipeline(PipelineConfig(provider="zssr", zssr_steps=1, **PIPE))
    real = pipe.sr_module.upscale_tiles

    def failing(tiles, scale, provider="quality", **kw):
        if provider == "zssr":
            raise RuntimeError("injected device failure (simulated OOM)")
        return real(tiles, scale, provider=provider, **kw)

    pipe.sr_module.upscale_tiles = failing
    res = pipe.process(big, str(tmp_path / "fallback.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info
    assert (info["provider"], info["sr_attempts"], info["sr_degradations"]) == ("fast", 5, 1)
    assert info["zssr"] is None and read_tiff(res.output_path).shape == (192, 224, 3)


# -- the command line ------------------------------------------------------------------------

def test_cli_process_zssr(big, tmp_path, capsys):
    png = str(tmp_path / "in.png")
    save_image(png, big)
    out = str(tmp_path / "out.tiff")
    assert main(["process", png, out, "--provider", "zssr", "--zssr-steps", "3", "--target",
                 "224x192", "--block-size", "64", "--pin-quality-model", "--no-qa",
                 "--quality-model", "edsr_m", "--checkpoint-dir", str(tmp_path / "none"),
                 "--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    assert read_tiff(out).shape == (192, 224, 3)


def test_cli_train_writes_a_checkpoint_that_process_loads(tmp_path, capsys):
    ckpt = str(tmp_path / "models")
    assert main(["train", "--synthetic", "--steps", "2", "--corpus-n", "2", "--patch", "12",
                 "--batch", "4", "--checkpoint-dir", ckpt, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "trained espcn x2: final loss" in printed and ckpt in printed
    state = load_checkpoint("espcn", 2, ckpt)
    assert state is not None and state["conv_out.weight"].dtype == torch.float32
    assert state["conv_out.weight"].abs().max() > 0  # trained away from the zero init
    pipe = SuperResolutionPipeline(PipelineConfig(checkpoint_dir=ckpt, **PIPE))
    assert pipe.sr_module.is_trained("espcn", 2)
    assert main(["train", "--device", "cpu", "--checkpoint-dir", ckpt]) == 2
    assert "--synthetic" in capsys.readouterr().err
