"""Port parity: the command line's provider and model flags
(``--provider fast|hybrid|fusion|bicubic``, ``--self-ensemble``,
``--prompt``, ``--quality-model rcan|espcn``) against the JAX package's
pipeline on the CPU, as tests/test_torch_cli.py runs the blends: no
weights on either side (the reference's packaged checkpoints hidden), so
every net is the zero-tail bicubic net with IBP on the last step, the
fusion has no trained member and serves the quality net, and the
conditioned polish is the identity.

Tolerance: the outputs differ by at most 1 LSB, on under 1% of samples.
"""

import numpy as np
import pytest
from PIL import Image

import srs_tpu.models.registry as jax_registry
from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch.cli import main
from srs_tpu_torch.io.native import read_tiff
from test_torch_cli import FLAGS, _close, png  # noqa: F401 - the fixture

# (flags, the reference's config, the reference's prompt)
CASES = {
    "fast": (["--provider", "fast"], {"provider": "fast"}, None),
    "hybrid": (["--provider", "hybrid"], {"provider": "hybrid"}, None),
    "fusion": (["--provider", "fusion"], {"provider": "fusion"}, None),
    "bicubic": (["--provider", "bicubic"], {"provider": "bicubic"}, None),
    "self_ensemble": (["--self-ensemble"], {"self_ensemble": True}, None),
    "prompt": (["--prompt", "food"], {}, "food"),
    "rcan": (["--quality-model", "rcan"], {"quality_model": "rcan"}, None),
    "espcn": (["--quality-model", "espcn"], {"quality_model": "espcn"}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flag_matches_reference(png, tmp_path, monkeypatch, capsys, case):
    flags, ref_cfg, prompt = CASES[case]
    monkeypatch.setattr(jax_registry, "PACKAGED_CHECKPOINT_DIR", str(tmp_path / "none"))
    cfg = dict(block_size=32, target_resolution="256x192", quality_model="edsr_m",
               per_scale_selection=False, enable_qa=False)
    cfg.update(ref_cfg)
    pipe = JaxPipeline(JaxConfig(**cfg))
    pipe._ensure_engine()
    pipe.sr_module.config.checkpoint_dir = str(tmp_path / "empty")
    ref_path = str(tmp_path / "ref.png")
    res = pipe.process(png, ref_path, prompt=prompt)
    assert res.success, res.error_message
    with Image.open(ref_path) as im:
        ref = np.asarray(im).astype(np.int16)
    out = str(tmp_path / "out.tiff")
    assert main(["process", png, out, *FLAGS, *flags]) == 0
    assert capsys.readouterr().out.startswith(f"OK {out} (")
    _close(read_tiff(out), ref)
