"""Port parity: the configuration tree (``srs_tpu_torch/config.py``), its
environment overrides, the pipeline's use of it at construction, and the
package's exports, against ``srs_tpu`` on the CPU.

The trees agree field for field, apart from what the port sets apart on
purpose (config.py's docstring): its own cache directories, no model
directory outside the checkout, and the QA device ("cuda" for "tpu").
"""

import dataclasses
import os
import subprocess
import sys

import pytest

import srs_tpu.config  # noqa: F401  (the submodule, for sys.modules)
from srs_tpu.pipeline import PipelineConfig as JaxConfig
from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
from srs_tpu_torch import config as port_config_instance
from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline

import srs_tpu_torch.config  # noqa: F401  (the submodule, for sys.modules)

# Both packages bind their module-level ``config`` over the submodule's
# name, so the modules are taken from sys.modules.
RC = sys.modules["srs_tpu.config"]
TC = sys.modules["srs_tpu_torch.config"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("BLOCK_SIZE", "OVERLAP_RATIO", "TARGET_RESOLUTION", "MAX_CONCURRENT", "QA_DEVICE",
       "SRS_PROVIDER", "SRS_MESH")
# (section, field): where the port differs from the reference on purpose
PORT_OWN = {("model", "checkpoint_dir"), ("tiling", "cache_dir"),
            ("scheduler", "checkpoint_dir"), ("quality", "device")}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def _common(d):
    return {sec: {k: v for k, v in fields.items() if (sec, k) not in PORT_OWN}
            for sec, fields in d.items()}


def test_tree_matches_reference():
    got, ref = TC.SystemConfig().to_dict(), RC.SystemConfig().to_dict()
    assert list(got) == list(ref)
    for sec in ref:
        assert list(got[sec]) == list(ref[sec]), sec
    assert _common(got) == _common(ref)
    assert got["model"]["checkpoint_dir"] is None and got["quality"]["device"] == "cuda"
    assert got["tiling"]["cache_dir"].endswith(os.path.join(".cache", "srs_tpu_torch", "tiling"))
    assert TC.SuperResolutionConfig().target_size() == RC.SuperResolutionConfig().target_size()
    custom = dict(target_resolution="custom", custom_width=640, custom_height=480)
    assert TC.SuperResolutionConfig(**custom).target_size() == (640, 480)
    with pytest.raises(ValueError, match="unknown target"):
        TC.SuperResolutionConfig(target_resolution="8K").target_size()


@pytest.mark.parametrize("var,value,path", [
    ("BLOCK_SIZE", "1024", ("tiling", "block_size")),
    ("OVERLAP_RATIO", "0.25", ("tiling", "overlap_ratio")),
    ("TARGET_RESOLUTION", "150MP", ("super_resolution", "target_resolution")),
    ("MAX_CONCURRENT", "12", ("scheduler", "max_concurrent")),
    ("QA_DEVICE", "cpu", ("quality", "device")),
    ("SRS_PROVIDER", "fast", ("model", "default_provider")),
    ("SRS_MESH", "data=4, space=2", ("parallel", "mesh_shape")),
])
def test_from_env_matches_reference(monkeypatch, var, value, path):
    monkeypatch.setenv(var, value)
    got, ref = TC.SystemConfig.from_env().to_dict(), RC.SystemConfig.from_env().to_dict()
    sec, field = path
    assert got[sec][field] == ref[sec][field] != TC.SystemConfig().to_dict()[sec][field]
    assert _common(got) == _common(ref)


def test_replace_and_the_module_level_config():
    cfg = TC.SystemConfig()
    blend = TC.BlendingConfig(pyramid_levels=4)
    new = cfg.replace(blending=blend)
    assert new.blending is blend and cfg.blending.pyramid_levels == 6
    assert new.tiling is cfg.tiling
    assert isinstance(port_config_instance, TC.SystemConfig)
    assert dataclasses.asdict(port_config_instance) == TC.SystemConfig.from_env().to_dict()


def test_pipeline_builds_its_modules_from_the_environment(monkeypatch):
    """BLOCK_SIZE and OVERLAP_RATIO reach the tiling module where the
    pipeline's own knobs are at the tiling module's defaults (block 2048,
    overlap 0.2), as in the reference; the blending and QA modules take
    the tree's sections."""
    monkeypatch.setenv("BLOCK_SIZE", "96")
    monkeypatch.setenv("OVERLAP_RATIO", "0.25")
    for block, want in ((2048, 96), (64, 64)):
        port = SuperResolutionPipeline(PipelineConfig(block_size=block, device="cpu"))
        ref = JaxPipeline(JaxConfig(block_size=block))
        assert port.tiling_module.block_size == ref.tiling_module.block_size == want
        assert port.tiling_module.overlap_ratio == ref.tiling_module.overlap_ratio == 0.25
        assert port.blending_module.num_levels == ref.blending_module.num_levels == 6
        assert port.blending_module.ssim_threshold == ref.blending_module.ssim_threshold
        assert dataclasses.asdict(port.quality_module.thresholds) == dataclasses.asdict(
            ref.quality_module.thresholds)
    port = SuperResolutionPipeline(PipelineConfig(overlap_ratio=0.2, num_pyramid_levels=4,
                                                  device="cpu"))
    assert port.blending_module.num_levels == 4


_PROBE = r"""
import sys
import srs_tpu_torch as s
before = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "srs_tpu_torch"))
cfg = s.config
names = [s.SuperResolutionPipeline.__name__, s.PipelineConfig.__name__,
         s.PipelineResult.__name__, s.SystemConfig.__name__]
print(before, type(cfg).__name__, names, "torch" in sys.modules, sorted(s.__all__))
"""


def test_package_exports_load_on_first_use():
    """``import srs_tpu_torch`` loads neither torch nor the pipeline; the
    reference's exported names resolve on first use, and ``config`` is the
    environment's configuration, not the submodule."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip()
    assert out == ("['srs_tpu_torch', 'srs_tpu_torch.config'] SystemConfig "
                   "['SuperResolutionPipeline', 'PipelineConfig', 'PipelineResult', "
                   "'SystemConfig'] True ['PipelineConfig', 'PipelineResult', "
                   "'SuperResolutionPipeline', 'SystemConfig', '__version__', 'config']")
