"""Port parity: the reference's public names (its subpackage exports and
module-level helpers) in srs_tpu_torch, held against srs_tpu on the same
seeded inputs, on the CPU.

Tolerances: ``resize_bicubic_banded`` within 1e-4 in float32 (data in
[0, 255]) and 1 LSB quantized; ``write_tiff``'s pixels equal at 8 and 16
bits; ``brisque_features`` within relative 1e-3 (float32 sums in another
order; NIQE/BRISQUE's stated tolerance is 2e-2); ``brisque_expand``
exact; the checkpoint probes give the reference's answers on the same
directory.
"""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srs_tpu.models.conditioning as jax_cond
import srs_tpu.models.registry as jax_registry
from srs_tpu.io import native as jax_native
from srs_tpu.models import evaljson as jax_evaljson
from srs_tpu.ops.resize import resize_bicubic_banded as jax_banded
from srs_tpu.qa import niqe as jax_niqe
from srs_tpu_torch.io import native
from srs_tpu_torch.models import conditioning, evaljson, registry
from srs_tpu_torch.ops.resize import resize_bicubic_banded
from srs_tpu_torch.qa import niqe
from srs_tpu_torch.utils.paths import REFERENCE_DIR
from test_torch_providers import PACKAGED
from test_torch_tile_store import load_reference_native

EXPORTS = {
    "models": ["EDSR", "ESPCN", "RCAN", "back_project", "depth_to_space",
               "PromptTemplateManager", "MODEL_REGISTRY", "build_model",
               "SuperResolutionModule", "SuperResolutionResult", "UpscaleConfig",
               "UpscaleProvider", "VeImageXTemplate"],
    "tiling": ["TileLayout", "compute_layout", "TilingModule", "Tile", "TileMetadata",
               "TileStatus", "PaddingMode"],
    "qa": ["QualityAssessmentModule", "AssessmentLevel"],
}
MODULE_NAMES = [
    ("ops.resize", "resize_bicubic_banded"),
    ("models.registry", "is_pretrained"),
    ("models.registry", "clear_param_cache"),
    ("models.registry", "PACKAGED_CHECKPOINT_DIR"),
    ("models.conditioning", "is_cond_polish_trained"),
    ("models.conditioning", "clear_cond_cache"),
    ("models.evaljson", "update_eval"),
    ("models.evaljson", "eval_path"),
    ("models.evaljson", "DERIVED_EVIDENCE"),
    ("qa.niqe", "brisque_features"),
    ("qa.niqe", "brisque_expand"),
    ("io.native", "write_tiff"),
    ("io.native", "available"),
    ("io.native", "load"),
]


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_subpackage_exports_match_the_reference(package):
    port = importlib.import_module(f"srs_tpu_torch.{package}")
    ref = importlib.import_module(f"srs_tpu.{package}")
    assert sorted(port.__all__) == sorted(ref.__all__) == sorted(EXPORTS[package])
    for name in EXPORTS[package]:
        obj = getattr(port, name)
        if name != "MODEL_REGISTRY":  # a dict
            assert obj.__module__.startswith("srs_tpu_torch."), name
        assert type(obj).__name__ == type(getattr(ref, name)).__name__, name


@pytest.mark.parametrize("module,name", MODULE_NAMES)
def test_module_level_names_exist(module, name):
    assert hasattr(importlib.import_module(f"srs_tpu_torch.{module}"), name)
    assert hasattr(importlib.import_module(f"srs_tpu.{module}"), name)


def test_tiling_geometry_imports_without_torch_ops():
    import subprocess
    import sys

    code = ("import sys; import srs_tpu_torch.tiling.geometry; "
            "print(any(m.startswith(('torch', 'srs_tpu_torch.ops', 'srs_tpu_torch.io')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(REFERENCE_DIR))
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("shape,out,crop,bands", [
    ((40, 52), (97, 131), None, 4),
    ((40, 52), (30, 26), (37, 50), 3),
    ((33, 20), (120, 75), None, 8),
])
def test_resize_bicubic_banded_matches_reference(shape, out, crop, bands):
    img = np.random.default_rng(3).random((*shape, 3), dtype=np.float32) * 255
    ch, cw = crop or (None, None)
    kw = dict(bands=bands, crop_h=ch, crop_w=cw)
    ref = np.asarray(jax_banded(jnp.asarray(img), *out, **kw))
    got = resize_bicubic_banded(torch.from_numpy(img), *out, **kw)
    assert got.shape == ref.shape == (*out, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    ref8 = np.asarray(jax_banded(jnp.asarray(img), *out, to_uint8=True, **kw))
    got8 = np.concatenate(list(resize_bicubic_banded(img, *out, to_uint8=True,
                                                     as_iterator=True, **kw)))
    assert got8.dtype == np.uint8
    assert np.abs(got8.astype(np.int16) - ref8).max() <= 1


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_write_tiff_pixels_match_reference(tmp_path, bit_depth):
    load_reference_native()
    img = np.random.default_rng(bit_depth).random((37, 53, 3), dtype=np.float32) * 300 - 20
    jax_native.write_tiff(str(tmp_path / "ref.tiff"), img, bit_depth=bit_depth)
    native.write_tiff(str(tmp_path / "got.tiff"), img, bit_depth=bit_depth)
    ref, got = native.read_tiff(str(tmp_path / "ref.tiff")), native.read_tiff(
        str(tmp_path / "got.tiff"))
    assert got.dtype == (np.uint16 if bit_depth == 16 else np.uint8)
    np.testing.assert_array_equal(got, ref)
    assert native.available() and native.load() is native.load_library()


def test_brisque_features_match_reference():
    img = np.random.default_rng(5).random((96, 120, 3), dtype=np.float32) * 255
    ref = np.asarray(jax_niqe.brisque_features(jnp.asarray(img)), np.float64)
    got = niqe.brisque_features(torch.from_numpy(img)).numpy().astype(np.float64)
    assert got.shape == ref.shape == (36,)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    z = np.random.default_rng(6).normal(size=(4, 36))
    np.testing.assert_array_equal(niqe.brisque_expand(z), jax_niqe.brisque_expand(z))


@pytest.fixture
def clean_caches():
    jax_registry.clear_param_cache()
    jax_cond.clear_cond_cache()
    registry.clear_param_cache()
    conditioning.clear_cond_cache()
    yield
    jax_registry.clear_param_cache()
    jax_cond.clear_cond_cache()


def test_checkpoint_probes_match_reference(tmp_path, monkeypatch, clean_caches):
    """A directory holding the reference's checkpoint of espcn x2 and of the
    polish, and the port's state dicts of the same nets; the reference's
    packaged directory hidden, as the port cannot read it."""
    d = tmp_path / "ckpt"
    d.mkdir()
    for name in ("espcn_x2", "cond_polish_x1"):
        os.symlink(os.path.join(PACKAGED, name), d / name)
        torch.save({}, d / f"{name}.pt")
    monkeypatch.setattr(jax_registry, "PACKAGED_CHECKPOINT_DIR", str(tmp_path / "none"))
    empty = str(tmp_path / "empty")
    for name, scale, where in [("espcn", 2, str(d)), ("espcn", 3, str(d)), ("edsr_m", 2, str(d)),
                               ("espcn", 2, empty)]:
        assert registry.is_pretrained(name, scale, where) == \
            jax_registry.is_pretrained(name, scale, where, dtype=jnp.float32), (name, scale, where)
    assert conditioning.is_cond_polish_trained(str(d)) == jax_cond.is_cond_polish_trained(str(d))
    assert conditioning.is_cond_polish_trained(empty) == jax_cond.is_cond_polish_trained(empty)
    assert registry.PACKAGED_CHECKPOINT_DIR == os.path.join(REFERENCE_DIR, "models",
                                                            "checkpoints")
    # kept until the cache is cleared, as in the reference
    os.makedirs(empty)
    torch.save({}, os.path.join(empty, "espcn_x2.pt"))
    assert not registry.is_pretrained("espcn", 2, empty)
    registry.clear_param_cache()
    assert registry.is_pretrained("espcn", 2, empty)
    torch.save({}, os.path.join(empty, "cond_polish_x1.pt"))
    assert not conditioning.is_cond_polish_trained(empty)
    conditioning.clear_cond_cache()
    assert conditioning.is_cond_polish_trained(empty)
    with pytest.raises(KeyError):
        registry.is_pretrained("no_such_net")


def test_update_eval_matches_reference_and_stays_out_of_the_package(tmp_path, monkeypatch):
    ref_dir, got_dir = tmp_path / "ref", tmp_path / "got"
    ref_dir.mkdir()
    assert evaljson.DERIVED_EVIDENCE == jax_evaljson.DERIVED_EVIDENCE
    steps = [("edsr_m_x2", {"psnr": 30.5, "photo_panel": {"x": 1}}, (), False),
             ("edsr_m_x2", {"steps": 9}, jax_evaljson.DERIVED_EVIDENCE, False),
             ("ark_gen_x1", {"fid": 3.0}, (), False),
             ("ark_gen_x1", {"clip": 0.2}, (), True)]
    for key, fields, drop, replace in steps:
        want = jax_evaljson.update_eval(str(ref_dir), key, dict(fields), drop, replace)
        got = evaljson.update_eval(str(got_dir), key, dict(fields), drop, replace)
        assert got == want
    assert evaljson.eval_path(str(got_dir)) == jax_evaljson.eval_path(str(got_dir))
    with open(ref_dir / "EVAL.json") as f, open(got_dir / "EVAL.json") as g:
        assert json.load(f) == json.load(g)
    assert evaljson.load_eval(str(got_dir)) == jax_evaljson.load_eval(str(ref_dir))
    # no directory: the port's cache under HOME, never the package
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    evaljson.update_eval(None, "k", {"v": 1})
    assert (tmp_path / "home" / ".cache" / "srs_tpu_torch" / "EVAL.json").is_file()
    with pytest.raises(ValueError, match="never writes"):
        evaljson.update_eval(os.path.join(REFERENCE_DIR, "models", "checkpoints"), "k", {})
