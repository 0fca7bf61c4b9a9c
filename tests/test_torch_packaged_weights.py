"""The port's store of trained weights (``srs_tpu_torch/models/checkpoints/``)
against the reference's packaged checkpoints.

Each ``.pt`` file is ``convert_flax_params`` (a net) or
``convert_lpips_params`` (LPIPS features) of the reference's own restore
on the CPU, bit for bit: the same keys, shapes and float32 values.
``EVAL.json`` and ``FUSION.json`` are byte-equal copies, and
``MANIFEST.json`` gives each file's bytes and sha256. The QA data files
(``srs_tpu_torch/qa/data/``) are byte-equal copies of the reference's.

End to end, the port's ``process()`` with nothing handed in (its store)
is held against the reference's ``process()`` with its packaged
checkpoints on a 96x96 input (64-px tiles) through one x3 step of
``edsr_xl``: the same
served models and routing, no back-projection on either side, the probe's
gain within 0.1 dB and alpha within 0.01 (bfloat16 probe nets on both
sides), the TIFF within 1 LSB and ``lpips_vgg`` / ``lpips_alex`` within
relative 1e-4.

The store is written by running this file:
``python tests/test_torch_packaged_weights.py`` (JAX on the CPU restores
each checkpoint through the reference's loaders).
"""

import hashlib
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script
    sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from srs_tpu.models import registry as jax_registry  # noqa: E402
from srs_tpu_torch.models import registry  # noqa: E402
from srs_tpu_torch.models.lpips import convert_lpips_params  # noqa: E402
from srs_tpu_torch.models.registry import convert_flax_params  # noqa: E402

REF_CKPT = os.path.join(REPO, "srs_tpu", "models", "checkpoints")
STORE = os.path.join(REPO, "srs_tpu_torch", "models", "checkpoints")
REF_QA_DATA = os.path.join(REPO, "srs_tpu", "qa", "data")
PORT_QA_DATA = os.path.join(REPO, "srs_tpu_torch", "qa", "data")

# The main path's nets: every preset's default quality route (edsr_xl at
# x3 and x4), selection's x2 winner, routing's robust and texture nets, the
# fast tier, and both polishes.
STORE_NETS = (
    ("edsr_xl", 3), ("edsr_xl", 4), ("edsr_l", 2),
    ("edsr_l_robust", 2), ("edsr_l_robust", 3), ("edsr_l_tex", 2),
    ("espcn", 2), ("espcn", 3), ("espcn", 4),
    ("espcn_polish", 1), ("cond_polish", 1),
)
LPIPS_NETS = ("vgg", "alex")
LEDGERS = ("EVAL.json", "FUSION.json")
WEIGHT_FILES = tuple(f"{n}_x{s}.pt" for n, s in STORE_NETS) + tuple(
    f"lpips_{n}.pt" for n in LPIPS_NETS)
QA_DATA_FILES = ("brisque_model.npz", "lpips_calib.json", "niqe_pristine.npz")


def _reference_tree(fname):
    """The reference's restore of the checkpoint behind store file ``fname``
    on the CPU, leaves as numpy arrays."""
    stem = fname[:-len(".pt")]
    if stem.startswith("lpips_"):
        from srs_tpu.models.lpips import LPIPSMetric

        tree = LPIPSMetric()._load_checkpoint(stem[len("lpips_"):])
    elif stem == "cond_polish_x1":
        from srs_tpu.models.conditioning import COND_DIM, CondPolish

        module = CondPolish(dtype=jnp.float32)

        def init_fn():
            with jax.ensure_compile_time_eval():
                return module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
                                   jnp.zeros((COND_DIM,), jnp.float32))

        tree = jax_registry._try_load_checkpoint("cond_polish", 1, None, module,
                                                 fallback_packaged=True, init_fn=init_fn)
    else:
        name, scale = stem.rsplit("_x", 1)
        spec = jax_registry.MODEL_REGISTRY[name]
        kwargs = {"scale": int(scale), **spec.kwargs, "dtype": jnp.float32}
        tree = jax_registry._try_load_checkpoint(name, int(scale), None, spec.ctor(**kwargs))
    assert tree is not None, f"the reference did not restore {stem}"
    return jax.tree_util.tree_map(np.asarray, tree)


def _converted(fname):
    tree = _reference_tree(fname)
    return convert_lpips_params(tree) if fname.startswith("lpips_") else convert_flax_params(tree)


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_store(out=STORE):
    """Convert every store file from the reference's checkpoints, copy the
    ledgers, and write MANIFEST.json."""
    os.makedirs(out, exist_ok=True)
    files = {}
    for fname in WEIGHT_FILES:
        sd = _converted(fname)
        assert all(v.dtype == torch.float32 for v in sd.values()), fname
        torch.save(sd, os.path.join(out, fname))
        files[fname] = os.path.join("srs_tpu", "models", "checkpoints", fname[:-len(".pt")])
        print(f"{fname}: {os.path.getsize(os.path.join(out, fname))} bytes", flush=True)
    for fname in LEDGERS:
        shutil.copyfile(os.path.join(REF_CKPT, fname), os.path.join(out, fname))
        files[fname] = os.path.join("srs_tpu", "models", "checkpoints", fname)
    manifest = {
        fname: {"bytes": os.path.getsize(os.path.join(out, fname)),
                "sha256": _sha256(os.path.join(out, fname)), "source": src}
        for fname, src in sorted(files.items())
    }
    with open(os.path.join(out, registry.MANIFEST_NAME), "w") as f:
        json.dump({"files": manifest}, f, indent=1, sort_keys=True)
        f.write("\n")
    os.makedirs(PORT_QA_DATA, exist_ok=True)
    for fname in QA_DATA_FILES:
        shutil.copyfile(os.path.join(REF_QA_DATA, fname), os.path.join(PORT_QA_DATA, fname))


# -- the store against the reference --------------------------------------

_CONVERTED = {}


def _reference_state(fname):
    if fname not in _CONVERTED:
        _CONVERTED[fname] = _converted(fname)
    return _CONVERTED[fname]


@pytest.mark.parametrize("fname", WEIGHT_FILES)
def test_store_file_is_the_reference_conversion(fname):
    got = registry.load_packaged(fname)  # checks the manifest's bytes and sha256
    want = _reference_state(fname)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fname", LEDGERS)
def test_ledger_is_the_references(fname):
    with open(os.path.join(STORE, fname), "rb") as a, open(os.path.join(REF_CKPT, fname),
                                                             "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("fname", WEIGHT_FILES + LEDGERS)
def test_manifest_lists_the_file(fname):
    with open(os.path.join(STORE, registry.MANIFEST_NAME)) as f:
        files = json.load(f)["files"]
    assert set(files) | {registry.MANIFEST_NAME} == set(os.listdir(STORE))
    entry = files[fname]
    path = os.path.join(STORE, fname)
    assert entry["bytes"] == os.path.getsize(path)
    assert entry["sha256"] == _sha256(path)
    assert os.path.exists(os.path.join(REPO, entry["source"]))


@pytest.mark.parametrize("fname", QA_DATA_FILES)
def test_qa_data_is_the_references(fname):
    from srs_tpu_torch.qa.niqe import DATA_DIR

    assert os.path.realpath(DATA_DIR) == os.path.realpath(PORT_QA_DATA)
    with open(os.path.join(DATA_DIR, fname), "rb") as a, open(os.path.join(REF_QA_DATA, fname),
                                                              "rb") as b:
        assert a.read() == b.read()


# -- the store as the port reads it -----------------------------------------

def test_defaults_read_the_store():
    from srs_tpu_torch.models.conditioning import is_cond_polish_trained
    from srs_tpu_torch.models.evaljson import load_eval, packaged_eval_dir
    from srs_tpu_torch.models.fusion import fusion_path

    from srs_tpu.models.evaljson import load_eval as ref_load_eval

    assert os.path.realpath(registry.PACKAGED_CHECKPOINT_DIR) == os.path.realpath(STORE)
    assert os.path.realpath(packaged_eval_dir()) == os.path.realpath(STORE)
    assert load_eval(packaged_eval_dir()) == ref_load_eval(REF_CKPT)
    assert os.path.realpath(fusion_path()) == os.path.realpath(os.path.join(STORE, "FUSION.json"))
    for name, scale in STORE_NETS:
        assert registry.is_pretrained(name, scale), (name, scale)
    assert is_cond_polish_trained()
    assert not registry.is_pretrained("rcan", 2)


def _small_store(tmp_path, files):
    """A store in ``tmp_path`` holding ``files`` of the real one, its
    manifest listing them."""
    with open(os.path.join(STORE, registry.MANIFEST_NAME)) as f:
        listed = json.load(f)["files"]
    tmp_path.mkdir(exist_ok=True)
    for fname in files:
        shutil.copyfile(os.path.join(STORE, fname), tmp_path / fname)
    with open(tmp_path / registry.MANIFEST_NAME, "w") as f:
        json.dump({"files": {k: listed[k] for k in files}}, f)
    return tmp_path


@pytest.mark.parametrize("fault", ["missing", "cut_short", "altered", "not_loadable"])
def test_a_listed_file_at_fault_raises_naming_it(tmp_path, monkeypatch, fault):
    """No quiet fallback: a file the manifest lists that is missing, cut
    short or not loadable raises StoreError naming it, in every reader."""
    from srs_tpu_torch.models import evaljson
    from srs_tpu_torch.models.evaljson import load_eval, packaged_eval_dir
    from srs_tpu_torch.models.lpips import LPIPSMetric
    from srs_tpu_torch.models.sr_module import SuperResolutionModule
    from torch_packaged import packaged_in

    store = _small_store(tmp_path / "store", ["espcn_x2.pt", "lpips_alex.pt", "EVAL.json"])
    packaged_in(monkeypatch, store)
    monkeypatch.setattr(evaljson, "PACKAGED_EVAL_DIR", str(store))
    registry.clear_param_cache()
    manifest = json.loads((store / registry.MANIFEST_NAME).read_text())
    for fname in ("espcn_x2.pt", "lpips_alex.pt", "EVAL.json"):
        path = store / fname
        data = path.read_bytes()
        if fault == "missing":
            path.unlink()
        elif fault == "cut_short":
            path.write_bytes(data[: len(data) // 2])
        elif fault == "altered":
            path.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
        else:  # the manifest agrees with bytes torch cannot load
            path.write_bytes(b"x" * len(data))
            manifest["files"][fname]["sha256"] = _sha256(path)
    (store / registry.MANIFEST_NAME).write_text(json.dumps(manifest))
    # the ledgers' bytes and sha256 at each read; bytes the manifest
    # agrees with raise as the ledger is parsed
    with pytest.raises((registry.StoreError, ValueError), match="EVAL.json"):
        load_eval(packaged_eval_dir())
    if fault in ("missing", "cut_short"):  # found by the size check of every listing
        with pytest.raises(registry.StoreError, match="espcn_x2.pt"):
            registry.is_pretrained("espcn", 2)
        with pytest.raises(registry.StoreError, match="espcn_x2.pt"):
            SuperResolutionModule(device="cpu")
    else:  # found at the first read of the net
        sr = SuperResolutionModule(device="cpu")
        assert sr.is_trained("espcn", 2) and registry.is_pretrained("espcn", 2)
        with pytest.raises(registry.StoreError, match="espcn_x2.pt"):
            sr._net("fast", 2)
    with pytest.raises(registry.StoreError, match="lpips_alex.pt"):
        LPIPSMetric(device="cpu")._net("alex")


def test_an_unstored_net_is_untrained_with_one_warning(tmp_path, monkeypatch, caplog):
    from srs_tpu_torch.models import sr_module
    from torch_packaged import packaged_in

    packaged_in(monkeypatch, _small_store(tmp_path / "store", ["espcn_x2.pt"]))
    monkeypatch.setattr(sr_module, "_WARNED_UNTRAINED", set())
    sr = sr_module.SuperResolutionModule(device="cpu")
    assert sr.is_trained("espcn", 2) and not sr.is_trained("espcn", 3)
    assert sr.trained_scales("fast") == {2}
    with caplog.at_level("WARNING", logger=sr_module.__name__):
        for _ in range(2):
            for s in (2, 3):
                sr._nets.clear()
                sr._net("fast", s)
    warned = [r.getMessage() for r in caplog.records if "untrained" in r.getMessage()]
    assert len(warned) == 1 and warned[0].startswith("espcn_x3:")
    handed = sr_module.SuperResolutionModule(weights={("espcn", 2): registry.seeded_params(
        "espcn", 2, seed=3)}, device="cpu")
    assert torch.equal(handed.weights[("espcn", 2)]["conv_in.weight"],
                       registry.seeded_params("espcn", 2, seed=3)["conv_in.weight"])


def test_trained_weights_read_each_net_once_across_threads(tmp_path, monkeypatch):
    """Workers of the job layer share one mapping: many threads asking for
    the same saved net at once all get it, read once."""
    import threading
    import time

    from srs_tpu_torch.models.train import save_checkpoint
    from torch_packaged import port_store_in

    port_store_in(monkeypatch, tmp_path / "none")
    save_checkpoint(registry.seeded_params("espcn", 2, seed=4), "espcn", 2, str(tmp_path))
    reads = []
    real = registry.load_checkpoint

    def counted(*a, **k):
        reads.append(1)
        time.sleep(0.01)  # a slow disk: the others ask meanwhile
        return real(*a, **k)

    monkeypatch.setattr(registry, "load_checkpoint", counted)
    weights = registry.TrainedWeights(None, str(tmp_path))
    got = []
    start = threading.Barrier(32)

    def ask():
        start.wait(timeout=60)
        got.append(weights.get(("espcn", 2)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 32 and all(g is got[0] for g in got) and got[0] is not None
    assert reads == [1]


# The store's share of the chip copy: the copy (tracked files less
# .chiprunignore) must stay under 200 MB, and the rest of it is about 3 MB.
STORE_BUDGET_BYTES = 160_000_000


def _ignored(rel, pattern):
    """Whether a .gitignore-style ``pattern`` hides the path ``rel``: one
    with a slash inside is anchored at the root and hides what lies under
    the match, one without matches any component."""
    import fnmatch

    pat = pattern.strip().rstrip("/")
    if pat.endswith("/**"):
        pat = pat[:-3]
    parts = rel.split("/")
    if "/" in pat:
        pat = pat.lstrip("/")
        return any(fnmatch.fnmatch("/".join(parts[:i]), pat) for i in range(1, len(parts) + 1))
    return any(fnmatch.fnmatch(part, pat) for part in parts)


@pytest.mark.parametrize("ignore_file", [".gitignore", ".chiprunignore"])
def test_store_is_committed_and_copied_within_its_budget(ignore_file):
    assert sum(os.path.getsize(os.path.join(STORE, f)) for f in os.listdir(STORE)) \
        < STORE_BUDGET_BYTES
    with open(os.path.join(REPO, ignore_file)) as f:
        patterns = [ln for ln in f.read().splitlines() if ln.strip() and not ln.startswith("#")]
    assert _ignored("srs_tpu/models/checkpoints/EVAL.json", "srs_tpu/models/checkpoints")
    files = [os.path.join("srs_tpu_torch", "models", "checkpoints", f) for f in os.listdir(STORE)]
    files += [os.path.join("srs_tpu_torch", "qa", "data", f) for f in QA_DATA_FILES]
    for rel in files:
        assert not any(_ignored(rel, p) for p in patterns), (ignore_file, rel)


# -- end to end: the defaults against the reference's ------------------------

E2E_TARGET = "288x288"  # 96x96 -> x3, one step; 64-px tiles
GAIN_ATOL_DB, ALPHA_ATOL, LPIPS_RTOL = 0.1, 0.01, 1e-4


def _e2e_image(h=96, w=96):
    rng = np.random.default_rng(18)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / 9 + yy / 17), 127 + 90 * np.cos(yy / 7),
                    127 + 80 * np.sin((xx - yy) / 5)], -1)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.float32)


def _count_ibp(monkeypatch, module):
    calls = []
    real = module.back_project

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "back_project", counted)
    return calls


def test_default_process_matches_the_references_packaged_default(tmp_path, monkeypatch):
    """Nothing handed in on either side: the reference serves its packaged
    checkpoints, the port its store."""
    import srs_tpu.models.routing as ref_routing
    import srs_tpu.models.sr_module as ref_sr
    import srs_tpu_torch.models.sr_module as port_sr
    from srs_tpu.pipeline import PipelineConfig as JaxConfig
    from srs_tpu.pipeline import SuperResolutionPipeline as JaxPipeline
    from srs_tpu_torch.io.native import read_tiff
    from srs_tpu_torch.pipeline import PipelineConfig, SuperResolutionPipeline
    from test_torch_tile_store import load_reference_native

    load_reference_native()
    image = _e2e_image()
    ref_ibp, port_ibp = _count_ibp(monkeypatch, ref_sr), _count_ibp(monkeypatch, port_sr)
    jpipe = JaxPipeline(JaxConfig(block_size=64, overlap_ratio=0.2,
                                  target_resolution=E2E_TARGET))
    jpipe._ensure_engine()
    jpipe.sr_module.config.compute_dtype = "float32"
    jres = jpipe.process(image, str(tmp_path / "ref.tiff"))
    assert jres.success, jres.error_message
    ref_info = jpipe.last_run_info

    pipe = SuperResolutionPipeline(PipelineConfig(block_size=64, target_resolution=E2E_TARGET,
                                                  compute_dtype="float32", device="cpu"))
    res = pipe.process(image, str(tmp_path / "out.tiff"))
    assert res.success, res.error_message
    info = pipe.last_run_info

    for key in ("ladder", "provider", "model", "models"):
        assert info[key] == ref_info[key], key
    assert info["ladder"] == [3] and info["models"] == ["edsr_xl"]
    assert info["step_members"] == [[["edsr_xl", 1]]]
    assert pipe.sr_module.is_trained("edsr_xl", 3)
    assert ref_ibp == [] and port_ibp == []
    # the reference records the probe's gain; its estimate and alpha are
    # asked of it again (the same calls, its probe program cached)
    ref_routed, ref_est = jpipe.sr_module.route_for(image)
    ref_gain, ref_alpha = ref_routing.probe_sr_alpha(image, "edsr_xl", 3)
    assert ref_gain == pytest.approx(ref_info["sr_gain_probe"], abs=1e-6)
    routing = info["routing"]
    assert routing["errors"] == [] and routing["model"] is None is ref_routed
    assert routing["degradation"]["reason"] == ref_est.reason
    assert abs(ref_gain - PipelineConfig().sr_gain_floor) >= 0.2  # both take the same route
    assert abs(info["sr_gain_probe"] - ref_gain) <= GAIN_ATOL_DB
    assert abs(routing["alpha"] - ref_alpha) <= ALPHA_ATOL
    got = read_tiff(str(tmp_path / "out.tiff")).astype(np.int16)
    want = read_tiff(str(tmp_path / "ref.tiff")).astype(np.int16)
    assert got.shape == want.shape == (288, 288, 3)
    assert np.abs(got - want).max() <= 1
    assert pipe.quality_module._lpips.sources == {"vgg": "store", "alex": "store"}
    for net in ("vgg", "alex"):
        key = f"lpips_{net}"
        assert res.quality_report[key] == pytest.approx(jres.quality_report[key], rel=LPIPS_RTOL)


if __name__ == "__main__":
    write_store()
    sys.exit(0)
