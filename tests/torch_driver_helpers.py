"""Shared by the driver parity tests (tests/test_torch_drivers_*.py): the
reference's scripts loaded by path, and the guard that no test writes
into the reference."""

import hashlib
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUARDED = ("srs_tpu", "scripts")


def load_script(name):
    """The reference's ``scripts/{name}.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_digests():
    """{path: sha256} of every file under srs_tpu/ and scripts/ (bytecode
    caches, which any import writes, left out)."""
    out = {}
    for top in GUARDED:
        for root, dirs, files in os.walk(os.path.join(REPO, top)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                path = os.path.join(root, f)
                h = hashlib.sha256()
                with open(path, "rb") as fh:
                    for block in iter(lambda: fh.read(1 << 20), b""):
                        h.update(block)
                out[os.path.relpath(path, REPO)] = h.hexdigest()
    return out


class ReferenceGuard:
    """``snapshot()`` before a file's driver tests, ``check()`` after them:
    fails if a file under srs_tpu/ or scripts/ appeared, vanished or
    changed in between."""

    def __init__(self):
        self.before = None

    def snapshot(self):
        self.before = reference_digests()

    def check(self):
        assert self.before is not None, "the snapshot test did not run first"
        after = reference_digests()
        changed = sorted(p for p in set(self.before) | set(after)
                         if self.before.get(p) != after.get(p))
        assert not changed, f"driver tests wrote into the reference: {changed}"


def reference_checkpoints_in(monkeypatch, path):
    """The reference reads its packaged checkpoints from ``path`` for the
    rest of the test (and the port its store, which is empty there unless
    ``path`` holds a ``MANIFEST.json``: ``torch_packaged.packaged_in``),
    with empty registry caches of its own (the registry
    keeps, per (net, scale, directory), what loaded). Its
    ``is_pretrained`` answers from the checkpoint directories present, as
    the real one finds them, without building each net it is asked about
    (a pipeline asks about a dozen, each a compile)."""
    import srs_tpu.models.registry as jax_registry
    from torch_packaged import packaged_in

    def present(name, scale=2, checkpoint_dir=None, dtype=None):
        return any(os.path.isfile(os.path.join(d, f"{name}_x{scale}", "_CHECKPOINT_METADATA"))
                   for d in (checkpoint_dir, str(path)) if d)

    packaged_in(monkeypatch, path)
    monkeypatch.setattr(jax_registry, "_CACHE", {})
    monkeypatch.setattr(jax_registry, "_LOADED", {})
    monkeypatch.setattr(jax_registry, "is_pretrained", present)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each driver test runs torch on one thread: its tensors are small, and
    next to the suite's other workers more threads only wait on each other."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
