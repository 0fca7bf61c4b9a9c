"""The port stands alone: importing every module of srs_tpu_torch (and
chip_smoke.py) loads neither jax nor anything of srs_tpu or of the
reference's scripts/, and the sources never name them in an import."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "srs_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import srs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(srs_tpu_torch.__path__, "srs_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax", "srs_tpu",
                                    "scripts"))
print(f"{len(names)}|{','.join(bad)}")
"""


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().splitlines()[-1].split("|")
    # every module: the QA and routing ones, the CLI and __main__, seam
    # repair, colour correction, content-aware tiling, the trainer, the
    # corpus and the photo harvest, commercial QA, the blending module and
    # the examples, the generator, the bench and the FLOP and trace
    # utilities, the device mesh (parallel/ and its six modules), the web
    # UI (webui/, its pages) and utils/logging too; and the drivers
    # (drivers/, one module per reference script)
    assert int(count) >= 94
    assert bad == "", f"imported: {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_jax_or_the_reference(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & {"jax", "jaxlib", "flax", "orbax", "optax", "srs_tpu",
                                 "scripts"}, (path, roots)
