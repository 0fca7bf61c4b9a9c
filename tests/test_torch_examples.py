"""The port's usage examples (``python -m srs_tpu_torch.examples``), the
counterpart of ``examples/example_usage.py``: the six sections run on the
CPU as a user runs them, and the numbers both scripts print from the same
demo image agree with the reference's.

Tolerances: the tiling merge and the Laplacian fusion's error within 1e-3
of the reference's (canvases within 1e-3 on [0, 255]); the same seam
count; the QA summary's PSNR and MS-SSIM within one unit of the printed
last digit. LPIPS differs by design (the port's seeded features against
the reference's packaged ones) and is only required to print.
"""

import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from srs_tpu_torch import examples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite's parallel workers would otherwise
    each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_examples():
    spec = importlib.util.spec_from_file_location(
        "reference_example_usage", os.path.join(REPO, "examples", "example_usage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _number(text, label):
    m = re.search(re.escape(label) + r"\s*([-0-9.e+]+)", text)
    assert m, (label, text)
    return float(m.group(1))


def test_examples_run_as_a_module_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "srs_tpu_torch.examples", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    heads = [line[3:] for line in proc.stdout.splitlines() if line.startswith("== ")]
    assert heads == list(examples.SECTIONS)
    assert "hybrid stages: ['fast_prefilter', 'quality_main', 'fast_polish']" in proc.stdout
    assert "scheduler: {'total': 2, 'processing': 2}" in proc.stdout
    assert re.search(r"pipeline: True .* score \d", proc.stdout)


def test_tiling_and_blending_example_matches_reference(capsys):
    dev = torch.device("cpu")
    _reference_examples().example_tiling_and_blending()
    ref = capsys.readouterr().out
    examples.example_tiling_and_blending(dev)
    got = capsys.readouterr().out
    assert _number(got, "tiling:") == _number(ref, "tiling:")
    assert _number(got, "merge max err:") <= 1e-3 and _number(ref, "merge max err:") <= 1e-3
    assert abs(_number(got, "laplacian fusion err:")
               - _number(ref, "laplacian fusion err:")) <= 1e-3
    assert _number(got, "seams detected:") == _number(ref, "seams detected:")


def test_quality_example_matches_reference(capsys):
    _reference_examples().example_quality_assessment()
    ref = capsys.readouterr().out
    examples.example_quality_assessment(torch.device("cpu"))
    got = capsys.readouterr().out
    assert abs(_number(got, "PSNR:") - _number(ref, "PSNR:")) <= 0.01 + 1e-9
    assert abs(_number(got, "MS-SSIM:") - _number(ref, "MS-SSIM:")) <= 1e-4 + 1e-12
    assert "LPIPS:" in got and "Overall:" in got
    assert [line.split(":")[0] for line in got.splitlines()] == [
        line.split(":")[0] for line in ref.splitlines()]


def test_examples_run_on_the_card_unless_asked(monkeypatch):
    """Without a card the default device raises; it never falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        examples.main([])
