"""What the harness loads, and what it does without a card."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_PROBE = r"""
import json, sys
sys.path.insert(0, {here!r})
import run
run.observed_pipeline_class()
from srs_tpu_torch.io import native
from srs_tpu_torch.ops.cuda import pyramid
from srs_tpu_torch.models import registry
bench = json.load(open({bench!r}))
for m in bench["per_layer"]:
    run.load_reader(m["name"])
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE.format(here=HERE, bench=os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "srs_tpu_torch" in top
    import run

    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = ""
    for w in bench["workloads"]:
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", w["name"], "--seed", "7",
             "--seconds", "1", "--trace", "0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "metrics" not in out.stdout and "memory_peak_bytes" not in out.stdout


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", bench["workloads"][0]["name"],
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout
