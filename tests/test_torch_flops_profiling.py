"""Port parity: the FLOP accounting (``srs_tpu_torch.utils.flops``) and the
stage timer and device trace (``srs_tpu_torch.utils.profiling``) against
the JAX package's ``srs_tpu.utils``, on the CPU.

The counts are exact integers in float64: the port's equal the
reference's within relative 1e-6, per registry net and scale (the
reference counting its flax tree, the port the converted state dict and
the net it builds without storage), and per ladder on the cases of
``tests/test_utils_misc.py::test_multipass_ladder_flops_counts_passes``.
The peak table lists NVIDIA parts only: the H100's dense bfloat16 rate,
and an unknown card counted at it with its name echoed. The stage timer's
report has the reference's structure; the device trace writes a
``torch.profiler`` trace file on the CPU.
"""

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srs_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from srs_tpu.utils import flops as jflops
from srs_tpu.utils.profiling import StageTimer as JaxStageTimer
from srs_tpu_torch.models.registry import MODEL_REGISTRY, PORT_ONLY, convert_flax_params
from srs_tpu_torch.utils import flops
from srs_tpu_torch.utils.profiling import StageTimer, device_trace, trace_region

RTOL = 1e-6
# The nets both packages have (HAT is the port's alone: tests/test_torch_hat.py).
SHARED = sorted(set(MODEL_REGISTRY) - set(PORT_ONLY))
NETS = [(name, s) for name in SHARED for s in ((1,) if name == "espcn_polish" else (2, 3, 4))]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_shapes(name, scale):
    spec = JAX_REGISTRY[name]
    module = spec.ctor(**{"scale": scale, **spec.kwargs, "dtype": jnp.float32})
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 16, 16, 3), jnp.float32)))


def test_registry_names_match_reference():
    assert SHARED == sorted(JAX_REGISTRY)
    assert set(PORT_ONLY) <= set(MODEL_REGISTRY) and not set(PORT_ONLY) & set(JAX_REGISTRY)


@pytest.mark.parametrize("name,scale", NETS)
def test_conv_flops_per_pixel_matches_reference(name, scale):
    shapes = _flax_shapes(name, scale)
    want = jflops.conv_flops_per_pixel(shapes)
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    got = flops.conv_flops_per_pixel(convert_flax_params(zeros))
    assert want > 0 and abs(got - want) <= RTOL * want
    assert abs(flops._net_flops_per_pixel(name, scale) - want) <= RTOL * want


def test_ladder_flops_match_reference():
    """The reference's multi-pass cases (8 passes count 8 times, members
    sum, step 2 runs at step 1's output size), and a mixed two-step
    ladder."""
    cases = [
        (flops.ladder_flops("espcn", [2], 64, 4), jflops.ladder_flops("espcn", [2], 64, 4)),
        (flops.multipass_ladder_flops([[["espcn", 8]]], [2], 64, 4),
         jflops.multipass_ladder_flops([[["espcn", 8]]], [2], 64, 4)),
        (flops.multipass_ladder_flops([[["espcn", 8], ["espcn", 1]]], [2], 64, 4),
         jflops.multipass_ladder_flops([[["espcn", 8], ["espcn", 1]]], [2], 64, 4)),
        (flops.multipass_ladder_flops([[["espcn", 1]], [["espcn", 1]]], [2, 2], 64, 4),
         jflops.multipass_ladder_flops([[["espcn", 1]], [["espcn", 1]]], [2, 2], 64, 4)),
        (flops.ladder_flops("edsr_m", [3, 2], 48, 6, models=["edsr_m", "espcn"]),
         jflops.ladder_flops("edsr_m", [3, 2], 48, 6, models=["edsr_m", "espcn"])),
    ]
    for got, want in cases:
        assert want > 0 and abs(got - want) <= RTOL * want, (got, want)
    f1 = cases[0][0]
    assert abs(cases[1][0] - 8 * f1) < 1e-3 and abs(cases[2][0] - 9 * f1) < 1e-3


def test_chip_peak_and_mfu():
    assert flops.chip_peak_flops("NVIDIA H100 80GB HBM3") == (989e12, "nvidia h100 80gb hbm3")
    assert flops.chip_peak_flops("NVIDIA H100 PCIe")[0] == 756e12
    assert flops.chip_peak_flops("NVIDIA A100-SXM4-80GB")[0] == 312e12
    assert flops.chip_peak_flops("Some Future Card") == (989e12, "some future card")
    if not torch.cuda.is_available():
        assert flops.chip_peak_flops() == (989e12, "cpu")
        assert flops.chip_peak_flops(torch.device("cpu"))[1] == "cpu"
    got = flops.mfu(989e12 * 0.5, 2.0, "NVIDIA H100 80GB HBM3")
    assert got == {"sr_tflops": 494.5, "mfu_pct": 25.0, "chip_kind": "nvidia h100 80gb hbm3"}
    assert set(got) == set(jflops.mfu(1e12, 1.0))


def _timed(timer):
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("a"):
        pass
    with timer.stage("b"):
        pass
    return timer.report()


def test_stage_timer_report_has_the_reference_structure():
    got, want = _timed(StageTimer()), _timed(JaxStageTimer())
    assert set(got) == set(want) == {"total_s", "stages"}
    assert [(s["name"], s["calls"], sorted(s)) for s in got["stages"]] == \
        [(s["name"], s["calls"], sorted(s)) for s in want["stages"]]
    assert got["total_s"] >= 0.01 and abs(sum(s["share"] for s in got["stages"]) - 1) < 2e-3
    assert json.loads(str(StageTimer())) == {"total_s": 0.0, "stages": []}


def test_device_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir):
        with trace_region("srs_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "srs_region" in names and any(n and n.startswith("aten::") for n in names)
    with trace_region("no trace running"):  # free outside a trace
        pass
