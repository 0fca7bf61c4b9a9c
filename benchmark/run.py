#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port (``srs_tpu_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration, ``benchmark/configs/<config>.json`` (the
``PipelineConfig`` flags, the route it serves, the nets' kinds and
widths, each kind's reference in ``yardstick/nets/<kind>.py``, and the
limits of the check; a net entry with ``"weights": {"seed": <n>}`` is
served seeded weights, ``yardstick/weights.py``), and a traffic mix,
``benchmark/traffic/<mix>.json`` (the entry, the jobs per call, the
workers, the input recipe). Each per-layer metric is a reader of its own,
``benchmark/metrics/<metric>.py``.

A run: set-up (imports, the kernels' and the writer's builds, the store's
nets and the seeded ones, the inputs, a warm-up of the cell's shapes),
then the window, which starts whole calls of the program's entry
(``process()`` or ``process_batch()``) while ``--seconds`` have not
passed and ends when the last call has closed its TIFFs; then, with the
program's state freed, the plain reference of each checked image and the
comparison. The last line of standard output is the result; the last
lines of standard error are the numbers compared, each beside its limit
(over several checked images, the largest reading).

The checked jobs are the traffic file's ``check_jobs``: the window's
first job, whose file gives ``tiff_bytes_per_px``, and further jobs drawn
from ``--seed`` (``inputs.checked_jobs``). Their TIFFs are real files;
every other job writes through the same writer to /dev/null. The window
runs at least until the checked jobs have started.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import Dict, List  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "srs_tpu_torch"
# Top-level module names that may not be loaded in the process that
# prints the result (compared whole: the port's name begins with the JAX
# package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "srs_tpu")
INPUT_CACHE = os.path.join(HERE, ".cache", "inputs")

for _p in (ROOT, HERE):  # the program from this checkout, the yardstick beside it
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from yardstick import check, flops, inputs, peaks, reference, weights  # noqa: E402
from yardstick import pyramid as pyr  # noqa: E402
from yardstick import trace as tr  # noqa: E402
from yardstick.tiff import read_tiff  # noqa: E402


class NoCard(RuntimeError):
    """The run has fewer CUDA cards than its cell asks for."""


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was first read where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 3600:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_START


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT):
    """(cell, configuration, traffic, per-layer metric entries) of
    ``workload``, each file found by the name ``BENCHMARK.json`` gives."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return cell, config, traffic, end_to_end, per_layer


def load_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise NoCard(f"this cell needs {n} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def observed_pipeline_class():
    """The program's pipeline with a per-job record: each job's
    ``last_run_info`` (which the batch's workers share) is kept under its
    output path as the job's own thread assigns it."""
    from srs_tpu_torch.pipeline import SuperResolutionPipeline

    class Observed(SuperResolutionPipeline):
        def __init__(self, *args, **kwargs):
            object.__setattr__(self, "bench_jobs", {})
            object.__setattr__(self, "_bench_local", threading.local())
            super().__init__(*args, **kwargs)

        def __setattr__(self, name, value):
            if name == "last_run_info":
                job = getattr(self._bench_local, "job", None)
                if job is not None:
                    self.bench_jobs[job] = value
            super().__setattr__(name, value)

        def process(self, input_path, output_path, *args, **kwargs):
            self._bench_local.job = output_path
            try:
                return super().process(input_path, output_path, *args, **kwargs)
            finally:
                self._bench_local.job = None

    return Observed


class Outputs:
    """Output paths under a directory of its own in ``TMPDIR``: a checked
    job's TIFF is a real file; every other job's TIFF path is a symbolic
    link to /dev/null, so the same writer runs and nothing of it reaches
    the disk."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="srs-bench-")
        self.n = 0

    def save_weights(self, seeded) -> str:
        """The seeded nets (``weights.seeded``) as ``{name}_x{scale}.pt``
        in a directory of their own, which the program reads as its
        ``checkpoint_dir``."""
        import torch

        path = os.path.join(self.dir, "weights")
        os.makedirs(path)
        for (name, scale), sd in seeded.items():
            torch.save(sd, os.path.join(path, f"{name}_x{scale}.pt"))
        return path

    def next(self, real: bool = False) -> str:
        path = os.path.join(self.dir, f"job{self.n:05d}.tiff")
        self.n += 1
        if not real:
            os.symlink(os.devnull, path)
        return path

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class Jobs:
    """The run's job inputs in order (``inputs.job_order``), each of the
    pool's images in each orientation made once."""

    def __init__(self, traffic: dict, pool: Dict[int, np.ndarray], seed: int):
        self.pool, self.seeds, self.seed = pool, traffic["input"]["pool"], seed
        self._made: Dict[tuple, np.ndarray] = {}

    def take(self, start: int, n: int) -> List[np.ndarray]:
        out = []
        for key in inputs.job_order(self.seeds, self.seed, start + n)[start:]:
            if key not in self._made:
                self._made[key] = inputs.orient(self.pool[key[0]], key[1])
            out.append(self._made[key])
        return out


def read_trace(prof) -> dict:
    """Device intervals, the program's ``stage:`` host ranges and the
    window's bounds from a profiler run, in its microseconds."""
    from torch.autograd import DeviceType

    kernels, ranges, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # host ranges mirrored on the device timeline are no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("stage:", "bench:"))):
                kernels.append((a, b, e.name))
        elif e.name == "bench:window":
            window = (a, b)
        elif e.name.startswith("stage:"):
            ranges.append((a, b, e.name))
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    lo, hi = window
    return {"kernels": kernels, "ranges": ranges, "lo": lo, "hi": hi,
            "window_s": (hi - lo) / 1e6,
            "busy_s": tr.busy([(a, b) for a, b, _ in kernels], lo, hi) / 1e6,
            "breakdown": tr.breakdown(kernels, ranges, lo, hi, 1e-6)}


def run_cell(cell: dict, config: dict, traffic: dict, end_to_end: list, per_layer: list,
             seed: int, seconds: float, traced: bool, device: str = "cuda",
             cache_dir: str = INPUT_CACHE,
             log=print, fault=None) -> dict:
    """Set-up, the window, the traced reading, the check; returns the
    result line's object. ``device="cpu"`` and ``fault`` serve the tests
    (a run on the CPU reports no device metric): ``fault(pipe)`` breaks
    the timed path after the warm-up."""
    split: Dict[str, float] = {"interpreter_and_harness": _process_age()}
    t = time.perf_counter()
    import torch

    if device == "cuda":
        require_cards(int(cell.get("chips", 1)))
    import srs_tpu_torch
    from srs_tpu_torch.io import native
    from srs_tpu_torch.models import registry
    from srs_tpu_torch.ops.cuda import pyramid as k12
    from srs_tpu_torch.pipeline import PipelineConfig

    if os.path.dirname(os.path.dirname(os.path.abspath(srs_tpu_torch.__file__))) != ROOT:
        raise ImportError(f"{PROGRAM} is not this checkout's ({srs_tpu_torch.__file__})")
    Observed = observed_pipeline_class()
    split["imports"] = time.perf_counter() - t

    t = time.perf_counter()
    if device == "cuda":
        k12.load_library()
    native.load_library()
    split["builds"] = time.perf_counter() - t

    t = time.perf_counter()
    pool = inputs.load_pool(traffic["input"], cache_dir)
    split["inputs"] = time.perf_counter() - t

    outs = Outputs()
    try:
        t = time.perf_counter()
        # Seeded nets reach the program as a user's own weights would.
        seeded = weights.seeded(config)
        served = {"checkpoint_dir": outs.save_weights(seeded)} if seeded else {}
        del seeded
        pipe = Observed(PipelineConfig(**{**config["pipeline"], "device": device, **served}))
        for scale, members in zip(config["route"]["ladder"], config["route"]["steps"]):
            for name, _passes in members:
                pipe.sr_module.weights.get((name, int(scale)))  # decoded or read once
        split["store"] = time.perf_counter() - t

        per_call = int(traffic["jobs_per_call"])
        workers = int(traffic.get("workers", 1))
        batched = traffic["entry"] == "process_batch"
        checked_jobs = inputs.checked_jobs(traffic["check_jobs"], seed)
        def call(images, start=None):
            """One call of the entry; [(output path, result)]. ``start``,
            the window's index of the call's first job (None in the
            warm-up), makes the checked jobs' TIFFs real files."""
            paths = [outs.next(real=start is not None and start + i in checked_jobs)
                     for i in range(len(images))]
            if not batched:
                return [(paths[0], pipe.process(images[0], paths[0]))]
            res = pipe.process_batch([{"input": im, "output": p} for im, p in zip(images, paths)],
                                     max_concurrent=workers)
            return list(zip(paths, res))

        # Warm-up: the cell's own shapes, one process() call, and for a
        # batched cell one two-job batch.
        t = time.perf_counter()
        jobs = Jobs(traffic, pool, seed)
        warm = jobs.take(0, 2)
        warmed = call(warm[:1]) + (call(warm) if batched else [])
        warmed = [r for _p, r in warmed]
        if device == "cuda":
            torch.cuda.synchronize()
        bad = [r.error_message for r in warmed if not r.success]
        if bad:
            raise RuntimeError(f"the warm-up failed: {bad[0]}")
        del warmed
        split["warmup"] = time.perf_counter() - t
        setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        if fault is not None:
            fault(pipe)
        results = []
        prof = shapes_cm = shapes = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            try:  # the batch's worker threads too, for their stage ranges
                from torch._C._profiler import _ExperimentalConfig

                prof = profile(activities=acts,
                               experimental_config=_ExperimentalConfig(profile_all_threads=True))
            except (ImportError, TypeError):
                prof = profile(activities=acts)
            shapes_cm = pyr.recorded_shapes(PROGRAM)
            shapes = shapes_cm.__enter__()
            prof.__enter__()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        setup_s = _process_age()
        w0 = time.perf_counter()
        k = 0
        with torch.profiler.record_function("bench:window"):
            while k <= checked_jobs[-1] or time.perf_counter() - w0 < seconds:
                results += call(jobs.take(k, per_call), start=k)
                k += per_call
            if device == "cuda":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if traced:
            prof.__exit__(None, None, None)
            shapes_cm.__exit__(None, None, None)

        failed = sum(not r.success for _p, r in results)
        images = jobs.take(0, checked_jobs[-1] + 1)
        ih, iw = images[0].shape[:2]
        tw, th = reference.target_size(iw, ih, config["pipeline"]["target_resolution"])
        out_mp = sum(r.success for _p, r in results) * th * tw / 1e6
        first_path = results[0][0]
        file_bytes = os.path.getsize(first_path) if os.path.isfile(first_path) else 0

        metrics = {}
        trace = read_trace(prof) if traced and device == "cuda" else None
        if not traced:
            values = {"mp_per_s": out_mp / window_s, "peak_gib": peak / 2**30,
                      "tiff_bytes_per_px": file_bytes / (th * tw), "setup_s": setup_s}
            for m in end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            run = {"config": config, "results": [r for _p, r in results], "window_s": window_s,
                   "image_flops": flops.image_flops(config), "peak_flops": peaks.BF16_FLOPS,
                   "bytes_per_s": peaks.HBM_BYTES_PER_S, "launches": shapes, "trace": trace}
            for m in per_layer:
                v = load_reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            del run

        if trace is not None:
            log(json.dumps({"trace": {"device_events": len(trace["kernels"]),
                                      "stage_ranges": len(trace["ranges"]),
                                      "launches": {k: len(v) for k, v in shapes.items()},
                                      "pyramid_kernel_events": {
                                          k: sum(p in n for _a, _b, n in trace["kernels"])
                                          for k, p in pyr.KERNELS.items()}}}))
        saves = {i: r.stage_times.get("save") for i, (_p, r) in enumerate(results) if r.success}
        checked_paths = [results[j][0] for j in checked_jobs]
        log(json.dumps({"setup_split_s": split, "setup_s": setup_s,
                        "window": {"calls": k // per_call, "jobs": len(results), "failed": failed,
                                   "seconds": window_s, "output_mp": out_mp},
                        "checked_jobs": checked_jobs,
                        "disk": {"checked_tiff_bytes": sum(
                                     os.path.getsize(p) for p in checked_paths
                                     if os.path.isfile(p)),
                                 "other_tiffs": "symlinks to /dev/null"},
                        "save_s": {"checked": [saves.get(j) for j in checked_jobs],
                                   "others": [v for i, v in saves.items()
                                              if i not in checked_jobs]}}))

        # The program's state is freed before the reference runs.
        program = [(pipe.bench_jobs.get(results[j][0]), results[j][1].quality_report)
                   for j in checked_jobs]
        attempted = len(results)
        del pipe, results, prof, jobs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        per_image = []
        for j, path, (info, report) in zip(checked_jobs, checked_paths, program):
            tiff = read_tiff(path) if os.path.isfile(path) else None
            ref = reference.run(images[j], config, registry.PACKAGED_CHECKPOINT_DIR, device)
            per_image.append(check.compare(config, info, tiff, report, ref, failed))
            del tiff, ref
            log(json.dumps({"checked_job": j, "check": check.as_dict(per_image[-1])}))
        rows = check.worst(per_image)
        result = {"correct": check.verdict(rows), "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_record(device, peak, setup_peak)}
        if trace is not None:
            result["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
            result["breakdown"] = trace["breakdown"]
        result["check"] = check.as_dict(rows)
        return result
    finally:
        outs.close()


def device_record(device: str, peak: int, setup_peak: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(max(peak, setup_peak))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")  # keep libraries that could load JAX from it
    os.environ.setdefault("USE_JAX", "0")
    cell, config, traffic, end_to_end, per_layer = load_cell(args.workload)
    try:
        result = run_cell(cell, config, traffic, end_to_end, per_layer, args.seed,
                          args.seconds, bool(args.trace),
                          log=lambda s: print(s, flush=True))
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"no result: the program does not import here ({e})", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, row in result["check"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
