"""Build the package's native sources into shared libraries at first use.

Each library is compiled from the sources in this checkout into
``srs_tpu_torch/_build/`` (listed in ``.gitignore``; override with
``SRS_TORCH_BUILD_DIR``). The file name carries a digest of the sources
and the command, so an edited source or flag builds anew and a stale
library is never loaded. A build writes to a temporary name and renames
it into place, so concurrent processes never load a half-written file.
Threads building different libraries run their compilers in parallel.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The CUDA kernels' flags: Hopper's sm_90a, a plain C interface for
# ctypes, and ptxas' registers and spills in the build's log.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def build_dir() -> str:
    path = os.environ.get("SRS_TORCH_BUILD_DIR") or os.path.join(PACKAGE_DIR, "_build")
    os.makedirs(path, exist_ok=True)
    return path


def nvcc() -> str:
    """Path of the CUDA toolkit's ``nvcc``: on ``PATH``, else under
    ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build_shared(
    name: str, sources: Sequence[str], command: Callable[[str], List[str]]
) -> str:
    """Path of ``lib<name>-<digest>.so`` built from ``sources``.

    ``command(out_path)`` returns the compiler's argument list. The
    compiler's output goes to ``<path>.log`` beside the library. Raises
    ``RuntimeError`` with that output when the build fails.
    """
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(command("OUT")).encode())
    out = os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")
    with _locks_guard:
        lock = _locks.setdefault(out, threading.Lock())
    with lock:
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(command(tmp))}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(f"{out}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out
