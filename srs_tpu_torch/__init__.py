"""srs_tpu_torch — the PyTorch/CUDA port of srs_tpu for one NVIDIA H100.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never ``jax`` and nothing of ``srs_tpu``. Its layout mirrors
``srs_tpu`` (``tiling/``, ``ops/``, ``models/``, ``io/``, ``pipeline.py``,
``config.py``), so each module's counterpart is found by path.

The two Pallas kernels of the reference (``pyr_down_pallas`` and
``pyr_up_pallas``) are hand-written CUDA C++ in ``csrc/pyramid.cu``, built
with ``nvcc`` at first use and bound with ``ctypes``
(``ops/cuda/pyramid.py``). Entry points run on the card unless the caller
asks for the CPU (``device="cpu"``), where the kernels' plain PyTorch
versions serve.

The package exports the reference's names: ``SystemConfig`` and the
environment's ``config`` (``config.py`` imports only the standard
library; it is bound here so that ``srs_tpu_torch.config`` is the
configuration, as in the reference, and not the submodule), and
``SuperResolutionPipeline``, ``PipelineConfig`` and ``PipelineResult``,
loaded on first access (PEP 562): importing the package loads neither
torch nor the pipeline.
"""

import importlib

from .config import SystemConfig, config

__version__ = "0.1.0"

_PIPELINE_EXPORTS = ("SuperResolutionPipeline", "PipelineConfig", "PipelineResult")

__all__ = [*_PIPELINE_EXPORTS, "SystemConfig", "config", "__version__"]


def __getattr__(name: str):
    if name in _PIPELINE_EXPORTS:
        return getattr(importlib.import_module(".pipeline", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_PIPELINE_EXPORTS))
