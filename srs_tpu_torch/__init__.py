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

Submodules are imported explicitly (``from srs_tpu_torch.pipeline import
SuperResolutionPipeline``); importing the package itself loads nothing.
"""

__version__ = "0.1.0"
