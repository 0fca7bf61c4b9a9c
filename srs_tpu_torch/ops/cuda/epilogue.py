"""The SR convolutions' epilogue: one kernel for the bias, the ReLU and the
scaled residual after a convolution, and its plain version.

It replaces no TPU kernel: XLA fuses these ops into the TPU's convolution
(``srs_tpu/models/nets.py``). On the card PyTorch adds a cuDNN conv's bias
as its own ``add_`` (an unvectorised kernel on a channels_last output),
then runs the ReLU, the scale and the residual add as more passes. The
kernel (CUDA C++ for ``sm_90a`` in ``csrc/epilogue.cu``, built with
``nvcc`` at first use and bound with ``ctypes``, like the pyramid kernels)
does them in one in-place pass over the conv's output ``y``, in one of
five forms the arguments choose:

- ``bias``: ``y + b``;
- ``bias, relu=True`` (or ``act="relu"``): ``relu(y + b)``;
- ``bias, act="gelu"``: ``gelu(y + b)``, the exact (erf) GELU of HAT's
  channel-attention block;
- ``bias, act="lrelu"``: ``leaky_relu(y + b, 0.01)``, HAT's
  ``conv_before_upsample``;
- ``bias, residual=x, res_scale=s``: ``x + s * (y + b)``.

It rounds as PyTorch's ops do, step by step, so both routes give the same
bits. It is bound by memory: one read and one write of ``y``, and one read
of ``x`` in the residual form.

:func:`conv_epilogue` launches the kernel on a CUDA ``y`` in bfloat16,
float16 or float32 that is dense in the channels_last (NHWC) or the
contiguous (NCHW) layout and 16-byte aligned, as a conv's fresh output is,
with a residual in ``y``'s layout; it raises on anything else.
:func:`conv_epilogue_plain` runs the unfused ops. ``nets.Conv2d`` calls the
kernel on a card with autograd off, else the plain ops. One helper counts
each call: a launch in ``LAUNCHES["conv_epilogue"]`` and the job's
``conv_epilogue.fused``; a plain call in ``conv_epilogue.plain``, and also
in ``conv_epilogue.plain_autograd`` when autograd is on (training, zssr's
tuning).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...utils import profiling
from ...utils.build import NVCC_FLAGS, PACKAGE_DIR, build_shared, nvcc

__all__ = ["LAUNCHES", "reset_launches", "conv_epilogue", "conv_epilogue_plain",
           "load_library"]

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "epilogue.cu")
_FORMS = {"bias": 0, "relu": 1, "residual": 2, "gelu": 3, "lrelu": 4}
# The activations a conv may end in, and LeakyReLU's slope (PyTorch's default).
ACTS = ("relu", "gelu", "lrelu")
LRELU_SLOPE = 0.01
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# Kernel launches since the last reset; the plain version never counts.
LAUNCHES: Dict[str, int] = {"conv_epilogue": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["conv_epilogue"] = 0


def _record(fused: bool) -> None:
    """Count one epilogue: a launch, or a plain call (and whether it ran
    under autograd)."""
    if fused:
        with _count_lock:
            LAUNCHES["conv_epilogue"] += 1
        profiling.count("conv_epilogue.fused")
        return
    profiling.count("conv_epilogue.plain")
    if torch.is_grad_enabled():
        profiling.count("conv_epilogue.plain_autograd")


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            compiler = nvcc()
            path = build_shared(
                "srs_epilogue", [SOURCE],
                lambda out: [compiler, *NVCC_FLAGS, "-o", out, SOURCE],
            )
            lib = ctypes.CDLL(path)
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.srs_conv_epilogue.argtypes = [ptr, ptr, ptr, ctypes.c_float, i64, i64, i64,
                                              ctypes.c_int, ctypes.c_int, ptr]
            lib.srs_conv_epilogue.restype = ctypes.c_int
            _lib = lib
    return _lib


def _form(relu: bool, residual: Optional[torch.Tensor], act: Optional[str] = None) -> str:
    if act is not None and act not in ACTS:
        raise ValueError(f"unknown conv epilogue activation {act!r}; known: {ACTS}")
    if relu and act not in (None, "relu"):
        raise ValueError(f"the conv epilogue applies one activation, got relu and {act!r}")
    act = act or ("relu" if relu else None)
    if act and residual is not None:
        raise ValueError("the conv epilogue applies an activation or a residual, not both")
    return "residual" if residual is not None else act or "bias"


def conv_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        relu: bool = False, residual: Optional[torch.Tensor] = None,
                        res_scale: float = 1.0, act: Optional[str] = None) -> torch.Tensor:
    """The unfused ops on a conv's output ``y`` (NCHW, any layout, any
    type): ``bias`` added in place as PyTorch adds a cuDNN conv's bias
    (``None`` where the conv added it), then an in-place ReLU or LeakyReLU,
    ``F.gelu``, or ``residual + y * res_scale`` (``residual + y`` at a
    scale of 1)."""
    form = _form(relu, residual, act)
    if bias is not None:
        y = y.add_(bias.reshape(1, -1, 1, 1))
    if form == "relu":
        y = F.relu(y, inplace=True)
    elif form == "gelu":
        y = F.gelu(y)
    elif form == "lrelu":
        y = F.leaky_relu(y, LRELU_SLOPE, inplace=True)
    if residual is not None:
        y = residual + (y if res_scale == 1 else y * res_scale)
    _record(False)
    return y


def _inner(t: torch.Tensor) -> Optional[int]:
    """Values a channel's run holds in ``t``'s flat memory: 1 if ``t`` is a
    dense channels_last [N, C, H, W], H * W if a contiguous one; None if
    neither (where both hold, C or H * W is 1 and both give one channel to
    each value)."""
    if t.dim() != 4:
        return None
    if t.permute(0, 2, 3, 1).is_contiguous():
        return 1
    return t.shape[2] * t.shape[3] if t.is_contiguous() else None


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` put each value at the same flat offset."""
    return a.shape == b.shape and all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(),
                                                                     a.shape) if n > 1)


def _refusal(y: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor]) -> Optional[str]:
    """Why the kernel does not take these tensors, or None."""
    if not y.is_cuda:
        return f"a CUDA tensor, got one on {y.device}"
    if y.dtype not in _DTYPES:
        return f"bfloat16, float16 or float32, got {y.dtype}"
    if _inner(y) is None or y.data_ptr() % 16:
        return ("a dense channels_last or contiguous, 16-byte aligned [N, C, H, W], got "
                f"shape {tuple(y.shape)} strides {y.stride()}")
    if (bias.device != y.device or bias.dtype != y.dtype or bias.dim() != 1
            or bias.numel() != y.shape[1] or not bias.is_contiguous()):
        return f"a contiguous bias of {y.shape[1]} {y.dtype} on {y.device}"
    if residual is not None and (residual.dtype != y.dtype or residual.device != y.device
                                 or not _same_layout(residual, y) or residual.data_ptr() % 16):
        return (f"a residual laid out as the output {tuple(y.shape)} {y.stride()}, got "
                f"{tuple(residual.shape)} {residual.stride()}")
    return None


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                  residual: Optional[torch.Tensor] = None,
                  res_scale: float = 1.0, act: Optional[str] = None) -> torch.Tensor:
    """The kernel, in place on ``y`` (a conv's fresh output, held by
    nothing else), on the current stream; returns ``y``. Raises
    ``ValueError`` on tensors it does not take."""
    form = _form(relu, residual, act)
    reason = _refusal(y, bias, residual)
    if reason is not None:
        raise ValueError(f"conv_epilogue takes {reason}")
    lib = load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.srs_conv_epilogue(
            y.data_ptr(), bias.data_ptr(), residual.data_ptr() if residual is not None else None,
            float(res_scale), y.numel(), y.shape[1], _inner(y), _DTYPES[y.dtype], _FORMS[form],
            stream)
    if rc != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: cudaError {rc}")
    _record(True)
    return y
