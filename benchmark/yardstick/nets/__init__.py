"""The nets of the plain reference, one module per kind: a configuration's
``nets`` entry names its ``kind``, and ``load(kind)`` finds
``nets/<kind>.py`` by its file name. A new kind is one new file here.

Each module defines:

- ``forward(sd, spec, scale, x, ops)``: the whole plain float32 pass, from
  an NHWC [0, 255] batch ``x`` to its ``scale`` times larger output in NHWC
  [0, 255], any global skip (the bicubic residual) included. ``sd`` holds
  the weights under the program's parameter names, ``spec`` is the
  configuration's ``nets`` entry. Every convolution, linear layer and
  batched product goes through ``ops.conv(x, w, b, padding)``,
  ``ops.linear(x, w, b)`` and ``ops.matmul(a, b)``, so the precision of a
  variant (TF32, float32, the float8 control) reaches all tensor-core work.
- ``flops_per_pixel(spec, scale)``: the tensor-core FLOP of one pass per
  input pixel (a multiply-add is 2 FLOP), the same work whatever
  implements it.
- ``init(spec, scale, generator)``: a float32 state dict under the
  program's parameter names, drawn only from ``generator`` (a
  ``torch.Generator``), by a rule the module states.
- ``convs(spec, scale)``: each convolution as ``(cout, cin, kh, kw, form,
  area)`` in the order the program's ``nets.Conv2d`` calls launch them:
  ``form`` is the epilogue that follows it ("bias", "relu" or
  "residual"), ``area`` its output pixels per input pixel of the pass (0
  for a convolution on a pooled 1x1 map, whose few bytes are left out).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str):
    """The module of net kind ``kind``: ``nets/<kind>.py``, read once."""
    name = f"{__name__}.{kind}"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(HERE, f"{kind}.py")
    if not str(kind).isidentifier() or not os.path.isfile(path):
        raise ValueError(f"unknown net kind {kind!r}: no module nets/{kind}.py ({path})")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def factors(scale: int) -> List[int]:
    """{2, 3} pixel-shuffle stages of ``scale``, 2s first (4 -> 2, 2)."""
    out, s = [], int(scale)
    while s % 2 == 0 and s > 1:
        out.append(2)
        s //= 2
    while s % 3 == 0 and s > 1:
        out.append(3)
        s //= 3
    if s != 1:
        raise ValueError(f"scale {scale} is not made of 2s and 3s")
    return out
