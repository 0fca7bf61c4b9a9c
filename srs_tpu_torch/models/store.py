"""The store's file format: a state dict in byte planes, lossless.

A ``.srsw`` file is::

    b"SRSW" | u32 version | u64 header length | JSON header | data

all little-endian. The header is ``{"tensors": [...]}``, one entry per
tensor in the state dict's key order: ``key``, ``dtype`` (a torch dtype's
name), ``shape`` and ``planes``, a list of ``[offset, length, deflated]``
byte ranges of the data section. A tensor of a 4-byte dtype is cut into
its four byte planes (byte ``j`` of every element, lowest first): the
three low planes, whose bits of a trained float32 weight are close to
random, are stored raw; the top plane (the sign and seven exponent bits)
is deflated with zlib at level 9. A tensor of another dtype is one raw
plane. Trained float32 nets come to about 0.85 of their float32 bytes.

Reading uses numpy, zlib and ``torch.from_numpy`` only (no pickle). A
file that is cut short, a plane whose length disagrees with its shape, a
stream that does not inflate to its plane, or a header that does not
parse raises :class:`StoreError` naming the file. :func:`raw_sha256` is
the hash of the tensors' bytes in key order, which the store's manifest
keeps beside each file's own hash.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Dict, List, Mapping

import numpy as np
import torch

__all__ = ["SUFFIX", "StoreError", "save_state", "load_state", "raw_sha256"]

SUFFIX = ".srsw"
_MAGIC = b"SRSW"
_VERSION = 1
_PREFIX = struct.Struct("<4sIQ")
# torch dtype name -> numpy dtype of its little-endian bytes
_DTYPES = {
    "float32": np.dtype("<f4"), "int32": np.dtype("<i4"), "float64": np.dtype("<f8"),
    "int64": np.dtype("<i8"), "float16": np.dtype("<f2"), "int16": np.dtype("<i2"),
    "int8": np.dtype("i1"), "uint8": np.dtype("u1"), "bool": np.dtype("?"),
}


class StoreError(RuntimeError):
    """A store file that is missing, cut short, altered or not decodable;
    the message names the file."""


def _dtype_name(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"the store format holds no {t.dtype}")
    return name


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """The tensor's elements as little-endian bytes, [numel, itemsize]."""
    dtype = _DTYPES[_dtype_name(t)]
    a = t.detach().to("cpu").contiguous().numpy().astype(dtype, copy=False)
    return a.reshape(-1).view(np.uint8).reshape(-1, a.itemsize)


def raw_sha256(state: Mapping[str, torch.Tensor]) -> str:
    """sha256 of the tensors' little-endian bytes, one after another in key
    order."""
    h = hashlib.sha256()
    for t in state.values():
        h.update(_bytes_of(t).tobytes())
    return h.hexdigest()


def save_state(state: Mapping[str, torch.Tensor], path: str) -> str:
    """Write ``state`` to ``path`` (whole, under a temporary name renamed
    into place); returns its :func:`raw_sha256`."""
    entries: List[dict] = []
    chunks: List[bytes] = []
    offset = 0
    h = hashlib.sha256()
    for key, t in state.items():
        planes = _bytes_of(t)
        h.update(planes.tobytes())
        if planes.shape[1] == 4:
            parts = [(np.ascontiguousarray(planes[:, j]).tobytes(), False) for j in range(3)]
            parts.append((zlib.compress(np.ascontiguousarray(planes[:, 3]).tobytes(), 9), True))
        else:
            parts = [(planes.tobytes(), False)]
        ranges = []
        for data, deflated in parts:
            ranges.append([offset, len(data), deflated])
            chunks.append(data)
            offset += len(data)
        entries.append({"key": key, "dtype": _dtype_name(t), "shape": list(t.shape),
                        "planes": ranges})
    header = json.dumps({"tensors": entries}, separators=(",", ":")).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_PREFIX.pack(_MAGIC, _VERSION, len(header)))
        f.write(header)
        for data in chunks:
            f.write(data)
    os.replace(tmp, path)
    return h.hexdigest()


def _plane(path: str, key: str, data: memoryview, rng, n: int) -> np.ndarray:
    """One plane of ``n`` bytes from its ``[offset, length, deflated]``."""
    try:
        offset, length, deflated = int(rng[0]), int(rng[1]), bool(rng[2])
    except (TypeError, ValueError, IndexError) as e:
        raise StoreError(f"{path}: {key}: bad plane range {rng!r}") from e
    if offset < 0 or length < 0 or offset + length > len(data):
        raise StoreError(f"{path}: {key}: plane [{offset}, +{length}) runs past the file's "
                         f"{len(data)} data bytes")
    raw = data[offset:offset + length]
    if deflated:
        d = zlib.decompressobj()
        try:
            raw = d.decompress(raw, n + 1)
        except zlib.error as e:
            raise StoreError(f"{path}: {key}: the deflated plane is corrupt ({e})") from e
        if not d.eof or d.unused_data or d.unconsumed_tail:
            raise StoreError(f"{path}: {key}: the deflated plane does not end where its "
                             "range does")
    if len(raw) != n:
        raise StoreError(f"{path}: {key}: a plane of {len(raw)} bytes where its shape needs {n}")
    return np.frombuffer(raw, np.uint8)


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in ``path``, on the CPU, in the file's key order.
    Every fault raises :class:`StoreError` naming ``path``."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise StoreError(f"{path}: not readable ({e})") from e
    if len(blob) < _PREFIX.size:
        raise StoreError(f"{path}: {len(blob)} bytes, shorter than the format's prefix")
    magic, version, hlen = _PREFIX.unpack_from(blob)
    if magic != _MAGIC or version != _VERSION:
        raise StoreError(f"{path}: not a store file (magic {magic!r}, version {version})")
    start = _PREFIX.size + hlen
    if start > len(blob):
        raise StoreError(f"{path}: the header runs past the end of the file")
    try:
        entries = json.loads(blob[_PREFIX.size:start])["tensors"]
    except (ValueError, KeyError, TypeError) as e:
        raise StoreError(f"{path}: unreadable header ({e})") from e
    data = memoryview(blob)[start:]
    out: Dict[str, torch.Tensor] = {}
    for entry in entries:
        try:
            key, name = str(entry["key"]), entry["dtype"]
            shape = tuple(int(s) for s in entry["shape"])
            ranges = list(entry["planes"])
            np_dtype = _DTYPES[name]
        except (KeyError, TypeError, ValueError) as e:
            raise StoreError(f"{path}: bad header entry {entry!r}") from e
        if any(s < 0 for s in shape):
            raise StoreError(f"{path}: {key}: negative shape {shape}")
        n = int(np.prod(shape, dtype=np.int64))
        width = np_dtype.itemsize
        if len(ranges) != (4 if width == 4 else 1):
            raise StoreError(f"{path}: {key}: {len(ranges)} planes for a {name} tensor")
        if width == 4:
            planes = np.empty((n, 4), np.uint8)
            for j, rng in enumerate(ranges):
                planes[:, j] = _plane(path, key, data, rng, n)
        else:  # a copy: frombuffer's view of the file is read-only
            planes = _plane(path, key, data, ranges[0], n * width).copy()
        out[key] = torch.from_numpy(planes.reshape(-1).view(np_dtype).reshape(shape))
    return out
