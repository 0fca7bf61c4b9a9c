"""A plain reader of classic little-endian striped TIFFs (uncompressed or
deflate, 8 or 16 bits), with numpy and zlib only."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def read_tiff(path: str) -> np.ndarray:
    """(H, W, C) uint8 or uint16 array of the TIFF at ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd,) = struct.unpack_from("<I", data, 4)
    (count,) = struct.unpack_from("<H", data, ifd)
    width = {3: 2, 4: 4}
    tags = {}
    for e in range(count):
        tag, typ, n, val = struct.unpack_from("<HHII", data, ifd + 2 + 12 * e)
        size = width[typ]
        if n * size <= 4:
            raw = struct.pack("<I", val)[: n * size]
        else:
            raw = data[val: val + n * size]
        tags[tag] = list(struct.unpack_from("<" + ("H" if size == 2 else "I") * n, raw))
    w, h = tags[256][0], tags[257][0]
    bits, comp = tags[258][0], tags[259][0]
    channels = tags.get(277, [1])[0]
    if tags.get(284, [1])[0] != 1 or comp not in (1, 8) or bits not in (8, 16):
        raise ValueError(f"{path}: unsupported layout (planar {tags.get(284)}, "
                         f"compression {comp}, {bits} bits)")
    chunks = []
    for off, n in zip(tags[273], tags[279]):
        raw = data[off: off + n]
        chunks.append(zlib.decompress(raw) if comp == 8 else raw)
    dtype = np.dtype("<u2") if bits == 16 else np.uint8
    arr = np.frombuffer(b"".join(chunks), dtype)
    if arr.size != h * w * channels:
        raise ValueError(f"{path}: {arr.size} samples where {h}x{w}x{channels} are due")
    return arr.reshape(h, w, channels)
