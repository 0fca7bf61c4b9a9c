"""The TIFF writers and the content hash, bound with ctypes (port of
``srs_tpu/io/native.py``).

The library is compiled from ``csrc/tiffio.cpp`` (the JAX package's
``native/tiffio.cpp`` with the writer's counters added) with ``g++ ...
-lz`` into the port's build directory (``utils/build.py``). Strips
deflate on a C++ thread pool while later bands are still being computed. :func:`write_tiff` writes a
whole image in one call through the same streamed writer. Closing a
writer adds its counters (``TIFF_COUNTERS``: deflate CPU seconds, seconds
blocked in the pool's barrier, in the final join and in the file write,
strips, raw and stored bytes, pool size) to the current job's record
as ``tiff.<name>`` (``utils/profiling.count``).
:func:`load` is :func:`load_library`, and :func:`available` only asks
whether the library builds and loads: no code of the port chooses a path
by it.

:func:`read_tiff` reads back what the writer wrote (classic TIFF, striped,
uncompressed or deflate, 8/16-bit), with numpy and zlib only.
:func:`content_hash` is the library's FNV-1a 64-bit hash (``srs_hash64``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import threading
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from ..utils import profiling
from ..utils.build import PACKAGE_DIR, build_shared

__all__ = ["TiffStreamWriter", "read_tiff", "write_tiff", "content_hash", "load_library",
           "load", "available"]

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "tiffio.cpp")
# srs_tiff_end_stats' counters, in its order.
TIFF_COUNTERS = ("deflate_s", "barrier_s", "join_s", "file_s", "strips", "raw_bytes",
                 "out_bytes", "threads")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (once) and load the TIFF writer."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            path = build_shared(
                "srs_tiff", [SOURCE],
                lambda out: [cxx, "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared",
                             "-o", out, SOURCE, "-lz"],
            )
            lib = ctypes.CDLL(path)
            i64 = ctypes.c_int64
            lib.srs_tiff_begin.restype = ctypes.c_void_p
            lib.srs_tiff_begin.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, i64, i64]
            lib.srs_tiff_write_rows.restype = i64
            lib.srs_tiff_write_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64]
            lib.srs_tiff_end.restype = i64
            lib.srs_tiff_end.argtypes = [ctypes.c_void_p]
            lib.srs_tiff_end_stats.restype = i64
            lib.srs_tiff_end_stats.argtypes = [ctypes.c_void_p,
                                               ctypes.POINTER(ctypes.c_double), i64]
            lib.srs_hash64.restype = ctypes.c_uint64
            lib.srs_hash64.argtypes = [ctypes.c_void_p, i64]
            _lib = lib
    return _lib


load = load_library  # the reference's name (io/native.py:67)


def available() -> bool:
    """Whether the TIFF library builds and loads here (reference
    io/native.py:97). A query only: the port's writers call
    :func:`load_library`, which raises when it cannot."""
    try:
        load_library()
        return True
    except (OSError, RuntimeError):
        return False


def write_tiff(path: str, image: np.ndarray, bit_depth: int = 8, compress: bool = True) -> int:
    """Write an (H, W, C) image as a striped TIFF (reference
    io/native.py:105-134, whose pixels it writes): float input in [0, 255]
    is clipped and truncated to uint8, or for 16 bits scaled by 65535/255
    and rounded; uint8 / uint16 input is written as it is. The strips
    deflate on the writer's thread pool (:class:`TiffStreamWriter`).
    Returns the rows written, as the reference does."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[..., None]
    if bit_depth == 16:
        if arr.dtype != np.uint16:
            arr = (np.clip(arr.astype(np.float64), 0, 255) / 255.0 * 65535.0 + 0.5).astype(
                np.uint16)
    elif arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    with TiffStreamWriter(path, h, w, channels=c, bit_depth=bit_depth,
                          compress=compress) as writer:
        writer.write(arr)
    return h


def content_hash(data: Union[np.ndarray, bytes]) -> str:
    """FNV-1a 64-bit hash of ``data`` (an array's bytes in C order) as 16
    hex digits (reference io/native.py:137-142)."""
    lib = load_library()
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return f"{lib.srs_hash64(data, len(data)):016x}"


class TiffStreamWriter:
    """Incremental TIFF writer: feed (rows, W, C) bands in order."""

    def __init__(self, path: str, h: int, w: int, channels: int = 3,
                 bit_depth: int = 8, compress: bool = True, level: int = 1):
        lib = load_library()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lib = lib
        self._bit_depth = bit_depth
        self._ctx = lib.srs_tiff_begin(
            path.encode(), h, w, channels, bit_depth, 1 if compress else 0, level
        )
        if not self._ctx:
            raise IOError("srs_tiff_begin failed")

    def write(self, rows: np.ndarray) -> None:
        arr = np.ascontiguousarray(rows)
        expect = np.uint16 if self._bit_depth == 16 else np.uint8
        if arr.dtype != expect:
            raise TypeError(f"rows must be {expect}, got {arr.dtype}")
        rc = self._lib.srs_tiff_write_rows(
            self._ctx, arr.ctypes.data_as(ctypes.c_void_p), arr.shape[0]
        )
        if rc < 0:
            raise IOError(f"srs_tiff_write_rows failed ({rc})")

    def close(self) -> int:
        if self._ctx is None:
            return 0
        stats = (ctypes.c_double * len(TIFF_COUNTERS))()
        rc = self._lib.srs_tiff_end_stats(self._ctx, stats, len(TIFF_COUNTERS))
        self._ctx = None
        for name, value in zip(TIFF_COUNTERS, stats):
            profiling.count(f"tiff.{name}", value)
        if rc < 0:
            raise IOError(f"srs_tiff_end failed ({rc})")
        return int(rc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tiff_size(path: str) -> Tuple[int, int]:
    """(width, height) of a little-endian classic TIFF, from its first IFD
    (the pixel data is not read)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:4] != b"II*\x00":
            raise ValueError(f"{path}: not a little-endian classic TIFF")
        f.seek(struct.unpack_from("<I", head, 4)[0])
        (count,) = struct.unpack("<H", f.read(2))
        entries = f.read(12 * count)
    dims = {}
    for e in range(count):
        tag, typ = struct.unpack_from("<HH", entries, 12 * e)
        if tag in (256, 257):
            dims[tag] = struct.unpack_from("<H" if typ == 3 else "<I", entries, 12 * e + 8)[0]
    return dims[256], dims[257]


def read_tiff(path: str) -> np.ndarray:
    """(H, W, C) uint8/uint16 array of a striped little-endian TIFF."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd,) = struct.unpack_from("<I", data, 4)
    (count,) = struct.unpack_from("<H", data, ifd)
    sizes = {3: 2, 4: 4}
    tags = {}
    for e in range(count):
        tag, typ, n, value = struct.unpack_from("<HHII", data, ifd + 2 + 12 * e)
        fmt = "<" + ("H" if typ == 3 else "I") * n
        if n * sizes[typ] <= 4:
            vals = struct.unpack_from(fmt, data, ifd + 2 + 12 * e + 8)
        else:
            vals = struct.unpack_from(fmt, data, value)
        tags[tag] = vals
    w, h = tags[256][0], tags[257][0]
    channels = tags.get(277, (1,))[0]
    bits = tags[258][0]
    compressed = tags.get(259, (1,))[0] == 8
    raw = b"".join(
        zlib.decompress(data[o : o + n]) if compressed else data[o : o + n]
        for o, n in zip(tags[273], tags[279])
    )
    dtype = np.uint16 if bits == 16 else np.uint8
    return np.frombuffer(raw, dtype=dtype).reshape(h, w, channels)
