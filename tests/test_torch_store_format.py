"""The store's byte-plane format (``srs_tpu_torch/models/store.py``).

A state dict written with ``save_state`` reads back with ``load_state``
bit for bit: float32 tensors holding -0.0, NaNs with payloads, +-inf and
subnormals, an empty tensor, and tensors of other dtypes (stored raw).
Float32 tensors are stored as three raw low byte planes and a deflated top
plane. A corrupt top plane, a truncated low plane, a header whose shape
disagrees with the planes, and a file that is not of the format each raise
``StoreError`` naming the file. The store's own files need no pickle: the
reader never calls ``torch.load``.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from srs_tpu_torch.models import registry, store
from srs_tpu_torch.models.store import StoreError, load_state, raw_sha256, save_state


def _special_float32():
    bits = np.array([
        0x00000000, 0x80000000,  # +0.0, -0.0
        0x7F800000, 0xFF800000,  # +inf, -inf
        0x7FC00000, 0x7FC01234, 0xFFA5A5A5, 0x7F800001,  # quiet and signalling NaNs, payloads
        0x00000001, 0x807FFFFF, 0x00400000,  # subnormals
        0x7F7FFFFF, 0x00800000, 0x3F800000,  # largest, least normal, 1.0
    ], np.uint32)
    rng = np.random.default_rng(3)
    tail = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(np.concatenate([bits, tail]).view(np.float32).reshape(8, 8))


def _state():
    gen = torch.Generator().manual_seed(0)
    return {
        "special": _special_float32(),
        "conv.weight": torch.randn(4, 3, 3, 3, generator=gen) * 0.05,
        "empty": torch.zeros(0, 5),
        "scalar": torch.tensor(2.5),
        "half": torch.randn(7, generator=gen).half(),
        "index": torch.arange(-3, 6, dtype=torch.int64),
        "count": torch.arange(5, dtype=torch.int32),
        "mask": torch.tensor([True, False, True]),
        "bytes": torch.arange(250, 256, dtype=torch.uint8),
    }


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype in (torch.float32, torch.int32):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.float16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def test_a_dtype_outside_the_format_is_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_state({"w": torch.zeros(2, dtype=torch.bfloat16)}, str(tmp_path / "b.srsw"))


def test_round_trip_is_bit_exact(tmp_path):
    sd = _state()
    path = str(tmp_path / "net_x2.srsw")
    digest = save_state(sd, path)
    got = load_state(path)
    assert list(got) == list(sd)
    for k, v in sd.items():
        assert _bits_equal(got[k], v), k
    assert digest == raw_sha256(got) == raw_sha256(sd)
    assert not os.path.exists(path + ".tmp")


def _header(path):
    with open(path, "rb") as f:
        blob = f.read()
    _magic, _version, hlen = struct.unpack_from("<4sIQ", blob)
    start = struct.calcsize("<4sIQ")
    return blob, start, json.loads(blob[start:start + hlen])["tensors"], start + hlen


def test_float32_is_three_raw_planes_and_a_deflated_top(tmp_path):
    sd = {"w": _special_float32()}
    path = str(tmp_path / "w.srsw")
    save_state(sd, path)
    blob, _, tensors, data_start = _header(path)
    (entry,) = tensors
    assert entry["key"] == "w" and entry["dtype"] == "float32" and entry["shape"] == [8, 8]
    words = sd["w"].numpy().reshape(-1).view(np.uint8).reshape(-1, 4)
    data = blob[data_start:]
    for j, (offset, length, deflated) in enumerate(entry["planes"]):
        plane = data[offset:offset + length]
        assert deflated == (j == 3)
        if deflated:
            plane = zlib.decompress(plane)
        assert plane == words[:, j].tobytes()
    assert [p[1] for p in entry["planes"][:3]] == [64, 64, 64]


def _corrupt(tmp_path, how):
    path = str(tmp_path / f"{how}.srsw")
    save_state({"a": torch.randn(64, 9), "b": torch.randn(40)}, path)
    blob, start, tensors, data_start = _header(path)
    blob = bytearray(blob)
    if how == "top_plane":
        offset, length, _ = tensors[0]["planes"][3]
        for i in range(data_start + offset, data_start + offset + length):
            blob[i] ^= 0x5A
    elif how == "low_plane_truncated":
        offset, length, _ = tensors[-1]["planes"][1]
        blob = blob[:data_start + offset + length // 2]
    elif how == "wrong_shape":
        tensors[1]["shape"] = [41]
        header = json.dumps({"tensors": tensors}, separators=(",", ":")).encode()
        blob = struct.pack("<4sIQ", b"SRSW", 1, len(header)) + header + blob[data_start:]
    elif how == "not_the_format":
        blob = bytearray(b"PK\x03\x04") + blob[4:]
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return path


@pytest.mark.parametrize("how", ["top_plane", "low_plane_truncated", "wrong_shape",
                                 "not_the_format"])
def test_a_damaged_file_raises_naming_it(tmp_path, how):
    path = _corrupt(tmp_path, how)
    with pytest.raises(StoreError, match=os.path.basename(path)):
        load_state(path)


def test_other_dtypes_are_one_raw_plane(tmp_path):
    sd = {"i": torch.arange(6, dtype=torch.int64), "h": torch.ones(3, dtype=torch.float16)}
    path = str(tmp_path / "o.srsw")
    save_state(sd, path)
    _, _, tensors, _ = _header(path)
    assert [len(t["planes"]) for t in tensors] == [1, 1]
    assert [t["planes"][0][1:] for t in tensors] == [[48, False], [6, False]]


def test_the_store_is_read_without_pickle(monkeypatch):
    """load_packaged decodes the store's files itself: torch.load is never
    called for them."""
    def no_pickle(*_a, **_k):
        raise AssertionError("torch.load called on a store file")

    monkeypatch.setattr(torch, "load", no_pickle)
    registry.clear_param_cache()
    try:
        sd = registry.load_packaged(registry.store_name("espcn", 2))
    finally:
        registry.clear_param_cache()
    assert sd and all(v.dtype == torch.float32 for v in sd.values())
    assert all(f.endswith((store.SUFFIX, ".json")) for f in registry.store_manifest())
