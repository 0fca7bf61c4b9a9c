"""Max-preset proof run: the 200MP target at 16 bits on the card (port of
``scripts/proof_200mp.py``).

It exercises the banded save at the largest preset (the reference's
presets, main.py:171-175; 200MP at 16 bits is a 1.0-1.2 GB TIFF) and
checks the output without loading it: the TIFF header is parsed
directly.

The reference's header check (``size >= w * h * 3 * bytes``) holds only
for an uncompressed file, and the streamed writer deflates on any host
with more than one core. Here the check reads Compression (259),
RowsPerStrip (278) and StripByteCounts (279) too: an uncompressed file
keeps the raw-size condition; a deflated one needs ceil(h / RowsPerStrip)
strips, each (offset + byte count) inside the file.

    python -m srs_tpu_torch.drivers.proof_200mp [--out /tmp/proof200]
        [--target 200MP] [--bit-depth 16] [--device cuda|cpu]
        [--source 1280x720] [--block-size 512]

``--source`` (the input's size) and ``--block-size`` are the port's, for
small runs; the defaults are the reference's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of


def tiff_header_tags(path: str) -> Dict[str, Any]:
    """The first IFD's width, height, bits per sample, strip count,
    compression, rows per strip, strip offsets and strip byte counts.

    Minimal classic-TIFF (magic 42) reader, little or big endian, enough
    tags to check the native writer's output (``native/tiffio.cpp``)."""
    with open(path, "rb") as f:
        head = f.read(8)
        bo = "<" if head[:2] == b"II" else ">"
        magic, off = struct.unpack(bo + "HI", head[2:8])
        if magic != 42:
            raise ValueError(f"not a classic TIFF (magic={magic})")
        f.seek(off)
        (n,) = struct.unpack(bo + "H", f.read(2))
        tags = {}
        for _ in range(n):
            tag, typ, cnt, val = struct.unpack(bo + "HHII", f.read(12))
            tags[tag] = (typ, cnt, val)

        def values(entry) -> List[int]:
            typ, cnt, val = entry
            if cnt == 1:
                return [val & 0xFFFF] if typ == 3 else [val]
            if typ == 3 and cnt == 2:  # two SHORTs packed inline
                return [val & 0xFFFF, val >> 16]
            f.seek(val)  # val is an offset
            fmt = {3: "H", 4: "I"}[typ]
            raw = f.read(cnt * struct.calcsize(fmt))
            return list(struct.unpack(bo + fmt * cnt, raw))

        width, height = tags[256][2], tags[257][2]
        bits = values(tags[258])[0] if 258 in tags else 8
        offsets = values(tags[273]) if 273 in tags else []
        counts = values(tags[279]) if 279 in tags else []
        compression = values(tags[259])[0] if 259 in tags else 1
        rows = tags[278][2] if 278 in tags else height
    return {"width": width, "height": height, "bits": bits, "strips": len(offsets),
            "compression": compression, "rows_per_strip": rows,
            "strip_offsets": offsets, "strip_byte_counts": counts}


def tiff_header_info(path: str):
    """(width, height, bits_per_sample, strip_count) from the first IFD, as
    the reference's ``tiff_header_info`` returns them."""
    t = tiff_header_tags(path)
    return t["width"], t["height"], t["bits"], t["strips"]


def header_ok(tags: Dict[str, Any], file_bytes: int, bit_depth: int) -> bool:
    """Whether the header describes a whole file: uncompressed, at least
    the raw pixel bytes; deflated, ceil(h / RowsPerStrip) strips, each
    (offset + byte count) inside the file."""
    w, h = tags["width"], tags["height"]
    if w <= 0 or h <= 0:
        return False
    if tags["compression"] == 1:
        return file_bytes >= w * h * 3 * (bit_depth // 8)
    if tags["compression"] != 8:
        return False
    offsets, counts = tags["strip_offsets"], tags["strip_byte_counts"]
    rows = max(int(tags["rows_per_strip"]), 1)
    return (len(offsets) == len(counts) == math.ceil(h / rows)
            and all(o + c <= file_bytes for o, c in zip(offsets, counts)))


def proof_input(width: int = 1280, height: int = 720) -> np.ndarray:
    """The reference's natural-statistics input: ``render_photo(42, 768)``
    area-resized to ``width`` x ``height`` (bench parity), as uint8."""
    from ..models.corpus import _cv2, render_photo

    cv2 = _cv2()
    scene = render_photo(42, 768)
    return cv2.resize(scene, (width, height), interpolation=cv2.INTER_AREA).astype(np.uint8)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.proof_200mp")
    ap.add_argument("--out", default="/tmp/proof200")
    ap.add_argument("--target", default="200MP")
    ap.add_argument("--bit-depth", type=int, default=16)
    ap.add_argument("--source", default="1280x720", help="input WxH")
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--checkpoint-dir", default=None)
    add_device_args(ap, cpu_flag=False)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from ..io.image import save_image
    from ..pipeline import PipelineConfig, SuperResolutionPipeline

    device = device_of(args)
    sw, sh = (int(v) for v in args.source.lower().split("x"))
    in_path = os.path.join(args.out, "in.png")
    save_image(in_path, proof_input(sw, sh))

    out_path = os.path.join(args.out, f"out_{args.target}_{args.bit_depth}b.tiff")
    cfg = PipelineConfig(target_resolution=args.target, bit_depth=args.bit_depth,
                         enable_qa=True, block_size=args.block_size, device=device,
                         checkpoint_dir=args.checkpoint_dir)
    pipe = SuperResolutionPipeline(cfg)
    on_card = pipe.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(pipe.device)
    t0 = time.time()
    res = pipe.process(in_path, out_path)
    elapsed = time.time() - t0
    if not res.success:
        raise RuntimeError(res.error_message)

    size = os.path.getsize(out_path)
    tags = tiff_header_tags(out_path)
    w, h = tags["width"], tags["height"]
    info = pipe.last_run_info
    report = {
        "target": args.target,
        "bit_depth": args.bit_depth,
        "output": out_path,
        "file_bytes": size,
        "file_gb": round(size / 1e9, 3),
        "width": w,
        "height": h,
        "mp": round(w * h / 1e6, 1),
        "bits_tag": tags["bits"],
        "strip_count": tags["strips"],
        "compression": tags["compression"],
        "rows_per_strip": tags["rows_per_strip"],
        "pixel_bytes_expected": w * h * 3 * (args.bit_depth // 8),
        "header_ok": header_ok(tags, size, args.bit_depth),
        "elapsed_s": round(elapsed, 1),
        "stage_times": {k: round(v, 2) for k, v in res.stage_times.items()},
        "quality_score": res.quality_score,
        "elapsed_s_exact": elapsed,
        "mp_per_s": w * h / 1e6 / elapsed,
        "ladder": info.get("ladder"),
        "sr_attempts": info.get("sr_attempts"),
        "sr_degradations": info.get("sr_degradations"),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(pipe.device) / 1e9 if on_card
                        else None),
        "save_breakdown": info.get("save_breakdown"),
    }
    print(json.dumps(report))
    if not report["header_ok"]:
        raise RuntimeError(f"the TIFF header does not describe a whole file: {tags}")
    print("PROOF OK", flush=True)
    return report


if __name__ == "__main__":
    main()
