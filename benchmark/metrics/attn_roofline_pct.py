"""HAT's window-attention kernel (``ops/cuda/window_attn.py``) against its
roofline over the traced window: for each launch class (HAB, OCAB) the
larger of its bytes (q, k, v and the output once each, in bfloat16) over
the card's memory rate and its FLOP (the two products) over the bfloat16
peak, from ``yardstick/nets/hat.py``'s ``image_attention`` for each image
the window completed, summed, over the device seconds of the kernels
whose name holds ``window_attn``. A trace without them reads None."""

from yardstick import nets

KERNEL = "window_attn"


def read(run):
    t = run["trace"]
    done = sum(r.success for r in run["results"])
    if not t or not done:
        return None
    lo, hi = t["lo"], t["hi"]
    ran = sum(min(b, hi) - max(a, lo) for a, b, name in t["kernels"]
              if KERNEL in name and b > lo and a < hi) / 1e6
    if ran <= 0:
        return None
    work = nets.load("hat").image_attention(run["config"])
    bound = sum(max(nbytes / run["bytes_per_s"], flop / run["peak_flops"])
                for flop, nbytes in work.values())
    return 100.0 * done * bound / ran if bound > 0 else None
