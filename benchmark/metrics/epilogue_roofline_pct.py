"""The conv epilogue kernel (``ops/cuda/epilogue.py``) against its
roofline over the traced window: the least seconds its launches could
take (the configuration's convolution outputs, touched twice by the bias
and ReLU forms and three times by the scaled residual, over every pass
of every member at each step's tile batch, ``flops.image_epilogue``, for
each image the window completed, over the card's memory rate) over the
device seconds of the kernels named ``conv_epilogue_kernel``."""

from yardstick import flops

KERNEL = "conv_epilogue_kernel"


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
    _launches, nbytes = flops.image_epilogue(run["config"])
    return 100.0 * done * nbytes / run["bytes_per_s"] / ran
