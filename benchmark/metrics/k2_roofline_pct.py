"""The pyramid kernel K2 (``pyr_up``) against its roofline over the traced window:
the least seconds its launches could take (each launch's one read of the
input and one write of the output, from its recorded shape, over the
card's memory rate) over the device seconds its kernels ran."""

from yardstick import pyramid


def read(run):
    t, launches = run["trace"], run["launches"]
    if not t or not launches or not launches["pyr_up"]:
        return None
    prefix = pyramid.KERNELS["pyr_up"]
    ran = sum(b - a for a, b, name in t["kernels"]
              if prefix in name and b > t["lo"] and a < t["hi"]) / 1e6
    if ran <= 0:
        return None
    return 100.0 * pyramid.bound_seconds("pyr_up", launches["pyr_up"], run["bytes_per_s"]) / ran
