"""The share of the traced window in which no operation runs on the card
(the union of the device intervals the profiler recorded)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
