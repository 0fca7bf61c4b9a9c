"""The whole call's share of the card's dense bfloat16 peak: the SR
nets' FLOP of every image the traced window completed, over the
window's seconds."""


def read(run):
    done = sum(r.success for r in run["results"])
    if not done:
        return None
    return 100.0 * done * run["image_flops"] / run["window_s"] / run["peak_flops"]
