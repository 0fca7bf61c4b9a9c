"""The SR stage's share of the card's dense bfloat16 peak: the
configuration's net FLOP per image (the benchmark's own count, from the
widths the configuration states) over the mean SR stage seconds."""

from yardstick.spans import stage_mean


def read(run):
    sr_s = stage_mean(run, "super_resolution")
    return None if not sr_s else 100.0 * run["image_flops"] / sr_s / run["peak_flops"]
