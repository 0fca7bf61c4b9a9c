"""Seconds of the ``tiling`` stage per image
(``PipelineResult.stage_times["tiling"]``), averaged over the window's
images."""

from yardstick.spans import stage_mean


def read(run):
    return stage_mean(run, "tiling")
