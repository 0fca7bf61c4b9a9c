"""Seconds of the ``blending`` stage per image
(``PipelineResult.stage_times["blending"]``), averaged over the window's
images."""

from yardstick.spans import stage_mean


def read(run):
    return stage_mean(run, "blending")
