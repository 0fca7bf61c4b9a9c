"""Seconds of the ``super_resolution`` stage per image
(``PipelineResult.stage_times["super_resolution"]``), averaged over the window's
images."""

from yardstick.spans import stage_mean


def read(run):
    return stage_mean(run, "super_resolution")
