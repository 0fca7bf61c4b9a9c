"""Seconds of the ``save`` stage per image
(``PipelineResult.stage_times["save"]``), averaged over the window's
images."""

from yardstick.spans import stage_mean


def read(run):
    return stage_mean(run, "save")
