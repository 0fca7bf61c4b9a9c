"""Seconds of the ``quality_assessment`` stage per image
(``PipelineResult.stage_times["quality_assessment"]``), averaged over the window's
images."""

from yardstick.spans import stage_mean


def read(run):
    return stage_mean(run, "quality_assessment")
