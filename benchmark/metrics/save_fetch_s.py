"""Seconds per image fetching the save bands (the banded finalize of each
band on the device and its copy to the host): the span ``save/fetch`` of
``PipelineResult.spans``, averaged over the window's images."""

from yardstick.program import job_mean, span_sum


def read(run):
    return job_mean(run, lambda spans: span_sum(spans, "save/fetch"))
