"""Deflate CPU seconds per image in the TIFF writer's pool: the strips'
thread-CPU seconds summed (``count/tiff.deflate_s`` of
``PipelineResult.spans``, from ``srs_tiff_end_stats``), averaged over the
window's images. What the pool must do, whatever its threads overlap."""

from yardstick.program import job_mean


def read(run):
    return job_mean(run, lambda spans: spans.get("count/tiff.deflate_s"))
