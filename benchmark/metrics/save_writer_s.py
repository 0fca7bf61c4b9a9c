"""Host seconds per image inside the TIFF writer (``io/native.py``,
``native/tiffio.cpp``): the spans ``save/write`` (handing bands over,
blocking in the deflate pool's barrier) and ``save/close`` (the final
join, strip assembly and file write) of ``PipelineResult.spans``,
averaged over the window's images."""

from yardstick.program import job_mean, span_sum


def read(run):
    return job_mean(run, lambda spans: span_sum(spans, "save/write", "save/close"))
