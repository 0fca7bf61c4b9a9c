"""Host seconds per image that ``TiffStreamWriter.write`` spends on its
own serial work (copying rows into strips, starting deflate threads):
the span ``save/write`` less the seconds it blocked in the deflate pool's
join-all barrier (``count/tiff.barrier_s``), from ``PipelineResult.spans``,
averaged over the window's images. The card idles under it."""

from yardstick.program import job_mean, span_sum


def _serial(spans):
    write, barrier = span_sum(spans, "save/write"), spans.get("count/tiff.barrier_s")
    if write is None or barrier is None:
        return None
    return write - barrier


def read(run):
    return job_mean(run, _serial)
