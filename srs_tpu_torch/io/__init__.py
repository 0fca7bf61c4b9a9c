"""Image loading and the streamed TIFF writer (port of ``srs_tpu.io``)."""
