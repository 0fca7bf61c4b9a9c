"""Array ops on NHWC tensors (port of ``srs_tpu.ops``)."""
