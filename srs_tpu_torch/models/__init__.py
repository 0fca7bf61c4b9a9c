"""SR nets, their registry and the SR engine (port of ``srs_tpu.models``)."""
