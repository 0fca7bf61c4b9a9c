"""Quality assessment (port of ``srs_tpu/qa``)."""
