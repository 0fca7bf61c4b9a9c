"""Tile geometry and the tile-batch split (port of ``srs_tpu.tiling``)."""
