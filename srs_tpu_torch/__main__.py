"""``python -m srs_tpu_torch process in.png out.tiff [...]`` (``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
