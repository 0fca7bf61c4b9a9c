"""Where the port finds the reference package's data in its checkout.

The port reads these files by path and never imports the package beside
them: ``srs_tpu/models/checkpoints/EVAL.json`` (the evidence ledger) and
``srs_tpu/qa/data/`` (the NIQE, BRISQUE and LPIPS calibration files).
"""

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_DIR = os.path.join(CHECKOUT_DIR, "srs_tpu")
