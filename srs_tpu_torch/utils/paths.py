"""Where the JAX package lies in a checkout.

The port reads nothing of it at run time: its ledgers, trained weights and
QA data are its own copies (``models/checkpoints/``, ``qa/data/``).
``REFERENCE_DIR`` lets the writers refuse a directory inside it.
"""

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_DIR = os.path.join(CHECKOUT_DIR, "srs_tpu")
