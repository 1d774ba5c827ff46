"""The benchmark's tests run from the checkout's root:

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m cuda    # on a card

They import the harness, the reference and the chain generator from
``benchmark/`` and the port from the checkout, as ``benchmark/run.py``
does."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH_DIR, os.path.dirname(BENCH_DIR)) if p not in sys.path]
