"""The share of the decode step's products that read their weight and bias
in place, in the traced requests: 100 × (1 − ``decode.dense_casts`` /
``decode.dense_products``), the program's counters (counted in
``models/decoder.py`` ``run_step_decode``: the executions of ``Dense``
products in the decode's eager warm-up and its graph replays, and of
those the ones that cast a weight or bias to the compute dtype first).
No ``decode.dense_casts`` beside ``decode.dense_products`` reads as no
cast.  None where the program counts no products."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    counts = _program.counters(run)
    if not counts or not counts.get("decode.dense_products"):
        return None
    return 100.0 * (1.0 - counts.get("decode.dense_casts", 0) / counts["decode.dense_products"])
