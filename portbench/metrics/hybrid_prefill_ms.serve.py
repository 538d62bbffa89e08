"""Device ms a traced request in the program's ``decode.prefill`` span
(``models/hybrid.py`` ``hybrid_greedy_decode``: the prefix of every row
through the 28 layers).  None where the program has no such span."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    return _program.per_root(run, "synth.request", ("decode.prefill",), device=True)
