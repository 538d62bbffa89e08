"""CUDA graphs captured a traced request (the program's counter
``decode.graph_captures``, counted in ``models/decoder.py``
``run_captured``)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    got, counts = _program.spans(run), _program.counters(run)
    if got is None or counts is None:
        return None
    n = len(_program.roots(got, "synth.request"))
    return counts.get("decode.graph_captures", 0) / n if n else None
