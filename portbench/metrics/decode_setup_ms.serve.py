"""Host ms a traced request in decode_tokens before the decode runs: the
text encoder, style draw and voice embedding (``synth.condition``), the
memory projection (``decode.memory``), the planner's fit and the decode's
plan or carry (``decode.plan``), and the eager warm-up with the CUDA
graph's capture (``decode.capture``)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402

NAMES = ("synth.condition", "decode.memory", "decode.plan", "decode.capture")


def read(run):
    return _program.per_root(run, "synth.request", NAMES)
