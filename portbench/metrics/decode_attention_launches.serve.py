"""Launches of the one-query attention kernel a decode step in the traced
requests: the program's counter ``decode.attention_launches`` (counted in
``models/decoder.py`` ``greedy_decode``: the kernel's executions in the
captured decode, its eager warm-up and its graph replays, one a layer a
step) over the steps of the ``decode.capture`` (the warm-up's) and
``decode.run`` spans.  None where the program counts no such launches."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    got, counts = _program.spans(run), _program.counters(run)
    if got is None or counts is None or "decode.attention_launches" not in counts:
        return None
    ids = {s.id for s in _program.roots(got, "synth.request")}
    steps = sum(s.attrs.get("steps", 0) for s in got
                if s.name in ("decode.capture", "decode.run") and s.request in ids)
    return counts["decode.attention_launches"] / steps if steps else None
