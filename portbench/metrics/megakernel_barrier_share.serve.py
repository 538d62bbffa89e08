"""Share of the decode megakernel's middle step that its block 0 spends
inside grid barriers, from the stage stamps the traced requests' launches
wrote (the ``stage_clocks`` attribute of the program's ``decode.run``
spans: the step's start, then the entry and exit of every barrier):
Σ (exit − entry) over Σ (last stamp − first).  None where no launch wrote
stamps (off the card, or another decode path)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    got = _program.spans(run)
    if got is None:
        return None
    stamps = [s.attrs["stage_clocks"] for s in got
              if s.name == "decode.run" and "stage_clocks" in s.attrs]
    if not stamps:
        return None
    wait = sum(c[i + 1] - c[i] for c in stamps for i in range(1, len(c) - 1, 2))
    return 100.0 * wait / sum(c[-1] - c[0] for c in stamps)
