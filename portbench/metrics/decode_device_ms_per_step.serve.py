"""Device ms a decode step (one step decodes every row of a batch) in the
traced requests: the device time of the program's ``decode.run`` spans (the
megakernel's launch, or the captured graph's replays) over their steps.
None off the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    got = _program.spans(run)
    if got is None:
        return None
    ids = {s.id for s in _program.roots(got, "synth.request")}
    runs = [s for s in got if s.name == "decode.run" and s.request in ids]
    if not runs or any(s.device_ms is None for s in runs):
        return None
    return sum(s.device_ms for s in runs) / sum(s.attrs["steps"] for s in runs)
