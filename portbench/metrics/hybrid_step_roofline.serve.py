"""A jamba decode step's least time over its device time, in %: the bytes
of a step (``yardstick_hybrid.step_bytes``: every weight once, the Mamba
states read and written, each row's valid K/V) at the HBM rate, summed over
the steps of the traced requests' ``decode.run`` spans, over those spans'
device ms.  None where the program traced no prefill."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _hybrid  # noqa: E402

from portbench import yardstick  # noqa: E402
from portbench import yardstick_hybrid as yh  # noqa: E402


def read(run):
    got = _hybrid.decodes(run)
    if not got:
        return None
    x = _hybrid.sizes(run)
    Q = run["config"]["model"]["decoder"]["num_quantizers"]
    need, busy_ms = 0.0, 0.0
    for pre, runs, frames in got:
        if not runs or frames is None or any(r.device_ms is None for r in runs):
            return None
        total, done = Q * frames, sum(r.attrs["steps"] for r in runs)
        lengths = pre.attrs["lengths"]
        need += sum(yh.step_bytes(x, len(lengths), yh.valid_keys(lengths, s))
                    for s in range(total - done, total))
        busy_ms += sum(r.device_ms for r in runs)
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / (busy_ms / 1e3) if busy_ms else None
