"""A granite decode step's least time over its device time, in %: the bytes
of a step (``yardstick_granite.step_bytes``: every weight and every held
expert once, the Mamba-2 states and conv windows read and written, each
row's valid K/V) at the HBM rate, summed over the steps of the traced
requests' ``decode.run`` spans, over those spans' device ms.  None where
the program traced no prefill."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _granite  # noqa: E402

from portbench import yardstick  # noqa: E402
from portbench import yardstick_granite as yg  # noqa: E402


def read(run):
    x = _granite.sizes(run)
    got = _granite.decodes(run) if x else None
    if not got:
        return None
    Q = run["config"]["model"]["decoder"]["num_quantizers"]
    need, busy_ms = 0.0, 0.0
    for pre, runs, frames in got:
        if not runs or frames is None or any(r.device_ms is None for r in runs):
            return None
        total, done = Q * frames, sum(r.attrs["steps"] for r in runs)
        lengths = pre.attrs["lengths"]
        need += sum(yg.step_bytes(x, len(lengths), yg.valid_keys(lengths, s))
                    for s in range(total - done, total))
        busy_ms += sum(r.device_ms for r in runs)
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / (busy_ms / 1e3) if busy_ms else None
