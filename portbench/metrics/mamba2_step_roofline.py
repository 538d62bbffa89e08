"""The Mamba-2 state kernel's least time over its device time in the traced
requests, in %: a call's bytes (``yardstick_granite.mamba2_call_bytes``:
the f32 state read and written, its operands and its output, at the rows of
the traced requests' prefills) at the HBM rate, times the kernel's records
in the trace, over those records' device time.  None where the trace holds
no such kernel."""
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402
import _granite  # noqa: E402

from portbench import yardstick_granite as yg  # noqa: E402

KERNEL = re.compile(r"\bmamba2_ssm_step_kernel\b")


def read(run):
    p, x = run.get("profile"), _granite.sizes(run)
    if not p or not p.get("kernels") or x is None:
        return None
    lo, hi = p["window"]
    calls = sum(1 for name, s, _ in p["kernels"] if KERNEL.search(name) and lo <= s <= hi)
    got = _granite.decodes(run)
    if not calls or not got:
        return None
    rows = {len(pre.attrs["lengths"]) for pre, _, _ in got}
    if len(rows) != 1:
        return None
    need = calls * yg.mamba2_call_bytes(x, rows.pop())
    busy = _common.device_seconds(run, KERNEL)
    return 100.0 * need / _common.yardstick.HBM_BYTES_PER_S / busy if busy > 0 else None
