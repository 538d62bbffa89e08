"""Share of a training step in which no kernel ran: the device's busy time
a step, from the kernels of the traced steps, over the mean time of the
window's steps before them, which ran before any profiler session of the
process and so without its host cost.  None where no such step ran."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    p = run.get("profile")
    if "tokens" not in run or not p or not p["kernels"] or not p.get("unprofiled_steps"):
        return None
    lo, hi = p["window"]
    busy = _common.yardstick.union_seconds(((s, e) for _, s, e in p["kernels"]), lo, hi)
    step_s = p["unprofiled_s"] / p["unprofiled_steps"]
    return 100.0 * (1.0 - busy / p["steps"] / step_s)
