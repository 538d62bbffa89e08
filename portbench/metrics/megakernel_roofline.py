"""The decode megakernel's least time (every input read once, or its
operations at the bf16 peak, whichever is larger) over its device time in
the traced requests."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    p = run.get("profile")
    if not p or "requests" not in p:
        return None
    busy = _common.device_seconds(run, _common.MEGAKERNEL)
    if busy <= 0:
        return None
    y = _common.yardstick
    dims = y.decoder_dims(run["config"]["model"]["decoder"])
    Tm = _common.memory_len(run)
    bound_ms = sum(y.megakernel_bound_ms(dims, r["rows"], Tm, dims["Q"] * r["frames"])
                   for r in p["requests"])
    return 100.0 * bound_ms / 1e3 / busy
