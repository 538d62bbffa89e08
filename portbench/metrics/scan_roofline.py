"""The selective-scan calls' least time (each call's bytes, FMA-pipe
operations or exps, whichever bounds it) over the device time of the scan
kernels, in the traced steps."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    p = run.get("profile")
    if not p or "launches" not in p:
        return None
    busy = _common.device_seconds(run, _common.SCAN)
    if busy <= 0:
        return None
    y = _common.yardstick
    m, t = run["config"]["model"], run["traffic"]
    dims = y.decoder_dims(m["decoder"])
    shape = (t["batch"], dims["Q"] * t["frames"], dims["di"], dims["N"])
    bound_ms = sum(p["launches"][k] * y.scan_bound_ms(kind, *shape)
                   for k, kind in (("scan_fwd", "fwd"), ("scan_fwd_ckpt", "fwd_ckpt"),
                                   ("scan_bwd", "bwd")))
    return 100.0 * bound_ms / 1e3 / busy
