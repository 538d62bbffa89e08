"""The flash attention calls' least time (2 and 5 products of
B·H·Tq·Tk·64 at the bf16 peak, or their bytes) over the device time of the
flash kernels, in the traced steps."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    p = run.get("profile")
    if not p or "launches" not in p:
        return None
    busy = _common.device_seconds(run, _common.FLASH)
    if busy <= 0:
        return None
    y = _common.yardstick
    m, t = run["config"]["model"], run["traffic"]
    dims = y.decoder_dims(m["decoder"])
    Tq = dims["Q"] * t["frames"]
    Tk = dims["Q"] * t["voice_frames"] + m["data"]["max_text_len"]
    bound_ms = sum(p["launches"][f"flash_{k}"] * y.flash_bound_ms(k, t["batch"], dims["H"], Tq, Tk)
                   for k in ("fwd", "bwd"))
    return 100.0 * bound_ms / 1e3 / busy
