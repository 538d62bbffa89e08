"""Device ms a step in kernels that are neither the scan's nor the flash
attention's (cuBLAS, elementwise, copies, the optimizer), in the traced
steps."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    p = run.get("profile")
    if not p or "launches" not in p:
        return None
    ms = 1e3 * _common.device_seconds(run, None, (_common.SCAN, _common.FLASH))
    return ms / p["steps"] if ms > 0 else None
