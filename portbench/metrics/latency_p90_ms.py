"""90th percentile of every request's latency in the window, call to
waveform, nearest rank."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from portbench.yardstick import percentile  # noqa: E402


def read(run):
    if "records" not in run:
        return None
    walls = [r["wall_s"] if r["ok"] else float("inf") for r in run["records"]]
    return 1e3 * percentile(walls, 90)[0]
