"""Share of the traced requests' stretch in which no kernel ran."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    if "records" not in run:
        return None
    return _common.idle_percent(run)
