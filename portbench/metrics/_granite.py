"""Helpers of the granite cell's readers: the configuration's sizes
(``yardstick_granite``) and the traced requests' prefills with their
``decode.run`` spans (``_hybrid.decodes``: the same spans)."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import _hybrid  # noqa: E402

from portbench import yardstick_granite as yg  # noqa: E402

decodes = _hybrid.decodes


def sizes(run):
    """The sizes, or None where the cell's decoder is not the granite block."""
    dec = run["config"]["model"]["decoder"]
    return yg.dims(dec) if dec.get("block") == "granite" else None
