"""The granite decoder's operations for the window's requests, the prefill
of every row and its decoded tokens (``yardstick_granite``: routed experts
at their expectation on this card, 10 × 9/72 a token), over the window's
wall, as a share of the bf16 peak.  The prefix lengths come from the
benchmark's record of each decode call; None without them."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402
import _granite  # noqa: E402

from portbench import yardstick_granite as yg  # noqa: E402


def read(run):
    x = _granite.sizes(run)
    if x is None or not run.get("prefix_lengths") or "records" not in run:
        return None
    Q = run["config"]["model"]["decoder"]["num_quantizers"]
    flops = 0.0
    for r in run["records"]:
        lengths = run["prefix_lengths"].get(r["index"])
        if r["ok"] and lengths:
            flops += yg.prefill_flops(x, lengths) + yg.decode_flops(x, lengths, Q * r["frames"])
    return 100.0 * flops / run["window_s"] / _common.yardstick.BF16_OPS_PER_S
