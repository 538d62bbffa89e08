"""Model operations of the decoded tokens (every product with a weight and
the attention over the memory, per step and row) over the window's wall,
as a share of the bf16 peak."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    if "records" not in run:
        return None
    y = _common.yardstick
    dims = y.decoder_dims(run["config"]["model"]["decoder"])
    Tm = _common.memory_len(run)
    flops = sum(dims["Q"] * r["frames"] * y.decode_step_flops(dims, r["rows"], Tm, dims["V"])
                for r in run["records"] if r["ok"])
    return 100.0 * flops / run["window_s"] / y.BF16_OPS_PER_S
