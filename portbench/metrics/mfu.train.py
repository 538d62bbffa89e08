"""Model operations of a training step (6 per multiply-add with a weight,
the cross-attention's 7 products, nothing recomputed) over the mean step
time, as a share of the bf16 peak; in a traced run the mean of the steps
that ran before the profiler opened."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402


def read(run):
    if "tokens" not in run:
        return None
    y = _common.yardstick
    m, t = run["config"]["model"], run["traffic"]
    dims = y.decoder_dims(m["decoder"])
    Tq = dims["Q"] * t["frames"]
    Tk = dims["Q"] * t["voice_frames"] + m["data"]["max_text_len"]
    flops = y.train_step_flops(dims, m["text_encoder"], t["batch"], Tq, Tk,
                               m["data"]["max_text_len"])
    p = run.get("profile") or {}
    if p.get("unprofiled_steps"):  # traced: the steps before any profiler session
        step_s = p["unprofiled_s"] / p["unprofiled_steps"]
    else:
        step_s = run["window_s"] / run["steps"]
    return 100.0 * flops / step_s / y.BF16_OPS_PER_S
