"""The grouped decode-attention kernel's least time over its device time in
the granite cell's traced requests, in %: a call's bytes
(``yardstick_granite.attention_call_bytes``: each row's valid K/V once a
K/V head, q and the output) at the HBM rate, the mean over the request's
steps times the kernel's records in the trace, over those records' device
time.  None where the cell's decoder is not the granite block or the trace
holds no such kernel."""
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _common  # noqa: E402
import _granite  # noqa: E402

from portbench import yardstick_granite as yg  # noqa: E402

KERNEL = re.compile(r"\bdecode_attention_grouped_kernel\b")


def read(run):
    p, x = run.get("profile"), _granite.sizes(run)
    if not p or not p.get("kernels") or x is None:
        return None
    lo, hi = p["window"]
    calls = sum(1 for name, s, _ in p["kernels"] if KERNEL.search(name) and lo <= s <= hi)
    got = _granite.decodes(run)
    if not calls or not got:
        return None
    Q = run["config"]["model"]["decoder"]["num_quantizers"]
    per_call = []
    for pre, _, frames in got:
        if frames is None:
            return None
        lengths = pre.attrs["lengths"]
        per_call += [yg.attention_call_bytes(x, len(lengths), yg.valid_keys(lengths, s))
                     for s in range(Q * frames)]
    need = sum(per_call) / len(per_call) * calls
    busy = _common.device_seconds(run, KERNEL)
    return 100.0 * need / _common.yardstick.HBM_BYTES_PER_S / busy if busy > 0 else None
