"""The mixture of experts' share of the prefill in the traced requests, in
%: Σ device ms of the program's ``prefill.moe`` spans (``models/granite.py``
``GraniteLayer.forward``, one a layer) over Σ device ms of the
``decode.prefill`` spans they lie in.  None where the program has no such
spans."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    got = _program.spans(run)
    if got is None:
        return None
    ids = {s.id for s in _program.roots(got, "synth.request")}
    pre = [s for s in got if s.name == "decode.prefill" and s.request in ids]
    moe = [s for s in got if s.name == "prefill.moe" and s.request in ids]
    if not pre or not moe or any(s.device_ms is None for s in pre + moe):
        return None
    return 100.0 * sum(s.device_ms for s in moe) / sum(s.device_ms for s in pre)
