"""Helpers of the readers of the system's own spans and counters
(``mamba_tts_torch.utils.profiling``): what the program recorded inside the
traced window, taken per traced request or step (the root spans
``synth.request`` and ``train.step``).  A program without that tracer, or a
run without a traced window, reads None."""
from __future__ import annotations

# the tracer stamps its spans on the clock of the profiler's events; a
# span's ends may lie this far outside the window's named range
SLACK_NS = 1_000_000


def _tracer():
    try:
        from mamba_tts_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def _window(run):
    p = run.get("profile")
    if not p or not p.get("window"):
        return None
    lo, hi = p["window"]
    return int(lo * 1e9) - SLACK_NS, int(hi * 1e9) + SLACK_NS


def spans(run):
    """The program's spans inside the traced window, or None."""
    tracer, window = _tracer(), _window(run)
    if tracer is None or window is None:
        return None
    return tracer.spans(window)


def counters(run):
    """The program's counts made inside the traced window, or None."""
    tracer, window = _tracer(), _window(run)
    if tracer is None or window is None:
        return None
    return tracer.counters(window)


def roots(got, root: str) -> list:
    return [s for s in got if s.name == root and s.parent is None]


def per_root(run, root: str, names, device: bool = False):
    """Host ms (or, with ``device``, device ms) of the spans named ``names``
    under the root spans ``root``, over the number of those roots; None
    where no root was traced or a span has no device time."""
    got = spans(run)
    if got is None:
        return None
    ids = {s.id for s in roots(got, root)}
    if not ids:
        return None
    mine = [s for s in got if s.name in names and s.request in ids]
    if device:
        if not mine or any(s.device_ms is None for s in mine):
            return None
        return sum(s.device_ms for s in mine) / len(ids)
    return sum(s.host_ms for s in mine) / len(ids)
