"""Helpers of the jamba cell's readers: the configuration's sizes and the
program's ``decode.prefill`` spans (each traced request's rows and prefix
lengths) with the ``decode.run`` spans of the same request."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import _program  # noqa: E402

from portbench import yardstick_hybrid as yh  # noqa: E402


def sizes(run):
    return yh.dims(run["config"]["model"]["decoder"])


def decodes(run):
    """[(prefill span, its request's ``decode.run`` spans, frames)] of the
    traced requests, in order; None where the program traced no prefill."""
    got, p = _program.spans(run), run.get("profile") or {}
    if got is None or not p.get("requests"):
        return None
    roots = {s.id for s in _program.roots(got, "synth.request")}
    pre = [s for s in got if s.name == "decode.prefill" and s.request in roots
           and "lengths" in s.attrs]
    if not pre or len(pre) != len(p["requests"]):
        return None
    return [(s, [r for r in got if r.name == "decode.run" and r.request == s.request],
             req["frames"]) for s, req in zip(pre, p["requests"])]
