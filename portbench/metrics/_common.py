"""Helpers shared by the per-layer readers: the traced stretch's kernels by
name, and the serving memory length of a cell."""
from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import yardstick  # noqa: E402

SCAN = re.compile(r"\bscan_(fwd_summary|carry|fwd_output|bwd_summary|bwd_grad)\b")
FLASH = re.compile(r"\bflash_(fwd|bwd_delta|bwd_dkdv|bwd_dq)\b")
MEGAKERNEL = re.compile(r"\bdecode_megakernel\b")


def device_seconds(run: dict, pattern=None, exclude=()) -> float:
    """Seconds of the traced stretch's kernels whose name matches
    ``pattern`` (all when None) and none of ``exclude``."""
    lo, hi = run["profile"]["window"]
    total = 0.0
    for name, s, e in run["profile"]["kernels"]:
        if pattern is not None and not pattern.search(name):
            continue
        if any(x.search(name) for x in exclude):
            continue
        total += max(0.0, min(e, hi) - max(s, lo))
    return total


def idle_percent(run: dict):
    if not run.get("profile") or not run["profile"]["kernels"]:
        return None
    lo, hi = run["profile"]["window"]
    busy = yardstick.union_seconds(((s, e) for _, s, e in run["profile"]["kernels"]), lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def memory_len(run: dict) -> int:
    """Cross-attention memory of a serving cell: the voice prompt's codec
    frames (a 64-frame bucket of its length) times the quantizers, plus the
    padded phoneme length."""
    m, t = run["config"]["model"], run["traffic"]
    c = m["codec"]
    hop = 1
    for r in c["up_ratios"]:
        hop *= r
    frames = -(-int(t["voice_seconds"] * c["sample_rate"]) // hop)
    S = min(c["max_seq_len"], yardstick.round_up(max(8, frames), 64))
    return S * m["decoder"]["num_quantizers"] + m["data"]["max_text_len"]
