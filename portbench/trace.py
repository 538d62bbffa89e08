"""The traced run's readings: host-clock spans around calls into the
system's layers (each closed by a ``synchronize()``), and the device's
kernels from ``torch.profiler`` over a part of the window.

The first profiler session of a process can drop kernels at its edges, so
:func:`warm_profiler` opens and closes one during set-up; the counted
session opens after it.  The traced window is a named range that opens
after a synchronise and closes after one, so it holds every kernel of its
stretch and the device's idle time between them.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def span(name: str, device, sink: Optional[Dict[str, float]] = None):
    """A host-clock span closed by a device synchronise; its seconds are
    added to ``sink[name]``; under the profiler it is also a named range."""
    sync(device)
    t = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        sync(device)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + time.perf_counter() - t


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler(device) -> None:
    with torch.profiler.profile(activities=_activities(device)):
        torch.zeros(1, device=device).add_(1)
        sync(device)


class Profile:
    """The profiler over a stretch of the window: ``start()``, ``stop()``,
    then :meth:`read` -> kernels (name, start s, end s), the traced window
    (start s, end s) and the benchmark's spans (name, start s, end s), on
    the profiler's clock."""

    def __init__(self, device):
        self.device = device
        self.prof = torch.profiler.profile(activities=_activities(device))
        self._rf = None

    def start(self):
        sync(self.device)
        self.prof.start()
        self._rf = torch.profiler.record_function(WINDOW_SPAN)
        self._rf.__enter__()

    def stop(self):
        sync(self.device)
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Tuple[List[Tuple[str, float, float]], Tuple[float, float],
                            List[Tuple[str, float, float]]]:
        kernels, spans, window = [], [], None
        # the profiler's raw records: parsing them into a tree of events takes
        # minutes at a million kernels
        for e in self.prof.profiler.kineto_results.events():
            name, rng = e.name(), (e.start_ns() / 1e9, e.end_ns() / 1e9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the device side of a named range is no kernel
                if name != "Context Sync" and not e.is_user_annotation() \
                        and not name.startswith("portbench."):
                    kernels.append((name, *rng))
            elif name == WINDOW_SPAN:
                window = rng
            elif name.startswith("portbench."):
                spans.append((name, *rng))
        return kernels, window, spans


def breakdown(kernels, window, spans, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    inside ``window``, each named by the innermost benchmark span around
    its middle (``host`` outside every span)."""
    lo, hi = window
    by: Dict[str, float] = {}
    for name, s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by[name] = by.get(name, 0.0) + e - s
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, cur = [], lo
    for _, s, e in sorted((k for k in kernels if k[2] > lo and k[1] < hi), key=lambda k: k[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))

    def who(t):
        inner = [(e - s, n) for n, s, e in spans if s <= t <= e]
        return min(inner)[1] if inner else "host"

    named = sorted(((who((s + e) / 2), e - s) for s, e in gaps), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in named]}
