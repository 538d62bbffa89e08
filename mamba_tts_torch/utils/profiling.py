"""Tracing and step timing — counterpart of ``mamba_tts_tpu/utils/profiling.py``.

- :func:`trace`: context manager around ``torch.profiler`` (CPU and, when a
  card is present, CUDA activity) that writes a Chrome trace into
  ``log_dir``.
- :func:`annotate`: a named profiler scope, so that a region (a selective
  scan, a cross-attention) shows up labelled in the trace.
- :class:`StepTimer`: wall-clock step timing with a warm-up skip.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """Named profiler scope (usable as a context manager or a decorator):
    ``torch.profiler.record_function``."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Times each ``with`` block; the first ``skip_first`` are warm-up."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self._times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")
