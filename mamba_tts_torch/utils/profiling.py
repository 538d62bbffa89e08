"""Tracing and step timing — counterpart of ``mamba_tts_tpu/utils/profiling.py``.

- :func:`trace`: context manager around ``torch.profiler`` (CPU and, when a
  card is present, CUDA activity) that writes a Chrome trace into
  ``log_dir``.
- :class:`annotate`: a span of the program's tracer, as a context manager or
  a decorator; :func:`count` a counter.
- :class:`StepTimer`: wall-clock step timing with a warm-up skip.

The tracer.  The program opens a span at each layer boundary of serving
and training (``synth.request`` and its front-ends, ``synth.decode`` with
``decode.memory``, ``decode.plan``, ``decode.capture`` and ``decode.run``;
``train.step`` with ``train.forward``, ``train.backward`` and
``train.optimizer``) and counts a few events (``decode.graph_captures``,
``decode.attention_launches``).
Tracing is on while :func:`enable` is in force or while a
``torch.profiler`` session is open, so a profiled stretch carries the
program's spans, and is off otherwise: a span then costs one check and
records nothing.  A span records its name, its id, its parent's id, the id
of its root (the request or step it belongs to, shared by every span under
that root), its attributes, and its host start and end in ns on the clock
of the profiler's events (Unix-epoch ns).  Under a profiler it is also a
named range (``record_function``), so a Chrome trace shows it.  A span
opened with ``device_time=True`` in a process that uses the card also
records a pair of CUDA timing events on the current stream.  Nothing is
recorded while the current stream is being captured into a CUDA graph.
What was recorded stays in memory until :func:`reset`; :func:`spans` and
:func:`counters` read it (``spans`` synchronises the card once to resolve
the device times and reads tensor attributes to the host).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

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


class Span:
    """One recorded span.  ``device_ms`` is None until :func:`spans` has
    resolved it, and stays None for a span that recorded no device time."""

    __slots__ = ("name", "id", "parent", "request", "attrs", "start_ns", "end_ns", "device_ms",
                 "_events", "_rf")

    def __init__(self, name: str, sid: int, parent: Optional["Span"], attrs: dict):
        self.name, self.id, self.attrs = name, sid, attrs
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else sid
        self.start_ns = self.end_ns = self.device_ms = None
        self._events = self._rf = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, attrs={self.attrs})")


class _Tracer:
    """The process's spans and counts (one tracer a process, as there is one
    profiler)."""

    def __init__(self):
        self.forced = False
        self.offset_ns: Optional[int] = None  # Unix-epoch ns less perf_counter ns
        self.records: List[Span] = []
        self.counts: List[Tuple[str, int, int]] = []  # (name, n, host ns)
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.pool: List[tuple] = []  # free pairs of CUDA timing events

    def now_ns(self) -> int:
        if self.offset_ns is None:  # once: the profiler stamps its events in Unix-epoch ns
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
        return time.perf_counter_ns() + self.offset_ns

    def stack(self) -> List[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str, device_time: bool, attrs: dict) -> Optional[Span]:
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return None
        stack = self.stack()
        s = Span(name, next(self.ids), stack[-1] if stack else None, attrs)
        s.start_ns = self.now_ns()
        if torch.autograd._profiler_enabled():
            s._rf = torch.profiler.record_function(name)
            s._rf.__enter__()
        if device_time and cuda:
            s._events = (self.pool.pop() if self.pool else
                         tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)))
            s._events[0].record()
        stack.append(s)
        self.records.append(s)
        return s

    def close(self, s: Span) -> None:
        if s._events is not None:
            s._events[1].record()
        if s._rf is not None:
            s._rf.__exit__(None, None, None)
            s._rf = None
        s.end_ns = self.now_ns()
        stack = self.stack()
        while stack and stack.pop() is not s:
            pass

    def spans(self, window=None) -> List[Span]:
        pending = [s for s in self.records if s._events is not None and s.end_ns is not None]
        if pending:
            torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            self.pool.append(s._events)
            s._events = None
        out = []
        for s in self.records:
            if s.end_ns is None:
                continue
            for k, v in s.attrs.items():
                if isinstance(v, torch.Tensor):
                    s.attrs[k] = v.tolist()
            if window is None or (window[0] <= s.start_ns and s.end_ns <= window[1]):
                out.append(s)
        return out

    def counters(self, window=None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, n, t in self.counts:
            if window is None or window[0] <= t <= window[1]:
                out[name] = out.get(name, 0) + n
        return out

    def reset(self) -> None:
        self.records, self.counts = [], []


_TRACER = _Tracer()


class annotate:
    """A span named ``name`` with attributes ``attrs`` (``rows``, ``frames``,
    ``steps``, ``path``...), usable as a context manager or a decorator.
    Entering it yields the :class:`Span` while tracing is on (attributes may
    be added to ``span.attrs`` before it closes; a tensor attribute is read
    to the host by :func:`spans`) and None while it is off.
    ``device_time=True`` also times the enclosed work on the current CUDA
    stream."""

    __slots__ = ("name", "device_time", "attrs", "_span")

    def __init__(self, name: str, device_time: bool = False, **attrs):
        self.name, self.device_time, self.attrs, self._span = name, device_time, attrs, None

    def __enter__(self) -> Optional[Span]:
        if not (_TRACER.forced or torch.autograd._profiler_enabled()):
            return None
        self._span = _TRACER.open(self.name, self.device_time, dict(self.attrs))
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            _TRACER.close(self._span)
            self._span = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(self.name, self.device_time, **self.attrs):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_TRACER.forced or torch.autograd._profiler_enabled()):
        return
    _TRACER.counts.append((name, n, _TRACER.now_ns()))


def enable() -> None:
    """Record spans and counts with no profiler open, until :func:`disable`."""
    _TRACER.forced = True


def disable() -> None:
    _TRACER.forced = False


def spans(window: Optional[Tuple[int, int]] = None) -> List[Span]:
    """The closed spans in the order they opened; with ``window`` = (start,
    end) in the spans' ns, those whose host interval lies inside it."""
    return _TRACER.spans(window)


def counters(window: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """Each counter's total; with ``window``, of the counts made inside it."""
    return _TRACER.counters(window)


def reset() -> None:
    """Forget every span and count recorded so far."""
    _TRACER.reset()


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
