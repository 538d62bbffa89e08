"""Structured training/inference metrics — the PyTorch port's copy of
``mamba_tts_tpu/utils/metrics.py``, with TensorBoard written through
``torch.utils.tensorboard`` where that is installed.

The reference logs with bare ``print`` (reference: train.py:237-241) — here
metrics are structured: per-step JSON lines to stdout and/or a file, with
the step time and throughput (tokens/sec), and an optional TensorBoard
writer.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        log_file: Optional[str] = None,
        tensorboard_dir: Optional[str] = None,
        stdout: bool = True,
    ):
        self.stdout = stdout
        self._file = open(log_file, "a") if log_file else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed: JSON lines only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(tensorboard_dir)
        self._t_last: Optional[float] = None

    def log(self, step: int, metrics: Dict[str, float], tokens: Optional[int] = None):
        now = time.perf_counter()
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._t_last is not None:
            dt = now - self._t_last
            record["step_time_s"] = round(dt, 4)
            if tokens:
                record["tokens_per_sec"] = round(tokens / dt, 1)
        self._t_last = now
        line = json.dumps(record)
        if self.stdout:
            print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=step)

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
