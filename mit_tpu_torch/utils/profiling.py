"""Profiling and step timing (port of ``mit_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of a block (host ops, and the
  card's kernels where there is a card), written into ``logdir`` as a
  Chrome trace (Perfetto or ``chrome://tracing`` read it);
- :func:`span`: a named span of the program's own work (``mit.*``) in
  whatever profiler records, on the clock of the card's kernels; free when
  none records;
- :func:`fence`: waits for the card's queued work behind a tensor;
- :class:`StepTimer`: items per second over a rolling window of steps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("mit.decode.step"): ...`` marks the block in the trace
    of a profiler that records (``trace``, ``torch.profiler.profile``) as a
    ``user_annotation`` on the same clock as the card's kernels and copies.
    With no profiler recording it costs one flag read: it returns one
    shared ``nullcontext``. It never synchronizes, reads nothing back and
    changes no order of work."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace,
    ``<logdir>/trace_<pid>_<ns>.pt.trace.json``, at its end."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def fence(x) -> None:
    """Wait until the card has finished the work queued before now, where
    the first tensor of ``x`` (a tensor or nested dicts, lists, tuples) lies
    on one; on the CPU the work is done already."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Rolling step timer: ``with timer.step(n_items, sync=out): run()``."""

    def __init__(self, window: int = 50):
        self.window = window
        self.durations: List[float] = []
        self.items: List[int] = []

    @contextlib.contextmanager
    def step(self, n_items: int = 1, sync=None):
        """Time the block; ``sync`` is fenced before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            fence(sync)
        self.durations.append(time.perf_counter() - t0)
        self.items.append(n_items)
        if len(self.durations) > self.window:
            self.durations.pop(0)
            self.items.pop(0)

    @property
    def items_per_sec(self) -> float:
        total = sum(self.durations)
        return sum(self.items) / total if total > 0 else 0.0

    @property
    def mean_step_seconds(self) -> float:
        return sum(self.durations) / len(self.durations) if self.durations else 0.0

    def per_chip(self, n_chips: Optional[int] = None) -> float:
        """Items per second per card (``torch.cuda.device_count()`` cards
        unless ``n_chips`` says; at least one)."""
        n = n_chips or torch.cuda.device_count()
        return self.items_per_sec / max(1, n)

    def summary(self) -> Dict[str, float]:
        return {
            "items_per_sec": self.items_per_sec,
            "items_per_sec_per_chip": self.per_chip(),
            "mean_step_seconds": self.mean_step_seconds,
        }
