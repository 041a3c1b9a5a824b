"""The benchmark's machinery: finding cells, configurations, traffic kinds
and per-layer metrics by name; the run's clock, spans and counters; the
profiled sub-window of a traced run and its reading; the result line.

Everything that belongs to one cell, configuration, traffic kind or
metric is a file of its own, found by name:

- ``workloads/<cell>.json``: the configuration, the traffic kind and its
  parameters, the chips, the end-to-end metrics it reports, the limits of
  its correctness check, and why it exists;
- ``configs/<config>.json``: the model's sizes, routes and settings;
- ``traffic/<kind>.py``: ``PRODUCES`` (end-to-end metrics), ``setup``,
  ``window``, ``release``, ``check`` (see ``run.py``) and ``faults`` (the
  faults ``readings.py`` plants in the reference);
- ``metrics/<metric>.py``: ``TRAFFIC`` (the kinds whose runs it reads),
  ``MOVES`` (the end-to-end metric it should move: it is read in the
  cells that report that one), ``UNIT``, and ``read(r)``, which returns
  a number or None.

Adding one of them is adding a file: nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import gzip
import importlib.util
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mit_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"capbench: no workload file {path}")
    return dict(load_json(path), name=name)


def config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"capbench: no configuration file {path}")
    return dict(load_json(path), name=name)


def _load(path: Path, prefix: str):
    name = f"capbench_{prefix}_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    path = HERE / "traffic" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"capbench: no traffic file {path}")
    return _load(path, "traffic")


def metric_names() -> list:
    return sorted(p.name[:-3] for p in (HERE / "metrics").glob("*.py")
                  if not p.name.startswith("_"))


def metric(name: str):
    return _load(HERE / "metrics" / f"{name}.py", "metric")


def metrics_for(cell: dict) -> dict:
    """{name: module} of every per-layer metric that reads runs of the
    ``cell``'s traffic kind and moves one of its end-to-end metrics."""
    out = {}
    for name in metric_names():
        mod = metric(name)
        if cell["traffic"] in mod.TRAFFIC and mod.MOVES in cell["end_to_end"]:
            out[name] = mod
    return out


def top_level_modules() -> set:
    return {m.split(".")[0] for m in list(sys.modules)}


def forbidden_loaded() -> list:
    """The JAX stack or the JAX package, if this process loaded either,
    compared by whole top-level module name."""
    mods = top_level_modules()
    return sorted(m for m in FORBIDDEN if m in mods)


# ----------------------------------------------------------------------
# the run's environment
# ----------------------------------------------------------------------
def fix_environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library
    that would load it by itself."""
    cache = ROOT / ".capbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"


def pin(cores: int) -> None:
    """Keep this process, and every thread it starts from now on, on the
    last ``cores`` CPUs it may run on: a host-bound loop then moves less
    from run to run."""
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(allowed[-cores:]))


# ----------------------------------------------------------------------
# spans, counters and the profiled sub-window
# ----------------------------------------------------------------------
class Recorder:
    """The benchmark's own spans and counters around its calls into each
    layer. Spans cost nothing with tracing off; with it on, each
    synchronizes the device at both ends and marks the profiler's trace
    (``record_function``)."""

    def __init__(self, trace: bool, sync):
        self.trace = trace
        self.sync = sync
        self.spans = defaultdict(list)      # name -> [seconds]
        self.counts = defaultdict(float)    # name -> total
        self.profiled = defaultdict(float)  # name -> total in the sub-window
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.trace:
            yield
            return
        from torch.profiler import record_function

        self.sync()
        t0 = time.perf_counter()
        with record_function(name):
            yield
        self.sync()
        self.spans[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: float = 1.0) -> None:
        self.counts[name] += n
        if self.profiling:
            self.profiled[name] += n


class SubWindow:
    """``torch.profiler`` over a short steady stretch of a traced window:
    it starts at the first ``tick`` past ``start`` seconds into the window
    and stops at the first ``length`` seconds after it has started (the
    profiler takes a second or more to start on the card)."""

    def __init__(self, rec: Recorder, start: float, length: float,
                 cuda: bool):
        self.rec, self.start, self.length, self.cuda = rec, start, length, cuda
        self.prof = None
        self.done = False
        self.t0 = self.t1 = None
        self.trace_path = None

    def tick(self, elapsed: float) -> None:
        if self.done or not self.rec.trace:
            return
        if self.prof is None and elapsed >= self.start:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.rec.sync()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._mark = record_function("capbench.window")
            self._mark.__enter__()
            self.t0 = time.perf_counter()
            self.rec.profiling = True
        elif self.prof is not None and \
                time.perf_counter() - self.t0 >= self.length:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self.rec.sync()
        self.t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.rec.profiling = False
        self.done = True
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        self.trace_path = path
        self.prof = None

    @property
    def window_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: str) -> dict:
    """The exported trace → device intervals, kernels by name and the host
    annotations, in the trace's clock (microseconds)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, kernels, notes, ops, window = [], [], [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), \
            float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((e.get("name", "?"), dur * 1e-6))
        elif cat == "user_annotation":
            if e.get("name") == "capbench.window":
                window = (ts, ts + dur)
            else:
                notes.append((ts, ts + dur, e.get("name", "?")))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append((ts, ts + dur, e.get("name", "?")))
    return {"device": dev, "kernels": kernels, "notes": notes, "ops": ops,
            "window": window}


def merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_and_gaps(tr: dict):
    """(busy seconds, idle gaps [(start, end)]) of the device within the
    traced window: the union of its kernel and copy intervals."""
    lo, hi = tr["window"] if tr["window"] else (
        min((a for a, _ in tr["device"]), default=0.0),
        max((b for _, b in tr["device"]), default=0.0))
    busy, gaps, cur = 0.0, [], lo
    for a, b in merge(tr["device"]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        busy += b - a
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return busy * 1e-6, gaps


def _innermost_at(intervals, points) -> list:
    """For each of ``points`` (sorted), the name of the innermost of
    ``intervals`` (start, end, name) under way at it, or None: one sweep
    with a stack, host calls being nested."""
    order = sorted(intervals)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(tr: dict, gaps, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (the benchmark's innermost span and the host
    call under way at the middle of each gap), each the ``top`` largest."""
    by_kernel = defaultdict(float)
    for name, s in tr["kernels"]:
        by_kernel[name[:160]] += s
    mids = sorted((a + b) / 2 for a, b in gaps)
    widths = {}
    for a, b in gaps:
        widths.setdefault((a + b) / 2, []).append(b - a)
    notes = _innermost_at(tr["notes"], mids)
    ops = _innermost_at(tr["ops"], mids)
    by_host = defaultdict(float)
    for mid, note, op in zip(mids, notes, ops):
        label = (note or "outside spans") + " / " + (op or "python")
        by_host[label[:160]] += widths[mid].pop() * 1e-6
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_kernel), "idle_gaps": rank(by_host)}


class Readings:
    """What a per-layer metric reads: the cell, its configuration, the
    spans and counters of the run, and the profiled sub-window's kernels,
    busy seconds and length."""

    def __init__(self, cell, cfg, rec: Recorder, kernels, busy_s, window_s):
        self.cell, self.cfg = cell, cfg
        self.spans, self.counts, self.profiled = \
            rec.spans, rec.counts, rec.profiled
        self.kernels = kernels
        self.busy_s, self.window_s = busy_s, window_s

    def span_mean_ms(self, name: str) -> Optional[float]:
        xs = self.spans.get(name)
        return sum(xs) / len(xs) * 1e3 if xs else None

    def matched(self, patterns) -> tuple:
        """(launches, device seconds) of the kernels whose name holds any
        of ``patterns``."""
        n, s = 0, 0.0
        for name, dur in self.kernels:
            if any(p in name for p in patterns):
                n += 1
                s += dur
        return n, s


# ----------------------------------------------------------------------
# output
# ----------------------------------------------------------------------
def say(obj) -> None:
    """An earlier line of standard output (the result line is the last)."""
    print(json.dumps(obj), flush=True)


def percentile(xs, q: float) -> float:
    """The q-th percentile (0–100) by linear interpolation between the
    sorted samples."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
