"""The program's own spans in a profiled stretch, and the card's work that
each one launched.

``mit_tpu_torch.utils.profiling.span`` marks the port's work (``mit.*``
names: ``mit.encode``, ``mit.decode.loop``, ``mit.decode.step``,
``mit.train.optimizer``, ...) as ``user_annotation`` events of whatever
profiler records, on the clock of the card's kernels and copies. This
module reads them from the Chrome trace the profiler exports (the file
``core.read_trace`` reads) and ties each device operation to them:

- the spans: every complete ``mit.*`` interval that lies wholly inside the
  profiled stretch (``capbench.window``; the whole trace where it has
  none), on any host thread;
- the launches: the ``cuda_runtime`` and ``cuda_driver`` calls with their
  ``args.correlation`` (``cudaLaunchKernel``,
  ``cudaLaunchCooperativeKernel``, ``cuLaunchKernel*``, ``cudaGraphLaunch``,
  the memcpy and memset calls);
- the device operations (``kernel``, ``gpu_memcpy``, ``gpu_memset``) with
  their ``args.correlation``.

A device operation belongs to the innermost span, on any host thread,
whose interval holds its launch call: autograd issues the backward from
its own thread while the caller waits in ``mit.train.backward``.
``device(name)`` counts the operations launched inside a span of that name
at any depth.

A trace with no ``mit.*`` span (a program that predates them) reads as
empty: every reading below is then None, and so is a device reading where
no device operation ran (a CPU run).

``READINGS`` are the ten per-layer metrics these spans feed, by what they
read; ``capbench/run.py`` does not hand the trace to the metrics yet
(``PERF.md`` §7), so they are read by running a cell through this file::

    python3 capbench/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1

which runs ``run.py`` as it is, reads the profiled stretch's trace before
``run.py`` deletes it, and prints ``SPANS {"readings": ..., "spans": ...}``
on standard error (per span name: count, mean host ms, device operations
and µs launched a span, the card's idle share inside).
"""

from __future__ import annotations

import gzip
import json
import sys
from pathlib import Path
from typing import Optional

PREFIX = "mit."
WINDOW = "capbench.window"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs: list, ys: list) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class ProgramSpans:
    """The ``mit.*`` spans of a profiled stretch and the device operations
    they launched. Times are the trace's microseconds."""

    def __init__(self, spans: list, ops: list, device: list):
        # spans: (start, end, name), sorted by start, the outer one first
        # ops: (duration, index of the innermost span holding the launch)
        # device: (start, end) of every device operation in the trace
        self.spans = spans
        self.ops = ops
        self.device_intervals = device
        self.parent = self._parents()

    def _parents(self) -> list:
        """For each span, the latest-started one that holds it, or None."""
        out, stack = [], []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < a:
                stack.pop()
            out.append(next((j for j in reversed(stack)
                             if self.spans[j][1] >= b), None))
            stack.append(i)
        return out

    def _under(self, i: Optional[int], name: str) -> bool:
        while i is not None:
            if self.spans[i][2] == name:
                return True
            i = self.parent[i]
        return False

    def of(self, name: str) -> list:
        """[(start, end)] of the spans called ``name``."""
        return [(a, b) for a, b, n in self.spans if n == name]

    def host_ms(self, name: str) -> Optional[float]:
        """The mean length of the spans called ``name``, in ms."""
        xs = self.of(name)
        return sum(b - a for a, b in xs) / len(xs) * 1e-3 if xs else None

    def count_inside(self, inner: str, outer: str) -> int:
        """The spans called ``inner`` that lie inside one called ``outer``."""
        return sum(1 for i, (_, _, n) in enumerate(self.spans)
                   if n == inner and self._under(self.parent[i], outer))

    def device(self, name: str) -> tuple:
        """(operations, device µs) launched inside a span called ``name``,
        at any depth."""
        n, us = 0, 0.0
        for dur, i in self.ops:
            if self._under(i, name):
                n += 1
                us += dur
        return n, us

    def idle_share(self, name: str) -> Optional[float]:
        """The share (%) of the union of the spans called ``name`` in which
        no device operation ran (any operation, the union of their
        intervals clipped to the spans); None where no device operation
        ran at all."""
        spans = _merge(self.of(name))
        total = sum(b - a for a, b in spans)
        if total <= 0 or not self.device_intervals:
            return None
        busy = _overlap(spans, _merge(self.device_intervals))
        return 100.0 * (1.0 - busy / total)


def _innermost(spans: list, points: list) -> list:
    """For each of ``points`` (sorted), the index of the latest-started of
    ``spans`` (sorted by start) whose interval holds it, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def read(path: str) -> ProgramSpans:
    """The program's spans and the device operations of a Chrome trace
    exported by ``torch.profiler``."""
    window, spans, launches, device = None, [], {}, []
    for e in _events(path):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts = float(e.get("ts", 0))
        te = ts + float(e.get("dur", 0))
        if cat == "user_annotation":
            if name == WINDOW:
                window = (ts, te)
            elif name.startswith(PREFIX):
                spans.append((ts, te, name))
        elif cat in LAUNCH_CATS and _correlation(e) is not None:
            launches[_correlation(e)] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, te, _correlation(e)))
    if window is not None:
        lo, hi = window
        spans = [s for s in spans if lo <= s[0] and s[1] <= hi]
    spans.sort(key=lambda s: (s[0], -s[1]))
    launched = sorted((launches[c], b - a) for a, b, c in device
                      if c in launches)
    owners = _innermost(spans, [t for t, _ in launched])
    ops = [(dur, i) for (_, dur), i in zip(launched, owners)]
    return ProgramSpans(spans, ops, [(a, b) for a, b, _ in device])


def _per_span(s: ProgramSpans, name: str, value) -> Optional[float]:
    n = len(s.of(name))
    return value / n if n and value is not None else None


def _device(s: ProgramSpans, name: str, what: int) -> Optional[float]:
    """Operations (0) or device µs (1) launched in the spans called
    ``name``; None where none ran."""
    got = s.device(name)
    return got[what] if got[0] else None


def _step_host_us(s: ProgramSpans) -> Optional[float]:
    steps = s.count_inside("mit.decode.step", "mit.decode.loop")
    loop = sum(b - a for a, b in s.of("mit.decode.loop"))
    return loop / steps if steps else None


def _encode_device_ms(s: ProgramSpans) -> Optional[float]:
    us = _per_span(s, "mit.encode", _device(s, "mit.encode", 1))
    return None if us is None else us * 1e-3


READINGS = {
    # the loop's host µs over the steps inside it
    "decode_step_host_us": _step_host_us,
    "decode_idle_share": lambda s: s.idle_share("mit.decode.loop"),
    "reorder_device_us": lambda s: _per_span(
        s, "mit.decode.reorder", _device(s, "mit.decode.reorder", 1)),
    "encode_device_ms": _encode_device_ms,
    "forward_host_ms": lambda s: s.host_ms("mit.train.forward"),
    "backward_host_ms": lambda s: s.host_ms("mit.train.backward"),
    "optimizer_host_ms": lambda s: s.host_ms("mit.train.optimizer"),
    "optimizer_launches": lambda s: _per_span(
        s, "mit.train.optimizer", _device(s, "mit.train.optimizer", 0)),
}


def summary(s: ProgramSpans) -> dict:
    """``READINGS`` and, per span name, count, mean host ms, device
    operations and µs a span and the card's idle share inside."""
    spans = {}
    for name in sorted({n for _, _, n in s.spans}):
        n = len(s.of(name))
        ops, us = s.device(name)
        spans[name] = {"n": n, "host_ms": s.host_ms(name),
                       "ops_per": ops / n, "device_us_per": us / n,
                       "idle_share": s.idle_share(name)}
    return {"readings": {k: f(s) for k, f in READINGS.items()},
            "spans": spans}


def main(argv=None) -> int:
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from capbench import core, run

    found = {}
    read_trace = core.read_trace

    def keep(path):
        found.update(summary(read(path)))
        return read_trace(path)

    core.read_trace = keep
    try:
        rc = run.main(argv)
    finally:
        core.read_trace = read_trace
    print("SPANS " + json.dumps(found), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
