"""Run one cell of the benchmark of ``mit_tpu_torch`` and print its result.

    python3 capbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run is one process: it reads the cell's files, makes its weights and
inputs from ``--seed`` on the card, builds the program and warms up every
shape the cell's traffic uses (``setup_s``: process start to the first
timed call, less the seconds the plain reference spent calibrating the
inputs), measures for ``--seconds`` seconds, frees the program, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output. With ``--trace 0`` its ``metrics`` are
the cell's end-to-end metrics; with ``--trace 1`` the spans synchronize
at each layer boundary, the profiler records a short steady stretch of the
window, and the metrics are the per-layer ones, with ``busy_s``,
``window_s`` and a ``breakdown``.

A cell whose parameters name ``pin_cores`` runs on that many CPUs, the
last the process may use, with every thread it starts. A run refuses to
measure without as many CUDA devices as the cell asks for. ``--rehearse`` runs the same traffic on the CPU at a toy size, for
the harness's own tests; it prints the line with ``"rehearsal": true``
and a CPU device, never a device metric. ``--rate`` overrides an open
loop's arrival rate (for a sweep; the cell's rate is in its file).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from capbench import core  # noqa: E402


def process_start() -> float:
    """This process's start, on the wall clock (``/proc``; else the time
    this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def toy(cfg: dict) -> dict:
    """The configuration cut to a toy size for a CPU rehearsal, in float32
    so that the program and the reference agree to rounding."""
    cfg = json.loads(json.dumps(cfg))
    cfg["encoder"].update(image_size=32, patch_size=16, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128)
    cfg["decoder"].update(vocab_size=200, embed_dim=64, num_heads=2,
                          num_layers=2, ff_dim=64, max_seq_len=24)
    cfg["preprocess"]["size"] = 32
    cfg["compute_dtype"] = "float32"
    cfg["service"]["num_slots"] = 6
    cfg["assumed"].update(calibration_images=4, image_hw=[40, 48],
                          mean_caption_tokens=6.0)
    return cfg


class Ctx:
    """One run: the cell, its configuration and traffic parameters, the
    seed and window, the device, the recorder and the sub-window."""

    def __init__(self, args, cell, cfg):
        import torch

        self.torch = torch
        self.cell, self.cfg = cell, cfg
        self.params = dict(cell["params"])
        if args.rehearse:
            self.params.update(cell.get("rehearsal", {}))
        if args.rate is not None:
            self.params["rate"] = args.rate
        self.seed = args.seed
        self.seconds = float(args.seconds)
        self.rehearse = args.rehearse
        self.device = torch.device("cpu" if args.rehearse else "cuda")
        cuda = self.device.type == "cuda"
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        self.rec = core.Recorder(bool(args.trace), self.sync)
        start = 0.25 * self.seconds
        self.sub = core.SubWindow(self.rec, start, min(1.5, 0.25 * self.seconds),
                                  cuda)
        self.info: dict = {}
        self.reference_s = 0.0       # the reference's part of set-up


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--rate", type=float, default=None)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"capbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse(argv)
    t_start = process_start()
    core.fix_environment()
    cell = core.workload(args.workload)
    cfg = core.config(cell["config"])
    if args.rehearse:
        cfg = toy(cfg)
    if cell["params"].get("pin_cores"):
        core.pin(cell["params"]["pin_cores"])
    import torch

    if not args.rehearse:
        if not torch.cuda.is_available():
            fail("no CUDA device: the benchmark measures on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            fail(f"the cell asks for {cell['chips']} CUDA devices, "
                 f"{torch.cuda.device_count()} present")
    try:
        import mit_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    if ROOT not in Path(mit_tpu_torch.__file__).resolve().parents:
        fail(f"mit_tpu_torch comes from {mit_tpu_torch.__file__}, "
             f"outside the checkout {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    ctx = Ctx(args, cell, cfg)
    kind = core.traffic(cell["traffic"])
    if args.trace:
        per_layer = core.metrics_for(cell)
    state = kind.setup(ctx)
    ctx.sync()
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start - ctx.reference_s
    ctx.info["setup_reference_s"] = ctx.reference_s

    out = kind.window(ctx, state)
    ctx.sub.stop()
    loaded = core.forbidden_loaded()
    if loaded:
        fail(f"the run loaded {', '.join(loaded)}; nothing it runs may "
             "import the JAX stack or the JAX package", 3)
    peak = (torch.cuda.max_memory_allocated() if ctx.device.type == "cuda"
            else 0)
    ctx.info["counters"] = kind.counters(ctx, state)
    kind.release(ctx, state)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = kind.check(ctx, state, out)
    limits = cell["limits"]
    # the numbers the cell compares have a limit (one it cannot read
    # fails); the rest are shown
    checks = {k: readings.get(k, math.inf) for k in limits}
    ctx.info["check_readings"] = readings

    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": device}
    if args.trace:
        kernels, busy_s, gaps, window_s = [], None, [], ctx.sub.window_s
        tr = None
        if ctx.sub.trace_path:
            tr = core.read_trace(ctx.sub.trace_path)
            os.unlink(ctx.sub.trace_path)
            kernels = tr["kernels"]
            busy_s, gaps = core.busy_and_gaps(tr)
        r = core.Readings(cell, cfg, ctx.rec, kernels, busy_s, window_s)
        for name, mod in per_layer.items():
            value = mod.read(r)
            if value is not None and math.isfinite(value):
                result["metrics"][name] = {"value": value, "unit": mod.UNIT}
        if ctx.device.type == "cuda":
            device.update(busy_s=busy_s, window_s=window_s)
        if tr is not None:
            result["breakdown"] = core.breakdown(tr, gaps)
    else:
        for name in cell["end_to_end"]:
            result["metrics"][name] = {"value": out["metrics"][name],
                                       "unit": kind.PRODUCES[name]}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    if args.rehearse:
        # a CPU run's numbers never go under a device metric's name
        result["rehearsal"] = True
        result["rehearsal_metrics"] = {k: v["value"] for k, v
                                       in result.pop("metrics").items()}
        result["metrics"] = {}
    result["correct"] = bool(out["failed"] == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items()))
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    core.say({"info": ctx.info})
    for k, v in checks.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    print(f"correct {result['correct']} failed {out['failed']} "
          f"of {out['attempted']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
