"""The readings that a cell's correctness limits are set from.

    python3 capbench/readings.py --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... [--control] [--faults]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the numbers its check compares, read from the
program (``program``); with ``--control`` the same numbers with the
reference put in the program's place at the precision below the
configuration's (fp8 for bf16; ``control``); with ``--faults`` the same
numbers under each fault that the traffic kind plants in the reference
(``faults``: half of each batch left out in training, greedy decoding in
place of a beam search).
One JSON line a seed. It runs on the card; the benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from capbench import check as checks, core  # noqa: E402
from capbench.run import Ctx, toy  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    core.fix_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = core.workload(args.workload)
    cfg = core.config(cell["config"])
    if args.rehearse:
        cfg = toy(cfg)
    kind = core.traffic(cell["traffic"])
    for seed in args.seeds:
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0,
                                rehearse=args.rehearse, rate=None)
        ctx = Ctx(ns, cell, cfg)
        t0 = time.perf_counter()
        st = kind.setup(ctx)
        out = kind.window(ctx, st)
        kind.release(ctx, st)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        line = {"seed": seed, "metrics": out["metrics"],
                "failed": out["failed"],
                "program": kind.check(ctx, st, out)}
        if args.control:
            line["control"] = kind.check(ctx, st, out, control=True)
        if args.faults:
            for fault in kind.faults(ctx):
                line[fault] = kind.check(ctx, st, out, fault=fault)
        if args.faults and hasattr(kind, "reference"):
            want = kind.reference(ctx, st)
            moved = checks.moved_leaves(want["first_grad"])
            diffs = checks.leaf_diffs(st.prog["first_grad"],
                                      want["first_grad"], moved)
            line["worst_leaves"] = sorted(diffs.items(),
                                          key=lambda kv: -kv[1])[:4]
        line["info"] = {k: ctx.info.get(k) for k in
                        ("caption_lengths", "check_sample", "check_losses",
                         "end_check_losses", "beam_sample")
                        if k in ctx.info}
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
