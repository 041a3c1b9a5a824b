"""How a configuration's captions come out long, seed by seed.

    python3 capbench/calibrate.py <config> --seeds 1 2 3 --images 128

Random weights never put END first, so a run raises END's logit bias by a
margin calibrated for its seed's weights (``inputs.end_margin``): greedy
decoding picks the same tokens whatever the margin is until the step where
END first wins, so one float32 greedy run of the reference with END held
out gives, at every step, the gap by which END trails the best other
token, and a caption ends at the first step whose gap is under the margin.
For each seed this prints the calibrated margin and the lengths it gives
on ``--images`` other images made from the seed: their mean, quartiles,
90th percentile, how many reach ``max_len``, and the longest caption of
each batch of ``--batch``; with ``--margins``, the same lengths at each of
those fixed margins, so that a margin shared by every seed can be judged.
It runs on the card (``--device cpu`` for a toy check).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from capbench import arith, core  # noqa: E402
from capbench.inputs import end_gaps, end_margin, lengths_at, make_images, \
    make_weights  # noqa: E402
from capbench.reference import model as ref  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--images", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--margins", type=float, nargs="*", default=[])
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = core.config(args.config)
    device = torch.device(args.device)
    for s in args.seeds:
        w = make_weights(cfg, s, device)
        m = end_margin(cfg, w, s, device)
        imgs = make_images(args.images, cfg["assumed"]["image_hw"], s + 1,
                           device)
        gaps = end_gaps(cfg, w, imgs)
        ln = lengths_at(gaps, m).int().tolist()
        fixed = {str(f): arith.length_summary(lengths_at(gaps, f).int()
                                              .tolist())
                 for f in args.margins}
        mem = ref.memory_of(w, cfg, imgs)
        spread = float((mem - mem.mean(0)).norm() / mem.norm())
        print(json.dumps({
            "config": args.config, "seed": s, "margin": m,
            "lengths": arith.length_summary(ln),
            "at_max_len": sum(x >= cfg["decoder"]["max_seq_len"] for x in ln),
            "memory_spread": spread,
            "batch_max": [max(ln[i:i + args.batch])
                          for i in range(0, len(ln), args.batch)],
            "at_fixed_margins": fixed}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
