"""Per-attribute diagnosis of the compositional gate (port of the
repository's ``scripts/gate_diagnose.py``).

    python -m mit_tpu_torch.tools.gate_diagnose WORKDIR \
        [--encoder_quant none|int8|int8_defect] [--batch_size 64] \
        [--device cuda]

Captions every image of a gate workdir's ``train/`` and ``heldout/`` splits
with the best-val checkpoint of ``train/`` (greedy, f32, the port's
``load_captioner``), parses the truth from each filename
(``{color}_{shape}_{pos-with-dashes}_{i}.jpg``) and the attributes a
caption mentions, and prints one JSON line: per split the accuracy of
colour, shape, position and of the exact caption, the histogram of caption
lengths in words, and the shape confusions. A draw that never learned
(every caption "a a a ...") shows as accuracies near 0 and one length.

``WORKDIR`` is the gate's (``mit_tpu_torch.tools.compositional_gate``), or
any directory whose ``train/`` holds images, ``captions.json``, the
tokenizer files and checkpoints: a ``gate_draws`` seed directory linked as
``train``. ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter

from mit_tpu_torch.tools.compositional_gate import (
    COLORS,
    POSITIONS,
    SHAPES,
    best_checkpoint,
)


def parse_name(path):
    """(color, shape, position) from an image's filename."""
    stem = os.path.basename(path).rsplit(".", 1)[0]
    color, shape, pos, _ = stem.split("_")
    return color, shape, pos.replace("-", " ")


def parse_pred(caption):
    """The first colour, shape and two-word position a caption mentions
    (None where it mentions none)."""
    toks = caption.lower().split()
    color = next((t for t in toks if t in COLORS), None)
    shape = next((t for t in toks if t in SHAPES), None)
    pos = None
    for i in range(len(toks) - 1):
        cand = f"{toks[i]} {toks[i + 1]}"
        if cand in POSITIONS:
            pos = cand
            break
    return color, shape, pos


def split_report(paths, preds) -> dict:
    """One split's entry of the line from image paths and their captions."""
    acc = {k: 0 for k in ("color", "shape", "position", "exact")}
    confusion = Counter()
    lens = Counter()
    for p, pred in zip(paths, preds):
        gt = parse_name(p)
        pr = parse_pred(pred)
        for k, g, h in zip(("color", "shape", "position"), gt, pr):
            acc[k] += int(g == h)
        acc["exact"] += int(pred.strip().lower()
                            == f"a {gt[0]} {gt[1]} in the {gt[2]}")
        confusion[(gt[1], pr[1] or "<none>")] += 1
        lens[len(pred.split())] += 1
    n = len(paths)
    return {
        "n": n,
        **{k: round(v / n, 4) for k, v in acc.items()},
        "caption_len_hist": dict(sorted(lens.items())),
        "shape_confusion": {
            f"{g}->{h}": c for (g, h), c in sorted(confusion.items())
            if g != h and c > 0},
    }


def diagnose(workdir: str, encoder_quant: str = "none", batch_size: int = 64,
             device: str = "cuda") -> dict:
    """The diagnosis line of ``workdir``'s best-val checkpoint."""
    from PIL import Image

    from mit_tpu_torch.config import CONFIG
    from mit_tpu_torch.decode.api import load_captioner

    train_dir = os.path.join(workdir, "train")
    ckpt = best_checkpoint(train_dir)
    cfg = CONFIG.replace(DATA_DIR=train_dir + "/")
    captioner = load_captioner(ckpt, cfg, device=device,
                               encoder_quant=encoder_quant)
    out = {"metric": "gate_diagnosis", "checkpoint": os.path.basename(ckpt),
           "encoder_quant": encoder_quant}
    for split in ("train", "heldout"):
        paths = sorted(glob.glob(os.path.join(workdir, split, "images",
                                              "*.jpg")))
        if not paths:
            continue
        preds = []
        for i in range(0, len(paths), batch_size):
            images = []
            for p in paths[i:i + batch_size]:
                with Image.open(p) as im:
                    images.append(im.convert("RGB"))
            preds.extend(captioner.caption_batch(images, method="greedy"))
        out[split] = split_report(paths, preds)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--encoder_quant", default="none",
                    choices=["none", "int8", "int8_defect"])
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; cpu only when asked")
    args = ap.parse_args(argv)
    print(json.dumps(diagnose(args.workdir, args.encoder_quant,
                              args.batch_size, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
