"""Which model draws survive the compositional gate's training recipe: train
the gate's training split at several ``RANDOM_SEED``s and score each draw.

    python -m mit_tpu_torch.tools.gate_draws [workdir] [--seeds 0 1 2 3 7 42]

The corpus is the gate's own (``compositional_gate.write_split`` of the seen
combinations, same seeds, 8 images each), written once under
``<workdir>/corpus``. Each seed trains in ``<workdir>/seed_<s>`` (the
images linked, the captions copied) on the card for 12 epochs with the
gate's flags (batch 32, learning rate 3e-4, no HF Hub upload) and the
config's default model, so the seed draws the frozen encoder, the decoder,
the split and the batch order. Its best-val checkpoint (by filename, as
the gate picks it; the run's other saves are deleted once it is scored) is
scored on that seed's val split: greedy BLEU-4 and CIDEr-D, in f32. A draw
has ``learned`` when its BLEU-4 is over the gate's floor
(``compositional_gate.LEARNED``); a draw that collapsed gives every image
the same few tokens and scores 0.

Prints one JSON line a seed and a summary line last, also written to
``<workdir>/gate_draws.json``. Without ``workdir`` it works in a new
directory under ``$TMPDIR``. ``MIT_FUSED_DROPOUT=1`` reaches ``train()``.
``tests/test_torch_gate_draws.py``, run as a script, sweeps the JAX
package's loop over the same seeds and corpus on the CPU and prints the
same lines.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from mit_tpu_torch.tools import compositional_gate as gate

SEEDS = (0, 1, 2, 3, 7, 42)
EPOCHS = 12                     # the gate trains 60; a collapse shows by 12
PER_COMBO = 8                   # the gate's default


def write_corpus(workdir: str, per_combo: int) -> str:
    """The gate's training split under ``<workdir>/corpus`` (written once);
    returns its directory."""
    corpus = os.path.join(workdir, "corpus", "")
    if not os.path.exists(os.path.join(corpus, "captions.json")):
        seen, _ = gate.split_combos()
        gate.write_split(corpus, seen, per_combo, np.random.default_rng(1))
    return corpus


def seed_dir(workdir: str, corpus: str, seed: int) -> str:
    """A fresh data directory for ``seed`` over the shared corpus: the
    images linked, the captions copied; the run's tokenizer and checkpoints
    go there."""
    d = os.path.join(workdir, f"seed_{seed}", "")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    os.symlink(os.path.join(corpus, "images"), os.path.join(d, "images"))
    shutil.copy(os.path.join(corpus, "captions.json"), d)
    return d


def recipe(cfg, data_dir: str, seed: int, epochs: int):
    """The gate's training flags on ``cfg`` at ``seed``."""
    return cfg.replace(DATA_DIR=data_dir, RANDOM_SEED=seed,
                       NUM_EPOCHS=epochs, BATCH_SIZE=32, LEARNING_RATE=3e-4,
                       TRAIN_STATE_INTERVAL=100,
                       HF_UPLOAD_BEST_CHECKPOINTS=False)


def keep_only(data_dir: str, ckpt: str) -> None:
    """Delete a scored run's other checkpoints and its resume state (about
    0.45 GB a save at the default model), keeping ``ckpt``."""
    for path in glob.glob(os.path.join(data_dir, "*.safetensors")):
        if path != ckpt:
            os.remove(path)
    shutil.rmtree(os.path.join(data_dir, "latest"), ignore_errors=True)


def draw_line(package: str, seed: int, ckpt: str, scores: dict) -> dict:
    """One seed's JSON line."""
    return {"package": package, "seed": seed,
            "best_val_loss": gate.val_of(ckpt),
            "train_val_bleu4": scores["bleu4"],
            "train_val_cider_d": scores["cider_d"],
            "mean_caption_len": scores["mean_caption_len"],
            "learned": scores["bleu4"] > gate.LEARNED}


def summary_line(package: str, lines: list, epochs: int,
                 per_combo: int) -> dict:
    """The sweep's last line: every seed's BLEU-4 and how many collapsed."""
    return {"metric": "gate_draws", "package": package, "epochs": epochs,
            "per_combo": per_combo, "seeds": [r["seed"] for r in lines],
            "train_val_bleu4": [r["train_val_bleu4"] for r in lines],
            "not_learned": sum(not r["learned"] for r in lines)}


def sweep(workdir: str, seeds=SEEDS, epochs: int = EPOCHS,
          per_combo: int = PER_COMBO, device: str = "cuda", cfg=None) -> list:
    """Train and score each seed with the port; the lines it printed."""
    from mit_tpu_torch.config import CONFIG
    from mit_tpu_torch.tools.evaluate import evaluate_checkpoint
    from mit_tpu_torch.train.loop import train

    cfg = CONFIG if cfg is None else cfg
    corpus = write_corpus(workdir, per_combo)
    lines = []
    for seed in seeds:
        run_cfg = recipe(cfg, seed_dir(workdir, corpus, seed), seed, epochs)
        train(run_cfg, auto_prepare=False, wandb_enabled=False, device=device)
        ckpt = gate.best_checkpoint(run_cfg.DATA_DIR)
        lines.append(draw_line("mit_tpu_torch", seed, ckpt,
                               evaluate_checkpoint(ckpt, run_cfg,
                                                   device=device)))
        keep_only(run_cfg.DATA_DIR, ckpt)
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None,
                    help="default: a new directory under $TMPDIR")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="gate_draws_")
    print(f"workdir: {workdir}", file=sys.stderr)
    # as the gate runs its trainings: the HF Hub client offline
    os.environ["HF_HUB_OFFLINE"] = "1"
    lines = sweep(workdir, args.seeds)
    out = json.dumps(summary_line("mit_tpu_torch", lines, EPOCHS, PER_COMBO))
    print(out)
    with open(os.path.join(workdir, "gate_draws.json"), "w") as f:
        f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
