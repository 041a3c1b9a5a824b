"""Compositional quality gate of the port: a synthetic benchmark that can
fail (port of the repository's ``scripts/compositional_gate.py``).

    python -m mit_tpu_torch.tools.compositional_gate [workdir] [--epochs N] \
        [--per_combo N] [--tolerance T] [--skip_train] [--no_negative_control]

Without ``workdir`` the gate works in a new directory under ``$TMPDIR``
(``tempfile.mkdtemp``) and prints its path; ``--skip_train`` needs the
``workdir`` of an earlier run, whose corpus and checkpoints it reuses.

- **160 classes**: 8 colours x 5 shapes x 4 quadrants, captioned
  "a {color} {shape} in the {position}", rendered as JPEGs (Pillow,
  quality 92) on a constant mid-grey background.
- **Compositional held-out split**: 32 combinations (drawn by
  ``default_rng(7)``) never appear in training, though every single colour,
  shape and position does.
- **Frozen random-init encoder** (the config's default model): the CLS
  feature carries colour easily and shape and position less so, so the
  held-out BLEU-4 lands below 1.0 and a change that degrades captions
  moves it.

It trains through ``python -m mit_tpu_torch.train.cli`` (the JAX gate's
flags, plus ``--no_hf_upload``: the run contacts no host), picks the
best-val checkpoint by its filename, copies the training tokenizer into the
held-out directory, and evaluates through ``python -m
mit_tpu_torch.tools.evaluate``: the training split's val part, the held-out
set in float and in int8, and the ``int8_defect`` canary (int8 with every
fc2 scale doubled), which the gate's own rule must reject. The float arm
runs in f32, as ``load_captioner``'s default, though its key keeps the JAX
gate's name ``heldout_bleu4_bf16``. ``MIT_FUSED_DECODE=1`` in the
environment reaches the evaluations. The JSON line goes to stdout and to
``<workdir>/compositional_gate.json``; the exit code is 0 when ``ok``.
The train CLI runs on a CUDA device only, so the gate does too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

COLORS = {
    "red": (220, 30, 30), "green": (30, 200, 30), "blue": (40, 40, 220),
    "yellow": (230, 230, 30), "purple": (160, 40, 200),
    "orange": (240, 140, 20), "white": (235, 235, 235), "black": (25, 25, 25),
}
SHAPES = ("square", "circle", "triangle", "cross", "ring")
POSITIONS = {
    "top left": (56, 56), "top right": (56, 168),
    "bottom left": (168, 56), "bottom right": (168, 168),
}
HELD_OUT = 32                   # combinations kept out of training
SATURATED = 0.995               # a held-out BLEU-4 at or above: cannot fail
LEARNED = 0.5                   # the train-val BLEU-4 a model must exceed
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def shape_mask(shape: str, cy: int, cx: int, s: int) -> np.ndarray:
    yy, xx = np.mgrid[0:224, 0:224]
    dy, dx = yy - cy, xx - cx
    if shape == "square":
        return (np.abs(dy) < s) & (np.abs(dx) < s)
    if shape == "circle":
        return dy * dy + dx * dx < s * s
    if shape == "triangle":
        return (dy >= -s) & (dy <= s) & (np.abs(dx) <= (dy + s) / 2)
    if shape == "cross":
        return ((np.abs(dx) < s // 3) & (np.abs(dy) < s)) | (
            (np.abs(dy) < s // 3) & (np.abs(dx) < s)
        )
    if shape == "ring":
        d2 = dy * dy + dx * dx
        return (d2 < s * s) & (d2 > (s // 2) * (s // 2))
    raise ValueError(shape)


def render(rng, color_rgb, shape, pos_yx) -> np.ndarray:
    """One 224 x 224 RGB image: a shape of a jittered colour, size and
    centre on a constant grey (a noisy background hid position and shape
    from the frozen random CLS feature)."""
    img = np.full((224, 224, 3), 127, np.uint8)
    cy = int(pos_yx[0] + rng.integers(-12, 13))
    cx = int(pos_yx[1] + rng.integers(-12, 13))
    s = int(rng.integers(48, 64))
    m = shape_mask(shape, cy, cx, s)
    jitter = np.clip(
        np.asarray(color_rgb, np.int16) + rng.integers(-20, 21, 3), 0, 255
    ).astype(np.uint8)
    img[m] = jitter
    return img


def write_split(dirpath, combos, per_combo, rng):
    """``per_combo`` JPEGs of each combination under ``dirpath/images`` and
    their captions in ``dirpath/captions.json``; returns the image count."""
    from PIL import Image

    os.makedirs(os.path.join(dirpath, "images"), exist_ok=True)
    caps = {}
    for color, shape, pos in combos:
        for i in range(per_combo):
            name = f"{color}_{shape}_{pos.replace(' ', '-')}_{i:02d}.jpg"
            Image.fromarray(
                render(rng, COLORS[color], shape, POSITIONS[pos])
            ).save(os.path.join(dirpath, "images", name), quality=92)
            caps[name] = [f"a {color} {shape} in the {pos}"]
    with open(os.path.join(dirpath, "captions.json"), "w") as f:
        json.dump(caps, f)
    return len(caps)


def split_combos():
    """(seen, held-out) combinations: 32 of the 160 drawn by
    ``default_rng(7)``, every attribute value still seen in training."""
    combos = [(c, s, p) for c in COLORS for s in SHAPES for p in POSITIONS]
    rng = np.random.default_rng(7)
    held_idx = set(rng.choice(len(combos), size=HELD_OUT,
                              replace=False).tolist())
    held = [c for i, c in enumerate(combos) if i in held_idx]
    seen = [c for i, c in enumerate(combos) if i not in held_idx]
    for vals, pick in ((COLORS, 0), (SHAPES, 1), (POSITIONS, 2)):
        missing = set(vals) - {c[pick] for c in seen}
        assert not missing, f"training split lost attribute values {missing}"
    return seen, held


def val_of(path: str) -> float:
    """The val loss in a checkpoint's filename (inf where there is none)."""
    stem = os.path.basename(path).rsplit(".safetensors", 1)[0]
    try:
        return float(stem.rsplit("val_loss_", 1)[1])
    except (IndexError, ValueError):
        return float("inf")


def best_checkpoint(data_dir: str) -> str:
    """The run's checkpoint of least val loss by its filename (the last
    epoch also saves, and the newest file is not the best)."""
    found = glob.glob(os.path.join(data_dir, "*.safetensors"))
    if not found:
        raise RuntimeError(f"no checkpoint in {data_dir}")
    return min(found, key=val_of)


def verdict(r_train: dict, r_bf16: dict, r_int8: dict, r_canary, tolerance):
    """The gate's scores and its rule, from the evaluations' JSON: the
    int8 arm within ``tolerance`` BLEU-4 of the float arm on the held-out
    set, a held-out float score below saturation, a train-val score above
    the learned floor, and (``r_canary`` not None) the canary outside the
    tolerance. Returns the keys of the gate's line, ``ok`` last."""
    gap = abs(r_int8["bleu4"] - r_bf16["bleu4"])
    out = {
        "metric": "compositional_gate",
        "train_val_bleu4": r_train["bleu4"],
        "heldout_bleu4_bf16": r_bf16["bleu4"],
        "heldout_bleu4_int8": r_int8["bleu4"],
        "heldout_cider_bf16": r_bf16.get("cider_d"),
        "heldout_cider_int8": r_int8.get("cider_d"),
        "int8_bf16_bleu_gap": round(gap, 4),
        "tolerance": tolerance,
        "non_saturating": r_bf16["bleu4"] < SATURATED,
        "learned": r_train["bleu4"] > LEARNED,
        "learned_floor_margin": round(r_train["bleu4"] - LEARNED, 4),
    }
    if r_canary is not None:
        canary_gap = abs(r_canary["bleu4"] - r_bf16["bleu4"])
        out["canary_bleu4_int8_defect"] = r_canary["bleu4"]
        out["canary_gap"] = round(canary_gap, 4)
        out["canary_trips"] = bool(canary_gap > tolerance)
    out["ok"] = bool(
        gap <= tolerance
        and out["non_saturating"]            # the gate can fail
        and out["learned"]                   # and the model did learn
        and out.get("canary_trips", True)    # and the gate itself works
    )
    return out


def run_json(*cli):
    """Run ``python -m <cli>`` from the repository root; the last JSON line
    of its stdout."""
    out = subprocess.run([sys.executable, "-m", *cli], cwd=REPO, check=True,
                         stdout=subprocess.PIPE, text=True,
                         env=offline_env()).stdout
    for line in reversed(out.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise RuntimeError(f"no JSON line in the output of {cli[0]}")


def offline_env() -> dict:
    """The environment of the subprocesses: the HF Hub client offline."""
    return dict(os.environ, HF_HUB_OFFLINE="1")


def train(data_dir: str, epochs: int) -> None:
    """The gate's training run through the port's train CLI."""
    subprocess.run(
        [sys.executable, "-m", "mit_tpu_torch.train.cli", "--data_dir",
         data_dir, "--epochs", str(epochs), "--batch_size", "32",
         "--learning_rate", "3e-4", "--no_prepare", "--no_wandb",
         "--train_state_interval", "100", "--no_hf_upload"],
        cwd=REPO, check=True, env=offline_env(),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None,
                    help="where the corpus, checkpoints and result go "
                    "(default: a new directory under $TMPDIR)")
    ap.add_argument("--epochs", type=int, default=60,
                    help="the best-val checkpoint is evaluated, so more "
                    "epochs are safe")
    ap.add_argument("--per_combo", type=int, default=8,
                    help="training images per seen combination (held-out "
                    "stays at 3 a combination)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="max |BLEU4(int8) - BLEU4(float)| on the held-out set")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the checkpoints already in workdir")
    ap.add_argument("--no_negative_control", action="store_true",
                    help="skip the canary evaluation (int8 with every fc2 "
                    "scale doubled) that must trip the gate")
    args = ap.parse_args(argv)
    if args.workdir is None:
        if args.skip_train:
            ap.error("--skip_train needs the workdir of an earlier run")
        args.workdir = tempfile.mkdtemp(prefix="compositional_gate_")
    print(f"workdir: {args.workdir}", file=sys.stderr)

    train_dir = os.path.join(args.workdir, "train", "")
    held_dir = os.path.join(args.workdir, "heldout", "")
    seen, held = split_combos()
    if args.skip_train:
        if not glob.glob(os.path.join(train_dir, "*.safetensors")):
            raise SystemExit(f"--skip_train: no checkpoint in {train_dir}; "
                             "run the gate without it first")
    else:
        n_tr = write_split(train_dir, seen, args.per_combo,
                           np.random.default_rng(1))
        n_ho = write_split(held_dir, held, 3, np.random.default_rng(2))
        print(f"dataset: {n_tr} train images ({len(seen)} combos), "
              f"{n_ho} held-out ({len(held)} combos)", file=sys.stderr)
        train(train_dir, args.epochs)
    ckpt = best_checkpoint(train_dir)
    # the evaluations read the tokenizer of --data_dir: the held-out set
    # must read the training tokenizer
    for tf in ("vocab.json", "merges.txt"):
        src = os.path.join(train_dir, tf)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(held_dir, tf))

    # the held-out directory holds only held-out combinations: --split all
    ev = lambda data, quant, split: run_json(
        "mit_tpu_torch.tools.evaluate", "--checkpoint_path", ckpt,
        "--data_dir", data, "--split", split, "--encoder_quant", quant)
    r_train = ev(train_dir, "none", "val")
    r_bf16 = ev(held_dir, "none", "all")
    r_int8 = ev(held_dir, "int8", "all")
    r_canary = (None if args.no_negative_control
                else ev(held_dir, "int8_defect", "all"))
    out = verdict(r_train, r_bf16, r_int8, r_canary, args.tolerance)
    # the JAX gate's order: the run's settings before the canary and ok
    scores = {k: out.pop(k) for k in list(out)
              if not k.startswith("canary") and k != "ok"}
    out = {**scores, "epochs": args.epochs, "per_combo": args.per_combo,
           "checkpoint": os.path.basename(ckpt), **out}
    ok = out["ok"]
    line = json.dumps(out)
    print(line)
    with open(os.path.join(args.workdir, "compositional_gate.json"), "w") as f:
        f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
