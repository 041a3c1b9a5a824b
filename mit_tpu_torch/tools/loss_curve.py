"""The training loss curve beside the reference's (port of the repository's
``scripts/loss_curve.py``).

    python -m mit_tpu_torch.tools.loss_curve [--data_dir D] [--epochs 10] \
        [--batch_size 32] [--output loss_curve.json] [--fixture_dir DIR] \
        [--fixture_images 400] [--device cuda]

The reference's one quantitative training record is the val cross-entropy
in its checkpoint filenames, 3.0019 → 2.5425 over 10 epochs of Flickr30k
with ViT-B/16 (:data:`REFERENCE_CURVE`). This tool trains with the
reference's hyperparameters (the config's defaults; only epochs and batch
come from the flags) through the port's ``train()`` and records the curve:

- **REAL**: ``--data_dir`` holds a prepared Flickr30k (``images/`` and
  ``captions.json``). Nothing here downloads it, so this mode waits until a
  prepared copy is on the machine.
- **FIXTURE**: otherwise a deterministic mini-Flickr stand-in is written
  (:func:`fabricate_mini_flickr`, the JAX script's images and captions
  byte for byte) to ``--fixture_dir`` (default: a new directory under
  ``$TMPDIR``) and trained on; its values do not compare with Flickr30k's.

Writes ``{mode, data_dir, epochs: [{epoch, train_loss, val_loss}],
reference_val_curve, reference_source}`` to ``--output`` and prints the two
curves side by side. Trains on a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REFERENCE_CURVE = [
    3.0019, 2.8036, 2.7074, 2.6526, 2.6176,
    2.5925, 2.5645, 2.5563, 2.5503, 2.5425,
]  # reference run_batch_test.sh:7-16 (ViT-B/16 run)
REFERENCE_SOURCE = "reference run_batch_test.sh:7-16"


def fabricate_mini_flickr(root: str, n_images: int = 400, caps_per: int = 5):
    """Scenes of one coloured shape with template captions, from a fixed
    seed: learnable structure and long-tail filler words, so the val curve
    falls smoothly as on real captions."""
    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(1234)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    colors = {
        "red": (220, 40, 40), "blue": (40, 70, 220), "green": (40, 180, 60),
        "yellow": (230, 210, 40), "purple": (150, 50, 190),
        "orange": (240, 140, 30), "white": (240, 240, 240),
        "black": (25, 25, 25),
    }
    shapes = ["circle", "square", "triangle"]
    sizes = ["small", "large"]
    positions = ["left", "right", "top", "bottom"]
    fillers = ["bright", "plain", "shiny", "dark", "odd", "nice", "big",
               "tiny", "round", "flat"]
    captions = {}
    for i in range(n_images):
        color = rng.choice(list(colors))
        shape = rng.choice(shapes)
        size = rng.choice(sizes)
        pos = rng.choice(positions)
        img = Image.new("RGB", (224, 224),
                        tuple(int(x) for x in rng.integers(90, 150, 3)))
        d = ImageDraw.Draw(img)
        r = 40 if size == "small" else 75
        cx = {"left": 60, "right": 164, "top": 112, "bottom": 112}[pos]
        cy = {"left": 112, "right": 112, "top": 60, "bottom": 164}[pos]
        box = (cx - r, cy - r, cx + r, cy + r)
        if shape == "circle":
            d.ellipse(box, fill=colors[color])
        elif shape == "square":
            d.rectangle(box, fill=colors[color])
        else:
            d.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)],
                      fill=colors[color])
        name = f"mini_{i:05d}.jpg"
        img.save(os.path.join(img_dir, name), quality=92)
        caps = []
        for _ in range(caps_per):
            extra = rng.choice(fillers)
            template = rng.integers(0, 3)
            if template == 0:
                c = f"a {size} {color} {shape} on the {pos} side"
            elif template == 1:
                c = f"the {extra} {color} {shape} sits at the {pos}"
            else:
                c = f"a {extra} {size} {shape} colored {color}"
            caps.append(c)
        captions[name] = caps
    with open(os.path.join(root, "captions.json"), "w") as f:
        json.dump(captions, f)


def curve_record(summary: dict, mode: str, data_dir: str) -> dict:
    """The output JSON of a ``train()`` summary."""
    curve = [
        {"epoch": e["epoch"], "train_loss": round(e["train_loss"], 4),
         "val_loss": round(e.get("val_loss", float("nan")), 4)}
        for e in summary["epochs"]
    ]
    return {"mode": mode, "data_dir": data_dir, "epochs": curve,
            "reference_val_curve": REFERENCE_CURVE,
            "reference_source": REFERENCE_SOURCE}


def table(curve: list) -> str:
    """Our val CE beside the reference's, an epoch a line."""
    lines = [f"{'epoch':>5} {'val CE (ours)':>14} {'val CE (reference)':>19}"]
    for i, e in enumerate(curve):
        ref = REFERENCE_CURVE[i] if i < len(REFERENCE_CURVE) else float("nan")
        lines.append(f"{e['epoch']:>5} {e['val_loss']:>14.4f} {ref:>19.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=None,
                    help="Prepared Flickr30k dir (images/ + captions.json). "
                         "Absent/unprepared -> deterministic mini fixture.")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--output", default="loss_curve.json")
    ap.add_argument("--fixture_dir", default=None,
                    help="default: a new directory under $TMPDIR")
    ap.add_argument("--fixture_images", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; cpu only when asked")
    args = ap.parse_args(argv)

    from mit_tpu_torch.config import Config
    from mit_tpu_torch.data.prepare import check_dataset_exists
    from mit_tpu_torch.train.loop import train

    mode, data_dir = "real", args.data_dir
    if data_dir is None or not check_dataset_exists(Config(DATA_DIR=data_dir)):
        mode = "fixture"
        data_dir = args.fixture_dir or tempfile.mkdtemp(prefix="mini_flickr_")
        if not check_dataset_exists(Config(DATA_DIR=data_dir)):
            print(f"Fabricating deterministic mini-Flickr at {data_dir} ...")
            fabricate_mini_flickr(data_dir, args.fixture_images)
        print("NOTE: running in FIXTURE mode (no prepared Flickr30k); rerun "
              "with --data_dir <prepared_flickr30k> for the parity anchor.")

    # the reference's hyperparameters: only epochs and batch from the flags
    cfg = Config(DATA_DIR=data_dir, NUM_EPOCHS=args.epochs,
                 BATCH_SIZE=args.batch_size, VALIDATION_INTERVAL=1,
                 HF_UPLOAD_BEST_CHECKPOINTS=False)
    summary = train(cfg, auto_prepare=False, wandb_enabled=False,
                    device=args.device)
    out = curve_record(summary, mode, data_dir)
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print("\n" + table(out["epochs"]))
    print(f"\nCurve written to {args.output} (mode={mode}).")
    if mode == "fixture":
        print("Parity vs the reference curve requires real Flickr30k data.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
