"""End-to-end learning sanity of the port: train on a learnable synthetic
dataset and check that the model captions from the image (port of the
repository's ``scripts/color_sanity.py``).

    python -m mit_tpu_torch.tools.color_sanity [workdir]

Without ``workdir`` it works in a new directory under ``$TMPDIR``
(``tempfile.mkdtemp``) and prints its path.

Writes 8 colour classes of 50 noisy 224 x 224 JPEGs each (Pillow, quality
92), captioned "a {color} square on the screen", trains the default ViT-B/16
+ 6-layer decoder through ``python -m mit_tpu_torch.train.cli`` (12 epochs,
batch 32, learning rate 3e-4, no HF Hub upload) and evaluates the newest
checkpoint on the val split through ``python -m
mit_tpu_torch.tools.evaluate``, whose JSON line it prints. A healthy model
reaches BLEU-4 1.0: the frozen random encoder's CLS feature separates the
colours, and the projection and decoder learn to carry it into the caption
(a decoder that ignored the image would stay at the caption entropy,
ln 8). The train CLI runs on a CUDA device only, so this does too.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from mit_tpu_torch.tools.compositional_gate import (
    COLORS, REPO, offline_env, train)


def write_dataset(data: str) -> int:
    """The 400 images and their captions.json under ``data``."""
    from PIL import Image

    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    rng = np.random.default_rng(0)
    caps = {}
    for cname, rgb in COLORS.items():
        for i in range(50):
            base = np.asarray(rgb, np.int16)
            img = np.clip(
                base + rng.integers(-25, 25, (224, 224, 3)), 0, 255
            ).astype(np.uint8)
            name = f"{cname}_{i:02d}.jpg"
            Image.fromarray(img).save(
                os.path.join(data, "images", name), quality=92
            )
            caps[name] = [f"a {cname} square on the screen"]
    with open(os.path.join(data, "captions.json"), "w") as f:
        json.dump(caps, f)
    return len(caps)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    workdir = argv[0] if argv else tempfile.mkdtemp(prefix="color_sanity_")
    data = os.path.join(workdir, "")
    print(f"dataset: {write_dataset(data)} images in {data}")
    # the gate's recipe at 12 epochs (no resume state: a sanity run never
    # resumes)
    train(data, 12)
    ckpt = max(glob.glob(os.path.join(data, "*.safetensors")),
               key=os.path.getmtime)
    subprocess.run(
        [sys.executable, "-m", "mit_tpu_torch.tools.evaluate",
         "--checkpoint_path", ckpt, "--data_dir", data],
        cwd=REPO, check=True, env=offline_env())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
