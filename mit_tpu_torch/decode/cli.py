"""Captioning CLI on the GPU (port of ``mit_tpu/decode/cli.py``, greedy).

    python -m mit_tpu_torch.decode.cli --image_path img.jpg [more.jpg ...] \
        [--checkpoint_path ckpt.safetensors] [--data_dir DIR] [--device cuda] \
        [--encoder_quant {none,int8}]

Runs on a CUDA device only: without one it raises instead of running on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate text for an image using a trained model (GPU)."
    )
    parser.add_argument(
        "--image_path", type=str, required=True, nargs="+",
        help="Path(s) to the input image file(s).",
    )
    parser.add_argument(
        "--checkpoint_path", type=str, default=None,
        help="Path to the .safetensors model checkpoint file.",
    )
    parser.add_argument(
        "--data_dir", type=str, default=None,
        help="Override config DATA_DIR (tokenizer/checkpoint location).",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="CUDA device to run on (default: cuda).",
    )
    parser.add_argument(
        "--encoder_quant", type=str, default="none", choices=["none", "int8"],
        help="Quantize the frozen encoder's GEMMs to int8 (W8A8) at load.",
    )
    args = parser.parse_args(argv)

    import torch

    if torch.device(args.device).type != "cuda":
        parser.error(f"--device must be a CUDA device, got {args.device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this CLI runs on the GPU only")

    from mit_tpu.config import CONFIG

    cfg = CONFIG if args.data_dir is None else CONFIG.replace(DATA_DIR=args.data_dir)

    for p in args.image_path:
        if not os.path.exists(p):
            print(f"Image file not found: {p}", file=sys.stderr)
            return 1

    ckpt_path = args.checkpoint_path
    if ckpt_path is None:
        # the newest checkpoint in OUTPUT_DIR
        cands = [
            os.path.join(cfg.OUTPUT_DIR, f)
            for f in os.listdir(cfg.OUTPUT_DIR)
            if f.endswith(".safetensors")
        ] if os.path.isdir(cfg.OUTPUT_DIR) else []
        if not cands:
            print("No checkpoint found; pass --checkpoint_path.", file=sys.stderr)
            return 1
        ckpt_path = max(cands, key=os.path.getmtime)
    if not os.path.exists(ckpt_path):
        print(f"Checkpoint file not found: {ckpt_path}", file=sys.stderr)
        return 1

    # Tokenizer files must accompany the model; if the configured DATA_DIR
    # lacks them, fall back to the checkpoint's own directory.
    if args.data_dir is None and not os.path.exists(cfg.VOCAB_PATH):
        ckpt_dir = os.path.dirname(os.path.abspath(ckpt_path))
        if os.path.exists(os.path.join(ckpt_dir, "vocab.json")):
            cfg = cfg.replace(DATA_DIR=ckpt_dir + os.sep)

    from PIL import Image

    from mit_tpu_torch.decode.api import load_captioner

    print(f"Loading model from {ckpt_path}...")
    captioner = load_captioner(ckpt_path, cfg, device=args.device,
                               encoder_quant=args.encoder_quant)
    images = [Image.open(p).convert("RGB") for p in args.image_path]
    print("Generating text...")
    captions = captioner.caption_batch(images)
    for path, caption in zip(args.image_path, captions):
        print("\n---")
        print(f"Image: {path}")
        print(f"Generated Text: {caption}")
        print("---")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
