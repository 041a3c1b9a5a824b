"""Evaluate a checkpoint: BLEU-4 and CIDEr-D over a split (port of the
repository's ``evaluate.py``).

    python -m mit_tpu_torch.tools.evaluate --checkpoint_path ckpt.safetensors \
        [--data_dir D] [--limit N] [--method greedy|beam] [--batch_size B] \
        [--split val|train|all] [--encoder_quant none|int8|int8_defect] \
        [--device cuda]

The captioner runs in f32 (``load_captioner``'s default), the tokenizer
comes from ``--data_dir``, and the split is the training loop's
(``TRAIN_SPLIT_RATIO``, ``RANDOM_SEED``). ``MIT_FUSED_DECODE=1`` decodes
with the fused decode-layer kernel, as in the JAX package. Prints one JSON
line: split, method, encoder_quant, bleu4, cider_d, num_images and
mean_caption_len. ``--device`` is a CUDA device unless ``cpu`` is asked
for; without CUDA a CUDA device raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def evaluate_checkpoint(checkpoint_path, cfg, *, split="val",
                        method="greedy", batch_size=32, limit=0,
                        encoder_quant="none", device="cuda") -> dict:
    """BLEU-4 and CIDEr-D of ``checkpoint_path`` over ``split`` of the
    corpus of ``cfg.DATA_DIR``, split as the training loop splits it at
    ``cfg.RANDOM_SEED``; the dict of ``evaluate_captioner``."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to "
                           "evaluate on the CPU")

    from mit_tpu_torch.data.dataset import ImageTextDataset, split_indices
    from mit_tpu_torch.decode.api import load_captioner
    from mit_tpu_torch.eval.bleu import evaluate_captioner

    captioner = load_captioner(
        checkpoint_path, cfg, device=device, encoder_quant=encoder_quant,
        fused_decode=os.environ.get("MIT_FUSED_DECODE") == "1")
    cfg = cfg.with_tokenizer_ids(captioner.tokenizer)
    # paths and captions only: no pixel goes through the dataset here
    dataset = ImageTextDataset(
        cfg.IMAGE_DIR, cfg.CAPTIONS_FILE, cfg.MAX_SEQ_LEN,
        captioner.tokenizer, cfg.ENCODER_MODEL_NAME, use_native_loader=False,
    )
    tr, va = split_indices(len(dataset), cfg.TRAIN_SPLIT_RATIO, cfg.RANDOM_SEED)
    idx = {"val": va, "train": tr, "all": range(len(dataset))}[split]
    paths = [dataset.image_paths[i] for i in idx]
    refs = {}
    for i in idx:
        refs.setdefault(dataset.image_paths[i], []).append(dataset.captions[i])
    return evaluate_captioner(captioner, paths, refs, batch_size=batch_size,
                              method=method, max_images=limit)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="BLEU-4 caption evaluation.")
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--limit", type=int, default=0,
                        help="Max unique images to evaluate (0 = all).")
    parser.add_argument("--method", type=str, default="greedy",
                        choices=["greedy", "beam"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--split", type=str, default="val",
                        choices=["val", "train", "all"])
    parser.add_argument("--encoder_quant", type=str, default="none",
                        choices=["none", "int8", "int8_defect"],
                        help="int8 = W8A8-quantize the frozen encoder at "
                        "load. int8_defect = int8 with every fc2 scale "
                        "doubled: the quality gate's negative control, "
                        "never a serving configuration.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on (default: cuda; cpu only "
                        "when asked).")
    args = parser.parse_args(argv)

    from mit_tpu_torch.config import CONFIG

    cfg = CONFIG if args.data_dir is None else CONFIG.replace(DATA_DIR=args.data_dir)
    if not os.path.exists(args.checkpoint_path):
        print(f"Checkpoint not found: {args.checkpoint_path}", file=sys.stderr)
        return 1
    result = evaluate_checkpoint(
        args.checkpoint_path, cfg, split=args.split, method=args.method,
        batch_size=args.batch_size, limit=args.limit,
        encoder_quant=args.encoder_quant, device=args.device)
    print(json.dumps({"split": args.split, "method": args.method,
                      "encoder_quant": args.encoder_quant, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
