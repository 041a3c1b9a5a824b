"""Training CLI on the GPU (port of ``mit_tpu/train/cli.py``).

    python -m mit_tpu_torch.train.cli [--data_dir DIR] [--epochs N] \
        [--batch_size B] [--learning_rate LR] [--resume DIR] [--no_prepare] \
        [--no_wandb] [--no_cache] [--encoder_quant {none,int8}] \
        [--train_state_interval N] [--device cuda]

Flags override the values of ``mit_tpu_torch.config``. ``MIT_FUSED_DROPOUT=1``
sends the decoder self-attention's dropout through the hash-mask CUDA
kernels (the JAX package's switch of the same name); it is read here, once.
Runs on a CUDA device only: without one it raises instead of training on
the CPU. ``--mesh`` other than ``1,1`` is not ported and raises.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Train the image-captioning model (GPU).")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--encoder", type=str, default=None,
                        help="Encoder model name (config ENCODER_MODEL_NAME).")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="Train-state checkpoint dir to resume from.")
    parser.add_argument("--no_prepare", action="store_true",
                        help="Skip the Flickr30k auto-prepare step.")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--no_cache", action="store_true",
                        help="Disable the frozen-encoder feature cache.")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Device mesh 'data,model'; only '1,1' is ported.")
    parser.add_argument("--encoder_quant", type=str, default=None,
                        choices=["none", "int8"],
                        help="int8 = W8A8-quantize the frozen encoder for "
                        "the training compute path (checkpoints keep float "
                        "weights).")
    parser.add_argument("--train_state_interval", type=int, default=None,
                        help="Save the resume state every Nth epoch "
                        "(weights still save on every best-val; final epoch "
                        "always saves).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="CUDA device to train on (default: cuda).")
    args = parser.parse_args(argv)

    import torch

    if torch.device(args.device).type != "cuda":
        parser.error(f"--device must be a CUDA device, got {args.device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this CLI runs on the GPU only")
    fused_dropout = os.environ.get("MIT_FUSED_DROPOUT") == "1"

    from mit_tpu_torch.config import CONFIG

    cfg = CONFIG
    if args.data_dir:
        cfg = cfg.replace(DATA_DIR=args.data_dir)
    if args.encoder:
        cfg = cfg.replace(ENCODER_MODEL_NAME=args.encoder,
                          IMAGE_PROCESSOR_NAME=args.encoder)
    if args.epochs is not None:
        cfg = cfg.replace(NUM_EPOCHS=args.epochs)
    if args.batch_size is not None:
        cfg = cfg.replace(BATCH_SIZE=args.batch_size)
    if args.learning_rate is not None:
        cfg = cfg.replace(LEARNING_RATE=args.learning_rate)
    if args.resume:
        cfg = cfg.replace(RESUME_CHECKPOINT_PATH=args.resume)
    if args.no_cache:
        cfg = cfg.replace(CACHE_ENCODER_FEATURES=False)
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        cfg = cfg.replace(MESH_SHAPE=(d, m))
    if args.encoder_quant:
        cfg = cfg.replace(ENCODER_QUANT=args.encoder_quant)
    if args.train_state_interval is not None:
        cfg = cfg.replace(TRAIN_STATE_INTERVAL=args.train_state_interval)

    from mit_tpu_torch.train.loop import train

    summary = train(cfg, auto_prepare=not args.no_prepare,
                    wandb_enabled=not args.no_wandb, device=args.device,
                    fused_dropout=fused_dropout)
    print(f"Training finished. Best val loss: {summary['best_val_loss']:.4f}")
    if summary.get("best_checkpoint"):
        print(f"Best checkpoint: {summary['best_checkpoint']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
