"""Training orchestration (port of ``mit_tpu/train/loop.py``).

The same flow: prepare the dataset → seed → wandb → train the tokenizer if
its files are missing → load it, take its special ids and vocab size →
dataset and split → model init (or resume) → the frozen-feature cache →
epochs of train steps with periodic validation, best-val safetensors and
the ``latest`` train state, and the optional HF Hub upload.

Not ported, and refused with ``NotImplementedError``: a device mesh other
than (1, 1) (ROADMAP.md, queue 1, multi-GPU) and pretrained encoder
loading (queue 1, pretrained loading); ``PRETRAINED_ENCODER="auto"`` takes
the JAX package's fallback, a random encoder.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mit_tpu_torch.data.dataset import (
    ImageTextDataset,
    Loader,
    prefetch_to_device,
    split_indices,
    to_device,
)
from mit_tpu_torch.models.model import ModelConfig, init_model_params, split_trainable
from mit_tpu_torch.models.vision import quantize_vision_params
from mit_tpu_torch.train import checkpoint as ckpt
from mit_tpu_torch.train.features import (
    FeatureCache,
    FeatureCacheTooLarge,
    attach_features,
)
from mit_tpu_torch.train.steps import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

MESH_NOT_PORTED = (
    "MESH_SHAPE other than (1, 1) is not ported: ROADMAP.md, queue 1, "
    "multi-GPU training"
)
PRETRAINED_NOT_PORTED = (
    "pretrained encoder loading is not ported: ROADMAP.md, queue 1, "
    "pretrained loading"
)
STEP_KEYS = ("images", "features", "decoder_input_tokens", "target_tokens")


def setup_wandb(cfg):
    """A wandb run, or None when wandb is unavailable (console logging)."""
    try:
        import wandb

        return wandb.init(
            project=cfg.WANDB_PROJECT, entity=cfg.WANDB_ENTITY,
            name=cfg.WANDB_RUN_NAME,
            mode=os.environ.get("WANDB_MODE", "offline"),
            config=json.loads(cfg.to_json()),
        )
    except Exception as e:          # wandb is optional
        print(f"wandb unavailable ({e}); continuing without experiment tracking.")
        return None


def ensure_tokenizer(cfg):
    """Train the BPE tokenizer from every caption if its files are missing,
    then load it (needs the ``regex`` package)."""
    from mit_tpu_torch.text.tokenizer import get_tokenizer, train_tokenizer

    if not (os.path.exists(cfg.VOCAB_PATH) and os.path.exists(cfg.MERGES_PATH)):
        print("Tokenizer files missing — training from captions ...")
        with open(cfg.CAPTIONS_FILE, "r", encoding="utf-8") as f:
            captions_data = json.load(f)
        captions = []
        if isinstance(captions_data, dict):
            for v in captions_data.values():
                if isinstance(v, list):
                    captions.extend(c for c in v if isinstance(c, str))
                elif isinstance(v, str):
                    captions.append(v)
        if not captions:
            raise ValueError(f"No caption strings found in {cfg.CAPTIONS_FILE}; "
                             "cannot train tokenizer.")
        train_tokenizer(iter(captions), cfg.VOCAB_SIZE, cfg.VOCAB_PATH,
                        cfg.MERGES_PATH, cfg)
    return get_tokenizer(cfg, force_reload=True)


def _hf_uploader(cfg):
    """The HF Hub upload callable, or None if the hub is unavailable."""
    try:
        from huggingface_hub import HfApi, create_repo

        create_repo(cfg.HF_REPO_ID, repo_type="model", exist_ok=True)
        api = HfApi()
        print(f"HF Hub repo '{cfg.HF_REPO_ID}' ready for uploads.")
        return lambda path, name: api.upload_file(
            path_or_fileobj=path, path_in_repo=name, repo_id=cfg.HF_REPO_ID,
            repo_type="model")
    except Exception as e:          # uploads are optional
        print(f"HF Hub unavailable; uploads disabled. ({e})")
        return None


def train(
    cfg=None,
    auto_prepare: bool = True,
    wandb_enabled: bool = True,
    hf_upload=None,                     # callable(path, name) or None
    max_steps_per_epoch: Optional[int] = None,
    device="cuda",
    fused_dropout: bool = False,
) -> Dict:
    """Run the training job on ``device``; returns a summary dict.

    ``cfg`` is a ``mit_tpu_torch.config.Config`` (the package default when None).
    ``fused_dropout`` sends the decoder self-attention's dropout through
    the hash-mask kernels (the CLI reads ``MIT_FUSED_DROPOUT``).
    """
    if cfg is None:
        from mit_tpu_torch.config import CONFIG as cfg
    t_setup = time.time()
    if tuple(cfg.MESH_SHAPE) != (1, 1):
        raise NotImplementedError(MESH_NOT_PORTED)
    if cfg.PRETRAINED_ENCODER not in ("off", "auto"):
        raise NotImplementedError(PRETRAINED_NOT_PORTED)
    if cfg.ENCODER_QUANT not in ("none", "int8"):
        raise ValueError(
            f"ENCODER_QUANT must be 'none' or 'int8', got {cfg.ENCODER_QUANT!r}")
    device = torch.device(device)
    if auto_prepare:
        from mit_tpu_torch.data.prepare import prepare_flickr30k

        prepare_flickr30k(cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    np.random.seed(cfg.RANDOM_SEED)

    wandb_run = setup_wandb(cfg) if wandb_enabled else None
    log = wandb_run.log if wandb_run else (lambda d: None)
    if hf_upload is None and cfg.HF_UPLOAD_BEST_CHECKPOINTS:
        hf_upload = _hf_uploader(cfg)

    tokenizer = ensure_tokenizer(cfg)
    cfg = cfg.with_tokenizer_ids(tokenizer)
    vocab_size = tokenizer.get_vocab_size()
    print(f"Tokenizer loaded; vocab size {vocab_size}.")
    mcfg = ModelConfig.build(cfg, vocab_size=vocab_size)

    dataset = ImageTextDataset(cfg.IMAGE_DIR, cfg.CAPTIONS_FILE,
                               cfg.MAX_SEQ_LEN, tokenizer,
                               cfg.ENCODER_MODEL_NAME,
                               image_size=mcfg.vision.image_size)
    if len(dataset) == 0:
        raise ValueError("Dataset is empty — check IMAGE_DIR and CAPTIONS_FILE.")
    tr_idx, va_idx = split_indices(len(dataset), cfg.TRAIN_SPLIT_RATIO,
                                   cfg.RANDOM_SEED)
    print(f"Dataset split: {len(tr_idx)} train / {len(va_idx)} val samples.")

    if cfg.PRETRAINED_ENCODER == "auto":
        print("Pretrained encoder loading is not ported; random encoder init.")
    params = init_model_params(torch.Generator().manual_seed(cfg.RANDOM_SEED),
                               mcfg, device)
    trainable, frozen = split_trainable(params)
    # W8A8 for the compute path only: `frozen` keeps the float weights that
    # checkpoints export
    step_encoder = frozen
    if cfg.ENCODER_QUANT == "int8":
        step_encoder = {"encoder": quantize_vision_params(frozen["encoder"],
                                                          mcfg.vision)}
        print("Frozen encoder quantized to int8 (W8A8) for training compute.")

    compute_dtype = (torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16"
                     else torch.float32)
    use_cache, cache = cfg.CACHE_ENCODER_FEATURES, None
    if use_cache:
        print("Building frozen-encoder feature cache ...")
        try:
            cache = FeatureCache.build(
                dataset, step_encoder["encoder"], mcfg, device,
                batch_size=min(cfg.BATCH_SIZE, 64),
                num_workers=cfg.NUM_WORKERS,
                max_bytes=cfg.FEATURE_CACHE_MAX_BYTES,
                compute_dtype=compute_dtype,
            )
            print(f"Feature cache: {tuple(cache.features.shape)} "
                  f"@ {cache.features.dtype}, {cache.nbytes / 1e6:.1f} MB")
        except FeatureCacheTooLarge as e:
            print(f"{e}; training with the encoder in-graph instead.")
            use_cache = False

    loader_kw = dict(batch_size=cfg.BATCH_SIZE, num_workers=cfg.NUM_WORKERS,
                     load_images=not use_cache,
                     bad_paths=cache.failed_paths if cache else None)
    train_loader = Loader(dataset, tr_idx, shuffle=True, seed=cfg.RANDOM_SEED,
                          **loader_kw)
    val_loader = Loader(dataset, va_idx, shuffle=False, **loader_kw)

    optimizer, schedule = make_optimizer(cfg, len(train_loader))
    state = init_train_state(trainable, optimizer)
    train_step = make_train_step(mcfg, optimizer, cfg.PAD_TOKEN_ID,
                                 compute_dtype, from_features=use_cache,
                                 fused_dropout=fused_dropout)
    eval_step = make_eval_step(mcfg, cfg.PAD_TOKEN_ID, compute_dtype,
                               from_features=use_cache)
    step_frozen = {} if use_cache else step_encoder

    start_epoch, best_val_loss = 0, float("inf")
    if cfg.RESUME_CHECKPOINT_PATH:
        try:
            state, start_epoch, best_val_loss = ckpt.restore_train_state(
                cfg.RESUME_CHECKPOINT_PATH, state)
            print(f"Resumed from {cfg.RESUME_CHECKPOINT_PATH}; "
                  f"starting at epoch {start_epoch + 1}.")
        except Exception as e:      # the JAX loop starts afresh on any failure
            print(f"Error loading checkpoint: {e}. Starting from scratch.")
            start_epoch, best_val_loss = 0, float("inf")

    print(f"Setup done in {time.time() - t_setup:.1f}s; training "
          f"epochs {start_epoch + 1}..{cfg.NUM_EPOCHS}.")
    summary = {"epochs": [], "best_val_loss": best_val_loss,
               "best_checkpoint": None}

    def batch_to_device(batch):
        batch = attach_features(batch, cache)
        return to_device({k: v for k, v in batch.items() if k in STEP_KEYS},
                         device)

    for epoch in range(start_epoch, cfg.NUM_EPOCHS):
        t0 = time.time()
        n_batches = 0
        loss_sum = None           # on the device: no step waits for the host
        # the next batch's copy is issued before this step's result is read
        for i, batch in enumerate(prefetch_to_device(train_loader,
                                                     batch_to_device)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            state, loss = train_step(state, step_frozen, batch, cfg.RANDOM_SEED)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            n_batches += 1
            if state.step % cfg.LOG_INTERVAL == 0:
                log({"train_batch_loss": float(loss),
                     "learning_rate": float(schedule(state.step)),
                     "global_step": state.step})
        train_loss = float(loss_sum) / n_batches if n_batches else 0.0
        dur = time.time() - t0
        sps = n_batches / max(dur, 1e-9)
        ips = sps * cfg.BATCH_SIZE
        print(f"Epoch {epoch + 1}/{cfg.NUM_EPOCHS} | Train loss {train_loss:.4f} "
              f"| {dur:.1f}s ({sps:.2f} steps/s, {ips:.0f} images/s)")
        log({"epoch_train_loss": train_loss, "epoch": epoch + 1,
             "epoch_duration_seconds": dur, "train_images_per_sec": ips})
        epoch_summary = {"epoch": epoch + 1, "train_loss": train_loss}

        if (epoch + 1) % cfg.VALIDATION_INTERVAL == 0 and len(va_idx) > 0:
            tv = time.time()
            nll_sum, tok_sum = None, None
            merged = {**state.params, **step_frozen}
            for i, batch in enumerate(val_loader):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                s, c = eval_step(merged, batch_to_device(batch))
                nll_sum = s if nll_sum is None else nll_sum + s
                tok_sum = c if tok_sum is None else tok_sum + c
            val_loss = (float(nll_sum) / max(1.0, float(tok_sum))
                        if nll_sum is not None else 0.0)
            print(f"Epoch {epoch + 1} | Val loss {val_loss:.4f} "
                  f"| {time.time() - tv:.1f}s")
            log({"epoch_val_loss": val_loss, "epoch": epoch + 1})
            epoch_summary["val_loss"] = val_loss

            if val_loss < best_val_loss:
                best_val_loss = val_loss
                name = ckpt.checkpoint_filename(cfg, epoch, val_loss)
                st_path = os.path.join(cfg.OUTPUT_DIR, name + ".safetensors")
                ckpt.save_safetensors(st_path, {**state.params, **frozen}, mcfg)
                print(f"Checkpoint saved: {st_path} (val loss {val_loss:.4f})")
                summary["best_checkpoint"] = st_path
                if hf_upload and cfg.HF_UPLOAD_BEST_CHECKPOINTS:
                    try:
                        hf_upload(st_path, os.path.basename(st_path))
                    except Exception as e:      # uploads are optional
                        print(f"HF upload failed (continuing): {e}")
            else:
                print(f"Val loss {val_loss:.4f} did not improve on "
                      f"{best_val_loss:.4f}; not saving.")

        # the latest completed epoch, every TRAIN_STATE_INTERVAL epochs and
        # at the last
        interval = max(1, cfg.TRAIN_STATE_INTERVAL)
        if (epoch + 1) % interval == 0 or epoch + 1 == cfg.NUM_EPOCHS:
            try:
                ckpt.save_train_state(os.path.join(cfg.OUTPUT_DIR, "latest"),
                                      state, epoch, best_val_loss, cfg)
            except OSError as e:
                print(f"Warning: periodic train-state save failed: {e}")
        summary["epochs"].append(epoch_summary)

    summary["best_val_loss"] = best_val_loss
    if wandb_run:
        wandb_run.finish()
    return summary
