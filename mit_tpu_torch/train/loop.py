"""Training orchestration (port of ``mit_tpu/train/loop.py``).

The same flow: prepare the dataset → seed → wandb → train the tokenizer if
its files are missing → load it, take its special ids and vocab size →
dataset and split → model init (or resume) → the frozen-feature cache →
epochs of train steps with periodic validation, best-val safetensors and
the ``latest`` train state, and the optional HF Hub upload.

The encoder boots as ``PRETRAINED_ENCODER`` says (:func:`build_model_params`),
and the dataset preprocesses at the booted encoder's image size.

**A device mesh.** ``MESH_SHAPE`` other than (1, 1) trains data-parallel
(``(N, 1)``), tensor-parallel (``(1, N)``) or both, one process a device
under ``torchrun`` (``parallel.mesh.init_distributed_mesh``: the backend the
caller names, else ``MIT_DIST_BACKEND``, else ``nccl`` for CUDA and
``gloo`` for the CPU; rank i on ``cuda:LOCAL_RANK`` unless a device is
given, which then holds for every rank). Every rank draws the same model
from the seed, builds the same feature cache itself (unsharded, as the JAX
loop builds it; the encoder is deterministic, so no rank waits for
another's), iterates the same batches and takes its rows of each. The
state is restored whole, then sharded. Each save gathers the parameters
(and the optimizer state) over "model", so files equal a single device's;
rank 0 alone trains the tokenizer, writes, logs and uploads. With the
frozen encoder in the step (``CACHE_ENCODER_FEATURES=False``, or a cache
over ``FEATURE_CACHE_MAX_BYTES``), a model axis over 1 splits a float
encoder over "model" as the JAX loop does (Megatron's layout,
``vision_param_specs(tp=True)``; its heads and FFN columns must divide
evenly) and replicates an int8 one; files hold the whole float encoder,
never a shard of it.
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
from mit_tpu_torch.models.model import (
    ModelConfig,
    init_model_params,
    init_model_params_pretrained,
    split_trainable,
)
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


def build_model_params(cfg, mcfg, generator: torch.Generator, vocab_size,
                       device=None):
    """(mcfg, params on ``device``) as ``cfg.PRETRAINED_ENCODER`` says:
    "off" draws a random encoder; "auto" loads ``cfg.ENCODER_MODEL_NAME``
    and, if that fails, says why and draws a random one; "required" loads it
    or raises; any other value is a repo id, directory or weights file,
    loaded as under "required". A loaded encoder's geometry replaces
    ``mcfg.vision``. Only ``MIT_ALLOW_DOWNLOAD=1`` lets a repo id be fetched
    over the network."""
    mode = cfg.PRETRAINED_ENCODER
    if mode == "off":
        return mcfg, init_model_params(generator, mcfg, device)
    name = None if mode in ("auto", "required") else mode
    local_only = os.environ.get("MIT_ALLOW_DOWNLOAD", "0") != "1"
    try:
        mcfg, params = init_model_params_pretrained(
            generator, cfg, vocab_size, name_or_path=name,
            local_files_only=local_only, device=device)
    except Exception as e:          # "auto" falls back on any failure, as JAX's
        if mode != "auto":
            raise
        print(f"Pretrained encoder unavailable ({e}); "
              "falling back to random encoder init.")
        return mcfg, init_model_params(generator, mcfg, device)
    print(f"Loaded pretrained encoder weights "
          f"({name or cfg.ENCODER_MODEL_NAME}).")
    return mcfg, params


def train(
    cfg=None,
    auto_prepare: bool = True,
    wandb_enabled: bool = True,
    hf_upload=None,                     # callable(path, name) or None
    max_steps_per_epoch: Optional[int] = None,
    device=None,
    fused_dropout: Optional[bool] = None,
    backend: Optional[str] = None,
) -> Dict:
    """Run the training job on ``device``; returns a summary dict.

    ``cfg`` is a ``mit_tpu_torch.config.Config`` (the package default when None).
    ``fused_dropout`` sends the decoder self-attention's dropout through
    the hash-mask kernels; None reads ``MIT_FUSED_DROPOUT`` (on at "1"),
    as the JAX package's attention does, and a bool overrides it.
    ``device`` defaults to "cuda", or under a mesh to ``cuda:LOCAL_RANK``;
    ``backend`` names the mesh's ``torch.distributed`` backend (None reads
    ``MIT_DIST_BACKEND``). A process group already up is used as it is.
    """
    if cfg is None:
        from mit_tpu_torch.config import CONFIG as cfg
    if fused_dropout is None:
        fused_dropout = os.environ.get("MIT_FUSED_DROPOUT") == "1"
    t_setup = time.time()
    # a config of the JAX package's has no LANGUAGE_MODEL: the decoder
    language_model = getattr(cfg, "LANGUAGE_MODEL", "decoder")
    if language_model != "decoder":
        raise NotImplementedError(
            f"training runs the 'decoder' language model only, not "
            f"{language_model!r}")
    if cfg.ENCODER_QUANT not in ("none", "int8"):
        raise ValueError(
            f"ENCODER_QUANT must be 'none' or 'int8', got {cfg.ENCODER_QUANT!r}")
    mesh = None
    if tuple(cfg.MESH_SHAPE) != (1, 1):
        from mit_tpu_torch.parallel.mesh import (
            init_distributed_mesh,
            rank_device,
        )

        device = rank_device(device)
        mesh = init_distributed_mesh(
            cfg.MESH_SHAPE, device,
            backend or os.environ.get("MIT_DIST_BACKEND") or None)
        n_data = mesh.shape["data"]
        if cfg.BATCH_SIZE % n_data != 0:
            raise ValueError(
                f"BATCH_SIZE={cfg.BATCH_SIZE} must be divisible by the mesh "
                f"data axis ({n_data}) so every chip gets equal batch shards.")
    device = torch.device("cuda" if device is None else device)
    main = mesh is None or torch.distributed.get_rank() == 0
    say = print if main else (lambda *a, **k: None)
    use_tp = mesh is not None and mesh.shape["model"] > 1
    if mesh is not None:
        say(f"Device mesh: data={mesh.shape['data']}, "
            f"model={mesh.shape['model']} ({mesh.size} devices).")
    if auto_prepare and main:
        from mit_tpu_torch.data.prepare import prepare_flickr30k

        prepare_flickr30k(cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    np.random.seed(cfg.RANDOM_SEED)

    wandb_run = setup_wandb(cfg) if wandb_enabled and main else None
    log = wandb_run.log if wandb_run else (lambda d: None)
    if not main:
        hf_upload = None
    elif hf_upload is None and cfg.HF_UPLOAD_BEST_CHECKPOINTS:
        hf_upload = _hf_uploader(cfg)

    # rank 0 trains a missing tokenizer; the others then load its files
    if main:
        tokenizer = ensure_tokenizer(cfg)
    if mesh is not None:
        torch.distributed.barrier()
    if not main:
        tokenizer = ensure_tokenizer(cfg)
    cfg = cfg.with_tokenizer_ids(tokenizer)
    vocab_size = tokenizer.get_vocab_size()
    say(f"Tokenizer loaded; vocab size {vocab_size}.")
    # the model first: the dataset preprocesses at the booted encoder's size
    mcfg, params = build_model_params(
        cfg, ModelConfig.build(cfg, vocab_size=vocab_size),
        torch.Generator().manual_seed(cfg.RANDOM_SEED), vocab_size, device)

    dataset = ImageTextDataset(cfg.IMAGE_DIR, cfg.CAPTIONS_FILE,
                               cfg.MAX_SEQ_LEN, tokenizer,
                               cfg.ENCODER_MODEL_NAME,
                               image_size=mcfg.vision.image_size)
    if len(dataset) == 0:
        raise ValueError("Dataset is empty — check IMAGE_DIR and CAPTIONS_FILE.")
    tr_idx, va_idx = split_indices(len(dataset), cfg.TRAIN_SPLIT_RATIO,
                                   cfg.RANDOM_SEED)
    say(f"Dataset split: {len(tr_idx)} train / {len(va_idx)} val samples.")

    trainable, frozen = split_trainable(params)
    # W8A8 for the compute path only: `frozen` keeps the float weights that
    # checkpoints export
    step_encoder = frozen
    if cfg.ENCODER_QUANT == "int8":
        step_encoder = {"encoder": quantize_vision_params(frozen["encoder"],
                                                          mcfg.vision)}
        say("Frozen encoder quantized to int8 (W8A8) for training compute.")

    compute_dtype = (torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16"
                     else torch.float32)
    use_cache, cache = cfg.CACHE_ENCODER_FEATURES, None
    if use_cache:
        say("Building frozen-encoder feature cache ...")
        try:
            cache = FeatureCache.build(
                dataset, step_encoder["encoder"], mcfg, device,
                batch_size=min(cfg.BATCH_SIZE, 64),
                num_workers=cfg.NUM_WORKERS,
                max_bytes=cfg.FEATURE_CACHE_MAX_BYTES,
                compute_dtype=compute_dtype,
            )
            say(f"Feature cache: {tuple(cache.features.shape)} "
                f"@ {cache.features.dtype}, {cache.nbytes / 1e6:.1f} MB")
        except FeatureCacheTooLarge as e:
            say(f"{e}; training with the encoder in-graph instead.")
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
                                 fused_dropout=fused_dropout, mesh=mesh)
    eval_step = make_eval_step(mcfg, cfg.PAD_TOKEN_ID, compute_dtype,
                               from_features=use_cache, mesh=mesh)
    step_frozen = {} if use_cache else step_encoder
    if step_frozen and mesh is not None:
        from mit_tpu_torch.parallel import mesh as pmesh

        # the float encoder Megatron-split over "model"; an int8 tree stays
        # whole on every rank, as in the JAX loop
        step_frozen = {"encoder": pmesh.shard_encoder(
            step_frozen["encoder"], mcfg.vision, mesh)}

    start_epoch, best_val_loss = 0, float("inf")
    if cfg.RESUME_CHECKPOINT_PATH:
        try:
            state, start_epoch, best_val_loss = ckpt.restore_train_state(
                cfg.RESUME_CHECKPOINT_PATH, state)
            say(f"Resumed from {cfg.RESUME_CHECKPOINT_PATH}; "
                f"starting at epoch {start_epoch + 1}.")
        except Exception as e:      # the JAX loop starts afresh on any failure
            say(f"Error loading checkpoint: {e}. Starting from scratch.")
            start_epoch, best_val_loss = 0, float("inf")

    if mesh is not None:
        from mit_tpu_torch.parallel import mesh as pmesh

        # shard after the restore: the template and the file stay whole
        state = pmesh.shard_train_state(state, mesh, mcfg, tp=use_tp)

    def whole(state):
        """The whole state (a collective over "model" under a mesh)."""
        if mesh is None:
            return state
        return pmesh.gather_train_state(state, mesh, tp=use_tp)

    say(f"Setup done in {time.time() - t_setup:.1f}s; training "
        f"epochs {start_epoch + 1}..{cfg.NUM_EPOCHS}.")
    summary = {"epochs": [], "best_val_loss": best_val_loss,
               "best_checkpoint": None}
    if mesh is not None:
        summary["mesh"] = {"data": mesh.shape["data"],
                           "model": mesh.shape["model"]}

    def batch_to_device(batch):
        batch = attach_features(batch, cache)
        batch = {k: v for k, v in batch.items() if k in STEP_KEYS}
        if mesh is not None:
            # this rank's rows only cross to its device
            batch = pmesh.shard_batch(batch, mesh)
        return to_device(batch, device)

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
        say(f"Epoch {epoch + 1}/{cfg.NUM_EPOCHS} | Train loss {train_loss:.4f} "
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
            if mesh is not None and nll_sum is not None:
                from mit_tpu_torch.parallel.collectives import all_reduce_sum

                nll_sum, tok_sum = all_reduce_sum(
                    torch.stack([nll_sum, tok_sum]), mesh.group("data"))
            val_loss = (float(nll_sum) / max(1.0, float(tok_sum))
                        if nll_sum is not None else 0.0)
            say(f"Epoch {epoch + 1} | Val loss {val_loss:.4f} "
                f"| {time.time() - tv:.1f}s")
            log({"epoch_val_loss": val_loss, "epoch": epoch + 1})
            epoch_summary["val_loss"] = val_loss

            if val_loss < best_val_loss:
                best_val_loss = val_loss
                name = ckpt.checkpoint_filename(cfg, epoch, val_loss)
                st_path = os.path.join(cfg.OUTPUT_DIR, name + ".safetensors")
                params = whole(state).params
                if main:
                    ckpt.save_safetensors(st_path, {**params, **frozen}, mcfg)
                    print(f"Checkpoint saved: {st_path} "
                          f"(val loss {val_loss:.4f})")
                summary["best_checkpoint"] = st_path
                if wandb_run:                   # the model artifact
                    try:
                        import wandb

                        art = wandb.Artifact(
                            f"{cfg.WANDB_RUN_NAME or 'model'}-epoch{epoch + 1}",
                            type="model",
                            description=(f"Checkpoint at epoch {epoch + 1}, "
                                         f"val loss {val_loss:.4f}"),
                        )
                        art.add_file(st_path)
                        wandb_run.log_artifact(art)
                    except Exception as e:      # tracking is optional
                        print(f"wandb artifact logging failed: {e}")
                if hf_upload and cfg.HF_UPLOAD_BEST_CHECKPOINTS:
                    try:
                        hf_upload(st_path, os.path.basename(st_path))
                    except Exception as e:      # uploads are optional
                        print(f"HF upload failed (continuing): {e}")
            else:
                say(f"Val loss {val_loss:.4f} did not improve on "
                    f"{best_val_loss:.4f}; not saving.")

        # the latest completed epoch, every TRAIN_STATE_INTERVAL epochs and
        # at the last
        interval = max(1, cfg.TRAIN_STATE_INTERVAL)
        if (epoch + 1) % interval == 0 or epoch + 1 == cfg.NUM_EPOCHS:
            full = whole(state)
            try:
                if main:
                    ckpt.save_train_state(
                        os.path.join(cfg.OUTPUT_DIR, "latest"), full, epoch,
                        best_val_loss, cfg)
            except Exception as e:          # a failed autosave loses no epoch
                print(f"Warning: periodic train-state save failed: {e}")
        summary["epochs"].append(epoch_summary)

    summary["best_val_loss"] = best_val_loss
    if mesh is not None:
        from mit_tpu_torch.parallel.mesh import param_devices

        # every rank holds a piece of every parameter leaf
        summary["param_devices"] = param_devices(state.params, mesh)
        torch.distributed.barrier()
    if wandb_run:
        wandb_run.finish()
    return summary
