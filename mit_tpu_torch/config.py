"""Typed configuration for mit_tpu_torch: the port's own copy of the JAX
package's ``config.py`` (stdlib only), knob for knob, so that a config
written for one package reads in the other.

Re-designs the reference's flat constants module (reference ``config.py:1-145``)
as a frozen dataclass: every knob name from the reference is preserved verbatim
so users can port settings 1:1, but the config is a *value* (hashable, passable
into jitted functions' static args, serializable) instead of mutable module
globals.

Differences from the reference, by design:

- No ``DEVICE`` knob (reference config.py:10 probes CUDA): JAX owns device
  placement; parallel layout lives in ``mesh_shape`` instead.
- Special-token *IDs* are runtime-derived from the tokenizer (single source of
  truth) via :meth:`Config.with_tokenizer_ids`. The reference hardcodes
  PAD=0, START=1, END=2, UNK=3 (config.py:116-119) while its tokenizer trainer
  registers the order [PAD, UNK, START, END] (tokenizer.py:202-208) — an
  internal inconsistency this framework fixes while keeping the knob names.
- New TPU-first knobs (dtype, mesh, feature-cache, memory mode) are appended
  at the end.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # --- General (reference config.py:8-12) ---
    RANDOM_SEED: int = 42

    # --- Data (reference config.py:14-35) ---
    DATA_DIR: str = "../assets/multimodal_image_transformer/"
    TRAIN_SPLIT_RATIO: float = 0.9
    NUM_WORKERS: int = 2          # host-side prefetch threads (ref: DataLoader workers)
    # Intentionally inert, kept for 1:1 knob parity: JAX device transfers
    # are explicit (prefetch_to_device), so there is no pinned-memory knob
    # to forward (reference config.py:35 feeds torch DataLoader).
    PIN_MEMORY: bool = False

    # --- Model / encoder (reference config.py:37-53) ---
    ENCODER_MODEL_NAME: str = "google/vit-base-patch16-224-in21k"
    IMAGE_PROCESSOR_NAME: str = "google/vit-base-patch16-224-in21k"
    # Intentionally inert, kept for 1:1 knob parity: the reference defines
    # this knob but never reads it either, and documents its only non-default
    # value as "not fully implemented" (reference config.py:50-53). Image
    # transforms here always match the HF processor for ENCODER_MODEL_NAME
    # (data/preprocess.py), i.e. the "hf_processor" behavior.
    IMG_TRANSFORM_MODE: str = "hf_processor"

    # --- Decoder architecture (reference config.py:55-72) ---
    VOCAB_SIZE: int = 10000
    MAX_SEQ_LEN: int = 100
    DECODER_EMBED_DIM: int = 512
    DECODER_LAYERS: int = 6
    DECODER_HEADS: int = 8
    DECODER_FF_DIM: int = 2048
    DECODER_DROPOUT: float = 0.1
    PROJECTION_DIM: int = 512

    # --- Training (reference config.py:74-104) ---
    BATCH_SIZE: int = 32
    NUM_EPOCHS: int = 20
    LEARNING_RATE: float = 1e-4
    WEIGHT_DECAY: float = 1e-5
    GRAD_CLIP_VALUE: float = 5.0
    ADAM_BETA1: float = 0.9
    ADAM_BETA2: float = 0.98
    ADAM_EPS: float = 1e-9
    WARMUP_STEPS: int = 0
    LOG_INTERVAL: int = 50
    VALIDATION_INTERVAL: int = 1
    CHECKPOINT_PREFIX: str = "model_checkpoint"
    RESUME_CHECKPOINT_PATH: Optional[str] = None

    # --- Tokenizer (reference config.py:106-124) ---
    PAD_TOKEN: str = "<PAD>"
    START_TOKEN: str = "<START>"
    END_TOKEN: str = "<END>"
    UNK_TOKEN: str = "<UNK>"
    # IDs below are *defaults only*; prefer `with_tokenizer_ids` which derives
    # them from the trained tokenizer (fixing the reference's mismatch bug).
    PAD_TOKEN_ID: int = 0
    START_TOKEN_ID: int = 2
    END_TOKEN_ID: int = 3
    UNK_TOKEN_ID: int = 1

    # --- wandb (reference config.py:126-132) ---
    WANDB_PROJECT: str = "multimodal-image-transformer"
    WANDB_ENTITY: Optional[str] = None
    WANDB_RUN_NAME: Optional[str] = None

    # --- Inference (reference config.py:134-137) ---
    BEAM_SIZE: int = 3

    # --- HF Hub (reference config.py:139-145) ---
    HF_REPO_ID: str = "wazzuck/multimodal_image_transformer"
    HF_UPLOAD_BEST_CHECKPOINTS: bool = True

    # ------------------------------------------------------------------
    # TPU-native knobs (no reference equivalent — the reference has no
    # parallelism, mixed precision, or feature caching)
    # ------------------------------------------------------------------
    # Compute dtype for matmuls/activations on the MXU; params stay fp32.
    COMPUTE_DTYPE: str = "bfloat16"
    # Logical device mesh (data, model). (8, 1) = pure DP on a v5e-8.
    MESH_SHAPE: Tuple[int, int] = (1, 1)
    # Cache frozen-encoder features keyed by image (encoder output is constant
    # for a frozen model — hoists the biggest redundant compute in training).
    CACHE_ENCODER_FEATURES: bool = True
    # Host-RAM bound for that cache. CLS mode is tiny (~95 MB for Flickr30k);
    # full-sequence mode stores bf16 and needs ~9 GB — a build that would
    # exceed this bound falls back to in-graph encoding instead of OOMing
    # the host.
    FEATURE_CACHE_MAX_BYTES: int = 12_000_000_000
    # "cls": memory = projected [CLS] token, length-1 (reference model.py:141).
    # "full": memory = full patch sequence (reference encoder.py:107 path).
    MEMORY_MODE: str = "cls"
    # Use Pallas kernels for attention when running on TPU.
    USE_PALLAS: bool = True
    # Pretrained frozen-encoder weights (the reference always boots from
    # pretrained HF weights, reference model.py:50):
    #   "auto"     — load ENCODER_MODEL_NAME from local HF cache/dir if
    #                available, else warn and fall back to random init
    #                (set MIT_ALLOW_DOWNLOAD=1 to permit network fetch);
    #   "required" — as "auto" but failure to load is an error;
    #   "off"      — always random init (offline CI / ablations);
    #   any other string — an explicit repo id / directory / weights file,
    #                loaded as "required".
    PRETRAINED_ENCODER: str = "auto"
    # Quantize the frozen encoder's GEMMs to int8 (W8A8) for the training
    # compute path ("int8"): 2x MXU peak on v5e, ~1% feature error, no
    # gradient impact (the encoder is frozen). Checkpoints always keep the
    # float encoder weights. "none" = bf16/fp32 encoder.
    ENCODER_QUANT: str = "none"
    # Save the orbax resume state every Nth EPOCH (the safetensors
    # weights still save on every best-val improvement, and the final
    # epoch always saves). The resume state is ~4x the weight bytes
    # (optimizer moments); with N > 1 a crash can lose up to N-1 epochs
    # of optimizer state — weights are never lost. Short sanity runs that
    # never resume can raise this to skip the transfer entirely.
    TRAIN_STATE_INTERVAL: int = 1
    # The language side of the captioner: "decoder" (the reference's 6 x 512
    # Transformer above) or "kimi_vl" (Kimi-VL-A3B's language model and
    # projector over the encoder's patches; greedy decoding only, no
    # training, service, beam search, sampling or int8 arm yet).
    LANGUAGE_MODEL: str = "decoder"

    # --- Derived paths (reference config.py:17-24, 121-124) ---
    @property
    def IMAGE_DIR(self) -> str:
        return os.path.join(self.DATA_DIR, "images")

    @property
    def CAPTIONS_FILE(self) -> str:
        return os.path.join(self.DATA_DIR, "captions.json")

    @property
    def OUTPUT_DIR(self) -> str:
        return self.DATA_DIR

    @property
    def VOCAB_PATH(self) -> str:
        return os.path.join(self.OUTPUT_DIR, "vocab.json")

    @property
    def MERGES_PATH(self) -> str:
        return os.path.join(self.OUTPUT_DIR, "merges.txt")

    # ------------------------------------------------------------------
    def with_tokenizer_ids(self, tokenizer) -> "Config":
        """Return a copy whose special-token IDs come from ``tokenizer``.

        Single source of truth for IDs — resolves the reference's hardcoded-ID
        vs trained-order inconsistency (reference config.py:116-119 vs
        tokenizer.py:202-208).
        """
        return dataclasses.replace(
            self,
            PAD_TOKEN_ID=tokenizer.token_to_id(self.PAD_TOKEN),
            START_TOKEN_ID=tokenizer.token_to_id(self.START_TOKEN),
            END_TOKEN_ID=tokenizer.token_to_id(self.END_TOKEN),
            UNK_TOKEN_ID=tokenizer.token_to_id(self.UNK_TOKEN),
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # --- (de)serialization, used by checkpointing ---
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        if "MESH_SHAPE" in d and isinstance(d["MESH_SHAPE"], list):
            d["MESH_SHAPE"] = tuple(d["MESH_SHAPE"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Default instance mirroring the reference's module-of-constants usage style:
#   from mit_tpu_torch.config import CONFIG
CONFIG = Config()
