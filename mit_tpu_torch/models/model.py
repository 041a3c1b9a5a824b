"""Image → text model: frozen vision encoder + decoder (port of
``mit_tpu/models/model.py``).

Parameters are ``{"encoder", "decoder"}`` plus ``"projection"`` when the
encoder width differs from the decoder width; :func:`split_trainable`
parts them into the trainable projection and decoder and the frozen
encoder. Memory modes: "cls" (the projected CLS token, length 1) and "full"
(the whole patch sequence). The encoder runs under ``torch.no_grad()``,
the counterpart of the JAX package's ``stop_gradient``.

Under a device mesh with a model axis over 1, the float encoder tree is a
rank's piece (``parallel.mesh.shard_encoder``) and runs split over
"model"; an int8 tree is whole and runs on the rank's rows
(:func:`encode_images`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mit_tpu_torch.models.decoder import (
    DecoderConfig,
    decoder_forward,
    init_decoder_params,
)
from mit_tpu_torch.ops.attention import DropoutGenerators
from mit_tpu_torch.models.vision import (
    VisionConfig,
    config_for_encoder,
    init_vision_params,
    vision_forward,
    vision_forward_int8,
)


class ModelConfig(NamedTuple):
    """``language_model`` chooses the family of the language side:
    "decoder", the reference project's post-LN Transformer (``decoder`` a
    :class:`DecoderConfig`), or "kimi_vl", Kimi-VL-A3B's sparse decoder
    behind its projector (``decoder`` a
    :class:`~mit_tpu_torch.models.kimi_vl.KimiVLConfig`, memory "full")."""

    encoder_name: str
    vision: VisionConfig
    decoder: DecoderConfig
    memory_mode: str = "cls"            # "cls" | "full"
    language_model: str = "decoder"     # "decoder" | "kimi_vl"

    @classmethod
    def build(cls, cfg, vocab_size: Optional[int] = None) -> "ModelConfig":
        """From a ``mit_tpu_torch.config.Config``; the tokenizer's actual vocab
        size, when given, overrides ``cfg.VOCAB_SIZE``. ``LANGUAGE_MODEL``
        "kimi_vl" takes Kimi-VL-A3B's published shape with the encoder's
        width as the projector's input, and the full patch memory."""
        # a config of the JAX package's has no LANGUAGE_MODEL: the decoder
        language_model = getattr(cfg, "LANGUAGE_MODEL", "decoder")
        if language_model == "kimi_vl":
            from mit_tpu_torch.models.kimi_vl import KIMI_VL_A3B

            vision = config_for_encoder(cfg.ENCODER_MODEL_NAME)
            return cls(cfg.ENCODER_MODEL_NAME, vision,
                       KIMI_VL_A3B._replace(vision_width=vision.hidden_size),
                       "full", "kimi_vl")
        if language_model != "decoder":
            raise ValueError("LANGUAGE_MODEL must be 'decoder' or 'kimi_vl', "
                             f"got {language_model!r}")
        decoder = DecoderConfig(
            vocab_size=vocab_size if vocab_size is not None else cfg.VOCAB_SIZE,
            embed_dim=cfg.DECODER_EMBED_DIM,
            num_heads=cfg.DECODER_HEADS,
            num_layers=cfg.DECODER_LAYERS,
            ff_dim=cfg.DECODER_FF_DIM,
            max_seq_len=cfg.MAX_SEQ_LEN,
            dropout=cfg.DECODER_DROPOUT,
            pad_idx=cfg.PAD_TOKEN_ID,
        )
        return cls(
            encoder_name=cfg.ENCODER_MODEL_NAME,
            vision=config_for_encoder(cfg.ENCODER_MODEL_NAME),
            decoder=decoder,
            memory_mode=cfg.MEMORY_MODE,
        )

    @property
    def needs_projection(self) -> bool:
        return self.vision.hidden_size != self.decoder.embed_dim


def init_model_params(generator: torch.Generator, mcfg: ModelConfig,
                      device=None) -> dict:
    """Random weights from ``generator`` (drawn on the CPU), on ``device``."""
    encoder = init_vision_params(generator, mcfg.vision, device)
    return {"encoder": encoder, **_init_trainable(generator, mcfg, device)}


def _init_trainable(generator: torch.Generator, mcfg: ModelConfig,
                    device=None) -> dict:
    """The decoder's random weights and, where the widths differ, the
    projection's."""
    params = {"decoder": init_decoder_params(generator, mcfg.decoder, device)}
    if mcfg.needs_projection:
        d_in, d_out = mcfg.vision.hidden_size, mcfg.decoder.embed_dim
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = (torch.rand(d_in, d_out, generator=generator) * 2 - 1) * lim
        params["projection"] = {"w": w.to(device),
                                "b": torch.zeros(d_out, device=device)}
    return params


def init_model_params_pretrained(
    generator: torch.Generator,
    cfg,
    vocab_size: Optional[int] = None,
    name_or_path: Optional[str] = None,
    local_files_only: bool = True,
    device=None,
):
    """(mcfg, params) with a pretrained frozen encoder: the vision tower of
    ``name_or_path`` (default ``cfg.ENCODER_MODEL_NAME``) is loaded through
    :mod:`mit_tpu_torch.models.pretrained` and its geometry replaces the
    preset's; the decoder and projection are drawn from ``generator``. All
    of it on ``device``. A repo id is fetched only with
    ``local_files_only=False``."""
    from mit_tpu_torch.models.pretrained import load_pretrained_encoder

    vcfg, encoder = load_pretrained_encoder(
        name_or_path or cfg.ENCODER_MODEL_NAME,
        local_files_only=local_files_only, device=device)
    mcfg = ModelConfig.build(cfg, vocab_size)._replace(vision=vcfg)
    return mcfg, {"encoder": encoder,
                  **_init_trainable(generator, mcfg, device)}


def encode_images(
    params: dict,
    mcfg: ModelConfig,
    pixel_values: torch.Tensor,          # (B, 3, H, W)
    compute_dtype=torch.float32,
    use_kernel: bool = True,
    fused_layers: bool = True,
    shard=None,
) -> torch.Tensor:
    """Frozen-encoder features before projection: (B, 1, H_enc) in "cls"
    mode, (B, N+1, H_enc) in "full" mode.

    An int8 encoder tree (``quantize_vision_params``, recognized by its
    ``"patch"`` weight) runs :func:`vision_forward_int8`, in the form that
    ``fused_layers`` picks; a float tree runs :func:`vision_forward`, split
    over "model" where ``shard`` (a mesh rank's place in the step) has a
    "model" group, and then ``params`` hold this rank's piece of it. An
    int8 tree runs whole on the rank's rows under any ``shard``.
    """
    enc = params["encoder"]
    cls_only = mcfg.memory_mode == "cls"
    with torch.no_grad():
        if "patch" in enc:
            return vision_forward_int8(
                enc, mcfg.vision, pixel_values, compute_dtype, use_kernel,
                cls_only=cls_only, fused_layers=fused_layers,
            )
        return vision_forward(
            enc, mcfg.vision, pixel_values, compute_dtype, use_kernel,
            cls_only=cls_only, shard=shard,
        )


def project_features(params: dict, mcfg: ModelConfig, features: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """features (B, S, H_enc) → decoder memory (B, S, D)."""
    cd = compute_dtype
    if mcfg.needs_projection:
        p = params["projection"]
        return features.to(cd) @ p["w"].to(cd) + p["b"].to(cd)
    return features.to(cd)


def split_trainable(params: dict):
    """(trainable, frozen): the encoder is frozen, the projection and the
    decoder train."""
    frozen = {"encoder": params["encoder"]}
    trainable = {k: v for k, v in params.items() if k != "encoder"}
    return trainable, frozen


def merge_params(trainable: dict, frozen: dict) -> dict:
    return {**trainable, **frozen}


def forward_from_features(
    params: dict,
    mcfg: ModelConfig,
    features: torch.Tensor,             # (B, S, H_enc) cached encoder output
    tgt_tokens: torch.Tensor,           # (B, T)
    deterministic: bool = True,
    generator: Optional[DropoutGenerators] = None,
    compute_dtype=torch.float32,
    use_kernel: bool = True,
    fused_dropout: bool = False,
    remat: bool = False,
    shard=None,
) -> torch.Tensor:
    """Teacher-forced logits (B, T, V) in f32 from encoder features;
    ``remat`` checkpoints each decoder layer and ``shard`` places a mesh
    rank's part of the step (:func:`decoder_forward`)."""
    memory = project_features(params, mcfg, features, compute_dtype)
    return decoder_forward(
        params["decoder"], mcfg.decoder, tgt_tokens, memory, None,
        compute_dtype, use_kernel, deterministic, generator, fused_dropout,
        remat, shard,
    )


def model_forward(
    params: dict,
    mcfg: ModelConfig,
    pixel_values: torch.Tensor,
    tgt_tokens: torch.Tensor,
    deterministic: bool = True,
    generator: Optional[DropoutGenerators] = None,
    compute_dtype=torch.float32,
    use_kernel: bool = True,
    fused_dropout: bool = False,
    remat: bool = False,
    shard=None,
) -> torch.Tensor:
    """Teacher-forced logits (B, T, V) from pixels: the frozen encoder
    (:func:`encode_images`, under ``shard`` too), then
    :func:`forward_from_features`."""
    features = encode_images(params, mcfg, pixel_values, compute_dtype,
                             use_kernel, shard=shard)
    return forward_from_features(
        params, mcfg, features, tgt_tokens, deterministic, generator,
        compute_dtype, use_kernel, fused_dropout, remat, shard,
    )
