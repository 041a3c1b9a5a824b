"""The system under test, built from a configuration file: the port's own
types and entry points (``mit_tpu_torch``), handed the benchmark's
weights. Nothing here computes what the program computes."""

from __future__ import annotations

from typing import NamedTuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SpecialIds(NamedTuple):
    """What ``Captioner`` decodes with; the benchmark decodes no text."""

    pad_id: int
    start_id: int
    end_id: int


def ids(cfg: dict) -> SpecialIds:
    s = cfg["special_ids"]
    return SpecialIds(s["pad"], s["start"], s["end"])


def model_config(cfg: dict):
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import VisionConfig

    e, dc = cfg["encoder"], cfg["decoder"]
    vision = VisionConfig(
        family=e["family"], image_size=e["image_size"],
        patch_size=e["patch_size"], hidden_size=e["hidden_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"],
        intermediate_size=e["intermediate_size"], hidden_act=e["hidden_act"],
        layer_norm_eps=e["layer_norm_eps"], patch_bias=e["patch_bias"],
        ln_pre=e["ln_pre"], ln_post=e["ln_post"])
    decoder = DecoderConfig(
        vocab_size=dc["vocab_size"], embed_dim=dc["embed_dim"],
        num_heads=dc["num_heads"], num_layers=dc["num_layers"],
        ff_dim=dc["ff_dim"], max_seq_len=dc["max_seq_len"],
        dropout=dc["dropout"], pad_idx=cfg["special_ids"]["pad"])
    return ModelConfig(cfg["encoder_name"], vision, decoder,
                       cfg["routes"]["memory_mode"])


def compute_dtype(cfg: dict):
    return DTYPES[cfg["compute_dtype"]]


def captioner(cfg: dict, weights: dict):
    from mit_tpu_torch.decode.api import Captioner

    r = cfg["routes"]
    return Captioner(weights, model_config(cfg), ids(cfg), compute_dtype(cfg),
                     encoder_quant=r["encoder_quant"],
                     fused_decode=r["fused_decode"],
                     beam_size=cfg.get("beam_size", 3))


def preprocess(cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    from mit_tpu_torch.data.preprocess import device_preprocess

    return device_preprocess(images_u8, cfg["encoder_name"],
                             cfg["encoder"]["image_size"])


def counters() -> dict:
    """The program's own route and launch counters."""
    from mit_tpu_torch.decode.step import decoder_step
    from mit_tpu_torch.ops.attention import multihead_attention
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer
    from mit_tpu_torch.ops.flash_attention import flash_attention_btd

    out = {"decoder_step.routes": dict(decoder_step.routes),
           "multihead_attention.routes": dict(multihead_attention.routes),
           "flash_attention_btd.kernels": dict(flash_attention_btd.kernels)}
    from mit_tpu_torch.ops.dropout_attention import (
        flash_attention_dropout_bwd,
        flash_attention_dropout_fwd,
    )

    out["fused_decode_layer.launches"] = fused_decode_layer.launches
    out["flash_attention_dropout_fwd.launches"] = \
        flash_attention_dropout_fwd.launches
    out["flash_attention_dropout_bwd.kernels"] = \
        dict(flash_attention_dropout_bwd.kernels)
    return out
