"""Transformer decoder (port of ``mit_tpu/models/decoder.py``, inference).

Embedding × √D → sinusoidal positions → post-LN layers (causal + key-pad
self-attention through ``flash_attention_btd``; cross-attention, which
collapses to ``out_proj(v_proj(memory))`` for a length-1 CLS memory; ReLU
FFN) → f32 vocab projection. Parameters keep the JAX tree: layer
parameters stacked on a leading axis, (in, out) matrices. No dropout: the
port has no training step yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mit_tpu_torch.models.convert import layer_params, params_from_jax
from mit_tpu_torch.ops.attention import (
    layer_norm,
    multihead_attention,
    single_key_cross_attention,
)
from mit_tpu_torch.ops.masks import NEG_INF, padding_add
from mit_tpu_torch.ops.positional import sinusoid_table


class DecoderConfig(NamedTuple):
    """Architecture knobs (fields as in the JAX package)."""

    vocab_size: int
    embed_dim: int = 512
    num_heads: int = 8
    num_layers: int = 6
    ff_dim: int = 2048
    max_seq_len: int = 100
    dropout: float = 0.1
    pad_idx: int = 0


def _xavier(generator, shape, fan_in, fan_out):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(*shape, generator=generator) * 2 - 1) * limit


def _init_attn(generator, L, d):
    # torch's packed (3D, D) in_proj is xavier-initialised as one matrix
    packed = torch.stack([_xavier(generator, (d, 3 * d), d, 3 * d)
                          for _ in range(L)])
    wq, wk, wv = packed.split(d, dim=2)
    wo = torch.stack([_xavier(generator, (d, d), d, d) for _ in range(L)])
    zeros = torch.zeros(L, d)
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "bq": zeros, "bk": zeros, "bv": zeros, "bo": zeros}


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        device=None) -> dict:
    """Xavier-uniform matrices (the embedding too), zero biases, unit LN
    scales; drawn on the CPU from ``generator``, then moved to ``device``."""
    v, d, f, L = cfg.vocab_size, cfg.embed_dim, cfg.ff_dim, cfg.num_layers
    ln = lambda: {"scale": torch.ones(L, d), "bias": torch.zeros(L, d)}
    params = {
        "token_embedding": _xavier(generator, (v, d), d, v),
        "layers": {
            "self": _init_attn(generator, L, d),
            "cross": _init_attn(generator, L, d),
            "ffn": {
                "w1": torch.stack([_xavier(generator, (d, f), d, f)
                                   for _ in range(L)]),
                "b1": torch.zeros(L, f),
                "w2": torch.stack([_xavier(generator, (f, d), f, d)
                                   for _ in range(L)]),
                "b2": torch.zeros(L, d),
            },
            "ln1": ln(), "ln2": ln(), "ln3": ln(),
        },
        "fc_out_w": _xavier(generator, (d, v), d, v),
        "fc_out_b": torch.zeros(v),
    }
    return params_from_jax(params, device)


def decoder_forward(
    params: dict,
    cfg: DecoderConfig,
    tgt_tokens: torch.Tensor,             # (B, T) integer ids
    memory: torch.Tensor,                 # (B, S, D)
    memory_padding_mask: Optional[torch.Tensor] = None,  # (B, S) bool, True=pad
    compute_dtype=torch.float32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Teacher-forced full-sequence forward → logits (B, T, V) in f32."""
    b, t = tgt_tokens.shape
    d = cfg.embed_dim
    cd = compute_dtype

    tgt_pad = padding_add(tgt_tokens, cfg.pad_idx)
    single_key = memory.shape[1] == 1 and memory_padding_mask is None
    mem_mask = None
    if memory_padding_mask is not None:
        mem_mask = torch.where(memory_padding_mask, NEG_INF, 0.0)[:, None, None, :]

    emb = params["token_embedding"].to(cd)[tgt_tokens] * torch.tensor(
        math.sqrt(d), dtype=cd
    )
    pos = sinusoid_table(cfg.max_seq_len, d, cd, memory.device)
    x = emb + pos[None, :t]
    mem = memory.to(cd)

    for i in range(cfg.num_layers):
        layer = layer_params(params["layers"], i)
        sa = multihead_attention(
            layer["self"], x, x, cfg.num_heads, compute_dtype=cd,
            use_kernel=use_kernel, causal=True, pad_add=tgt_pad,
        )
        x = layer_norm(layer["ln1"], x + sa)
        if single_key:
            ca = single_key_cross_attention(
                layer["cross"], t, mem, cfg.num_heads, cd
            )
        else:
            ca = multihead_attention(
                layer["cross"], x, mem, cfg.num_heads, mem_mask, cd,
                use_kernel=False,
            )
        x = layer_norm(layer["ln2"], x + ca)
        f = layer["ffn"]
        h = torch.relu(x @ f["w1"].to(cd) + f["b1"].to(cd))
        x = layer_norm(layer["ln3"], x + (h @ f["w2"].to(cd) + f["b2"].to(cd)))

    logits = x.float() @ params["fc_out_w"].float()
    return logits + params["fc_out_b"].float()


def params_from_torch_state_dict(sd: dict, cfg: DecoderConfig,
                                 prefix: str = "", device=None) -> dict:
    """The reference's decoder state dict (``token_embedding.weight``,
    ``transformer_decoder.layers.{i}.self_attn.in_proj_weight``, ...) → the
    port's parameters. torch Linear (out, in) is transposed to (in, out);
    the packed (3D, D) in_proj splits into q/k/v."""

    def get(name):
        a = sd[prefix + name]
        if hasattr(a, "detach"):
            a = a.detach().cpu().float().numpy()
        return np.asarray(a, dtype=np.float32)

    L = cfg.num_layers
    lyr = "transformer_decoder.layers.{i}."

    def attn(i, mod):
        base = lyr.format(i=i) + mod
        wq, wk, wv = np.split(get(base + ".in_proj_weight"), 3, axis=0)
        bq, bk, bv = np.split(get(base + ".in_proj_bias"), 3)
        return {
            "wq": wq.T, "wk": wk.T, "wv": wv.T,
            "wo": get(base + ".out_proj.weight").T,
            "bq": bq, "bk": bk, "bv": bv,
            "bo": get(base + ".out_proj.bias"),
        }

    def stack(dicts):
        return {k: np.stack([x[k] for x in dicts]) for k in dicts[0]}

    def ffn(i):
        base = lyr.format(i=i)
        return {
            "w1": get(base + "linear1.weight").T, "b1": get(base + "linear1.bias"),
            "w2": get(base + "linear2.weight").T, "b2": get(base + "linear2.bias"),
        }

    def ln(n):
        return stack([
            {"scale": get(lyr.format(i=i) + f"norm{n}.weight"),
             "bias": get(lyr.format(i=i) + f"norm{n}.bias")}
            for i in range(L)
        ])

    params = {
        "token_embedding": get("token_embedding.weight"),
        "layers": {
            "self": stack([attn(i, "self_attn") for i in range(L)]),
            "cross": stack([attn(i, "multihead_attn") for i in range(L)]),
            "ffn": stack([ffn(i) for i in range(L)]),
            "ln1": ln(1), "ln2": ln(2), "ln3": ln(3),
        },
        "fc_out_w": get("fc_out.weight").T,
        "fc_out_b": get("fc_out.bias"),
    }
    return params_from_jax(params, device)
