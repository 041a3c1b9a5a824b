"""Multi-head attention and LayerNorm (port of ``mit_tpu/ops/attention.py``).

torch ``nn.MultiheadAttention`` semantics with (in, out) projection
matrices: ``params = {wq, wk, wv, wo: (D, D); bq, bk, bv, bo: (D,)}``.
Inference only: the port has no attention dropout yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mit_tpu_torch.ops.flash_attention import flash_attention_btd
from mit_tpu_torch.ops.masks import causal_mask


def _linear(x, params, w, b, cd):
    return x.to(cd) @ params[w].to(cd) + params[b].to(cd)


def multihead_attention(
    params: dict,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    use_kernel: bool = True,
    causal: bool = False,
    pad_add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q_in (B, T, D) attends over kv_in (B, S, D) → (B, T, D).

    ``use_kernel`` (``use_flash`` in the JAX package) sends the
    score/mask/softmax/P·V chain through :func:`flash_attention_btd`, with
    the mask given structurally as ``causal`` + per-key ``pad_add`` (B, S).
    Otherwise the plain path runs, which also takes a materialized additive
    ``mask`` broadcastable to (B, H, T, S).
    """
    cd = compute_dtype
    b, t, d = q_in.shape
    s = kv_in.shape[1]
    hd = d // num_heads
    q = _linear(q_in, params, "wq", "bq", cd)
    k = _linear(kv_in, params, "wk", "bk", cd)
    v = _linear(kv_in, params, "wv", "bv", cd)

    if use_kernel:
        if mask is not None:
            raise ValueError(
                "the kernel path takes causal/pad_add, not a dense mask"
            )
        out = flash_attention_btd(q, k, v, pad_add, causal, hd)
        return out @ params["wo"].to(cd) + params["bo"].to(cd)

    split = lambda x: x.reshape(b, -1, num_heads, hd).transpose(1, 2)
    if mask is None and (causal or pad_add is not None):
        mask = torch.zeros((1, 1, t, s), dtype=torch.float32, device=q.device)
        if causal:
            mask = mask + causal_mask(t, s, q.device)
        if pad_add is not None:
            mask = mask + pad_add[:, None, None, :]
    # f32 scores and P·V accumulation from compute-dtype operands (the JAX
    # einsums' preferred_element_type=f32): upcasting is exact.
    scores = torch.einsum(
        "bhtd,bhsd->bhts", split(q).float(), split(k).float()
    ) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum(
        "bhts,bhsd->bhtd", probs.to(cd).float(), split(v).float()
    ).to(cd)
    out = ctx.transpose(1, 2).reshape(b, t, d)
    return out @ params["wo"].to(cd) + params["bo"].to(cd)


def single_key_cross_attention(
    params: dict,
    q_len: int,
    kv_in: torch.Tensor,
    num_heads: int,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Cross-attention over a memory of length 1 (CLS-only mode).

    softmax over one key is 1, so every query's context is that key's value:
    ``out_proj(v_proj(memory))`` broadcast over the q_len positions.
    kv_in: (B, 1, D). Returns (B, q_len, D).
    """
    b, s, d = kv_in.shape
    if s != 1:
        raise ValueError(f"single_key_cross_attention needs memory length 1, got {s}")
    v = _linear(kv_in, params, "wv", "bv", compute_dtype)
    out = _linear(v, params, "wo", "bo", compute_dtype)
    return out.expand(b, q_len, d)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
