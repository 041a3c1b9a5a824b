"""Multi-head latent attention (MLA), as DeepSeek-V3 and Kimi-VL publish it
with ``q_lora_rank`` null and no bias; no counterpart in the JAX package.

    q = W_q h                              → per head q_nope | q_pe
    c_kv | k_pe = W_kva h                  → c_kv RMSNormed, k_pe one rotary
                                              key shared by every head
    k_nope | v = W_kvb c_kv                → per head

RoPE rotates ``q_pe`` and ``k_pe``: the published modelling code
de-interleaves the rope dims and applies ``rotate_half``, which turns each
adjacent pair (2i, 2i + 1) by θ^(-2i/d) · position and lays the results out
apart; here the pairs turn in place, as one complex product, so the cache
keeps ``k_pe`` in the pairs' order. Every dot product ``q_pe·k_pe`` is the
same. The scores are ``q_nope·k_nope + q_pe·k_pe`` over √(nope + rope),
causal.

The prefill and the decode step share this module and its projections.
Both keep the latent cache, ``c_kv`` after its norm and ``k_pe`` after
RoPE: rank + rope values a token (576 in Kimi-VL), not 2 · heads · 128.
The decode step works in the absorbed form: ``q_nope · W_uk`` is scored
against ``c_kv`` itself, the probabilities weigh ``c_kv`` and ``W_uv``
maps the result to each head's values. At the captioner's lengths (up to
112 keys) the attention itself is a few batched matrix products.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: normalized in f32, cast to the weight's dtype, then scaled
    (the published order)."""
    y = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return w * y.to(w.dtype)


def apply_rope(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """(..., T, d) → each adjacent pair turned by ``cis`` (T, d / 2), unit
    complex numbers, in f32 and cast back."""
    xc = torch.view_as_complex(
        x.float().contiguous().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * cis).flatten(-2).to(x.dtype)


def _project(p: dict, h: torch.Tensor, cfg, cis):
    """h (B, T, D) → q_nope (B, T, H, nope), q_pe (B, H, T, rope) roped,
    latent (B, T, rank + rope): c_kv normed | k_pe roped. ``p``: the
    layer's operands (``models.kimi_vl.prepare``)."""
    b, t, _ = h.shape
    nh, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim)
    q = (h @ p["wq"]).reshape(b, t, nh, nope + rope)
    q_pe = apply_rope(q[..., nope:].transpose(1, 2), cis)
    kva = h @ p["wkva"]
    c_kv = rms_norm(kva[..., :cfg.kv_lora_rank], p["kv_norm"],
                    cfg.rms_norm_eps)
    k_pe = apply_rope(kva[..., cfg.kv_lora_rank:], cis)
    return q[..., :nope], q_pe, torch.cat([c_kv, k_pe], dim=-1)


def _softmax(scores: torch.Tensor, dtype) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def mla_prefill(p: dict, h: torch.Tensor, cfg, cis,
                cache: torch.Tensor) -> torch.Tensor:
    """Causal MLA over h (B, T, D) at positions 0..T-1 → (B, T, D);
    writes the latent rows into ``cache`` (B, S, rank + rope) at 0..T-1."""
    b, t, _ = h.shape
    nh, nope, rope, vd = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                          cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_pe, latent = _project(p, h, cfg, cis)
    cache[:, :t] = latent
    kv = (latent[..., :cfg.kv_lora_rank] @ p["wkvb"]).reshape(
        b, t, nh, nope + vd).transpose(1, 2)
    k_pe = latent[..., cfg.kv_lora_rank:][:, None].expand(b, nh, t, rope)
    q = torch.cat([q_nope.transpose(1, 2), q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(nope + rope)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    scores = scores.masked_fill(causal, float("-inf"))
    ctx = _softmax(scores, h.dtype) @ kv[..., nope:]
    return ctx.transpose(1, 2).reshape(b, t, nh * vd) @ p["wo"]


def mla_decode(p: dict, h: torch.Tensor, cfg, cis, cache: torch.Tensor,
               pos: torch.Tensor, future: torch.Tensor) -> torch.Tensor:
    """One token a row, h (B, 1, D) at ``pos`` (a 0-dim int64 tensor), in
    the absorbed form → (B, 1, D); writes its latent row into ``cache`` at
    ``pos`` and attends over the whole cache with ``future`` (S,) bool, the
    positions past ``pos``, masked. ``p["w_uk_t"]`` (H, nope, rank) and
    ``p["w_uv"]`` (H, rank, v) are the two halves of the layer's ``wkvb``."""
    b = h.shape[0]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe, latent = _project(p, h, cfg, cis)
    cache.index_copy_(1, pos.view(1), latent)
    # (H, B, nope) @ (H, nope, rank): each head's query in latent space
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), p["w_uk_t"]) \
        .transpose(0, 1)
    q_all = torch.cat([q_lat, q_pe[:, :, 0]], dim=-1)       # (B, H, r + rope)
    scores = torch.bmm(q_all, cache.transpose(1, 2)).float() \
        / math.sqrt(nope + rope)
    probs = _softmax(scores.masked_fill(future, float("-inf")), h.dtype)
    ctx = torch.bmm(probs, cache[..., :cfg.kv_lora_rank])   # (B, H, rank)
    out = torch.bmm(ctx.transpose(0, 1), p["w_uv"])          # (H, B, v)
    return out.transpose(0, 1).reshape(b, 1, -1) @ p["wo"]
