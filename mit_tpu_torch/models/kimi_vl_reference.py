"""Plain float32 reference of Kimi-VL-A3B's projector and language model,
written from the published modelling code (``modeling_kimi_vl.py``, whose
language model is DeepSeek-V3's) for the tests of
:mod:`mit_tpu_torch.models.kimi_vl`: plain ``torch``, one sequence at a
time, the whole causal forward at every call, no cache, no kernel. It
imports nothing of ``mit_tpu_torch.ops`` or ``.kernels``; parameters are
read from the port's tree (``(in, out)`` matrices, layers stacked) and
upcast to float32, and ``cfg`` is anything with the config's fields.

Departures from the published code:

- everything runs in float32 (the published model runs in bf16, with the
  router, softmax, RMSNorm and RoPE in float32);
- the vision tower is whatever the caller's features come from (the port
  feeds CLIP ViT-L/14's patches in place of MoonViT's), and the image
  tokens are a prefix of the sequence rather than placeholders replaced in
  the embedded prompt (the same sequence for an image-first prompt);
- group-limited routing is left out: with ``n_group`` = ``topk_group`` = 1
  it chooses every expert.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms_norm(x, w, eps):
    return _f(w) * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * _f(scale) + _f(bias)


def project(pp: dict, cfg, features: torch.Tensor) -> torch.Tensor:
    """The vision tower's last hidden state (N + 1, w), CLS first → image
    tokens (N / merge², D): ``pre_norm`` on every patch, the published
    ``patch_merger`` (row-major blocks, each block's patches row-major),
    ``linear_1``, exact GELU, ``linear_2``."""
    x = layer_norm(features[1:].float(), pp["ln_scale"], pp["ln_bias"],
                   cfg.projector_eps)
    n, w = x.shape
    g, m = math.isqrt(n), cfg.merge
    blocks = []
    for bi in range(g // m):
        for bj in range(g // m):
            blocks.append(torch.cat([x[(bi * m + i) * g + bj * m + j]
                                     for i in range(m) for j in range(m)]))
    x = torch.stack(blocks)
    x = F.gelu(x @ _f(pp["w1"]) + _f(pp["b1"]))
    return x @ _f(pp["w2"]) + _f(pp["b2"])


def rope(x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., S, d) at positions 0..S-1: the published
    ``apply_rotary_pos_emb`` (de-interleave, then rotate_half)."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2).float() / d))
    freqs = torch.arange(s).float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1).to(x.device)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def attention(lay: dict, i: int, h: torch.Tensor, cfg) -> torch.Tensor:
    """Causal MLA over h (S, D), the published form (k and v expanded from
    the latent for every head)."""
    s = h.shape[0]
    nh, nope, rp, vd, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                           cfg.qk_rope_head_dim, cfg.v_head_dim,
                           cfg.kv_lora_rank)
    q = (h @ _f(lay["wq"][i])).reshape(s, nh, nope + rp).transpose(0, 1)
    kva = h @ _f(lay["wkva"][i])
    c_kv = rms_norm(kva[:, :r], lay["kv_norm"][i], cfg.rms_norm_eps)
    k_pe = rope(kva[:, r:], cfg)                                  # (S, rope)
    kv = (c_kv @ _f(lay["wkvb"][i])).reshape(s, nh, nope + vd).transpose(0, 1)
    qs = torch.cat([q[..., :nope], rope(q[..., nope:], cfg)], dim=-1)
    ks = torch.cat([kv[..., :nope], k_pe[None].expand(nh, s, rp)], dim=-1)
    scores = qs @ ks.transpose(-1, -2) / math.sqrt(nope + rp)
    causal = torch.triu(torch.ones(s, s, dtype=torch.bool,
                                   device=h.device), 1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    ctx = (p @ kv[..., nope:]).transpose(0, 1).reshape(s, nh * vd)
    return ctx @ _f(lay["wo"][i])


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ _f(wg)) * (x @ _f(wu))) @ _f(wd)


def route(x, router, bias, cfg):
    """(experts (S, k), weights (S, k)): sigmoid scores, the top k chosen
    on score + correction bias, weighed by the chosen scores renormalized
    and scaled."""
    s = torch.sigmoid(x @ _f(router))
    idx = torch.topk(s + _f(bias), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def moe(moe_p: dict, j: int, x: torch.Tensor, cfg) -> torch.Tensor:
    """Every expert evaluated on the tokens routed to it, weighed and
    summed, plus the shared experts."""
    idx, w = route(x, moe_p["router"][j], moe_p["router_bias"][j], cfg)
    out = torch.zeros_like(x)
    for e in range(cfg.n_routed_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], moe_p["w_gate"][j][e], moe_p["w_up"][j][e],
                       moe_p["w_down"][j][e])
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out + swiglu(x, moe_p["shared_gate"][j], moe_p["shared_up"][j],
                        moe_p["shared_down"][j])


def forward(lm: dict, cfg, image_tokens: torch.Tensor,
            ids) -> torch.Tensor:
    """Logits (P + T, V) of the sequence ``[image_tokens (P, D); ids
    (T,)]``, row j predicting position j + 1."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=image_tokens.device)
    x = torch.cat([image_tokens.float(), _f(lm["embed"])[ids]])
    lay, nd = lm["layers"], cfg.first_k_dense_replace
    for i in range(cfg.num_hidden_layers):
        x = x + attention(lay, i, rms_norm(x, lay["attn_norm"][i],
                                           cfg.rms_norm_eps), cfg)
        h = rms_norm(x, lay["mlp_norm"][i], cfg.rms_norm_eps)
        if i < nd:
            dn = lm["dense"]
            x = x + swiglu(h, dn["w_gate"][i], dn["w_up"][i], dn["w_down"][i])
        else:
            x = x + moe(lm["moe"], i - nd, h, cfg)
    return rms_norm(x, lm["norm"], cfg.rms_norm_eps) @ _f(lm["lm_head"])
