"""Plain float32 reference of Kimi-VL-A3B's language model and projector
behind the CLIP ViT-L/14 tower, for the cell ``kimivl.batch64-greedy``.

Written from the published modelling code (``modeling_kimi_vl.py``, its
language model DeepSeek-V3's) and independent of the program: RMSNorm;
latent attention with ``q_lora_rank`` null (``q = W_q h`` split into
``q_nope`` 128 and ``q_pe`` 64 a head; ``c_kv | k_pe = W_kva h``, ``c_kv``
RMSNormed; ``k_nope | v = W_kvb c_kv``; RoPE with θ from the config on
``q_pe`` and the shared ``k_pe``, the rope dims de-interleaved before
``rotate_half``; softmax over √192, causal); SwiGLU FFNs, dense in the
first ``first_k_dense_replace`` layers, else a sigmoid router in float32
(top-k on score + correction bias, the chosen scores renormalized and
scaled by ``routed_scaling_factor``), every expert evaluated on the tokens
routed to it, plus the shared experts; the final RMSNorm and ``lm_head``.
The projector LayerNorms each patch of the tower's last hidden state (CLS
dropped), merges 2 x 2 patches row-major, then ``Linear -> GELU (erf) ->
Linear``. The image tokens are the prefix of the sequence.

It runs layer by layer over all the sequences at once, each layer's
weights read from the benchmark's bf16 tensors and upcast for that layer
alone, so that it fits beside the kept weights. Every product but the
router's goes through an :class:`~capbench.reference.model.Arith`: float32
(TF32 off for matmul and cuDNN, set here), or the control's fp8. The
router stays in float32, the precision the configuration states for it.

Departures from the published model: the vision tower (CLIP ViT-L/14 at
224 px in place of MoonViT at native resolution), and everything in
float32. ``fault`` plants one of the check's routing faults: the choice
made without the correction bias ("no_correction_bias"), or the weights
left unrenormalized ("no_renormalization").
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from capbench.reference.model import (
    F32,
    Arith,
    attention as mha,
    layer_norm,
    preprocess,
)

FAULTS = ("no_correction_bias", "no_renormalization")


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def tower(enc: dict, e: dict, pixels: torch.Tensor, ar: Arith = F32):
    """(B, 3, H, W) normalized pixels → the tower's last hidden state
    (B, N + 1, w), CLS first: the pre-LN ViT of ``model.encode`` over every
    token."""
    b = pixels.shape[0]
    p, d = e["patch_size"], e["hidden_size"]
    gh, gw = pixels.shape[2] // p, pixels.shape[3] // p
    x = pixels.reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = ar.mm(x.reshape(b, gh * gw, 3 * p * p), enc["patch_w"])
    if e["patch_bias"]:
        x = x + enc["patch_b"]
    x = torch.cat([enc["cls"].float().expand(b, 1, d), x], dim=1)
    x = x + enc["pos"].float()[None]
    eps = e["layer_norm_eps"]
    if e["ln_pre"]:
        x = layer_norm(x, enc["ln_pre"]["scale"], enc["ln_pre"]["bias"], eps)
    lay, a = enc["layers"], enc["layers"]["attn"]
    act = ((lambda y: y * torch.sigmoid(1.702 * y))
           if e["hidden_act"] == "quick_gelu" else F.gelu)
    for i in range(e["num_hidden_layers"]):
        h = layer_norm(x, lay["ln1"]["scale"][i], lay["ln1"]["bias"][i], eps)
        q, k, v = (ar.mm(h, a[w][i]) + a[bb][i] for w, bb in
                   (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        x = x + ar.mm(mha(q, k, v, e["num_attention_heads"], ar),
                      a["wo"][i]) + a["bo"][i]
        h = layer_norm(x, lay["ln2"]["scale"][i], lay["ln2"]["bias"][i], eps)
        h = act(ar.mm(h, lay["fc1"][i]) + lay["b1"][i])
        x = x + ar.mm(h, lay["fc2"][i]) + lay["b2"][i]
    if e["ln_post"]:
        x = layer_norm(x, enc["ln_post"]["scale"], enc["ln_post"]["bias"], eps)
    return x


def project(pp: dict, lm: dict, feats: torch.Tensor, ar: Arith = F32):
    """(B, N + 1, w) → image tokens (B, N / 4, D)."""
    m = lm["merge"]
    x = layer_norm(feats[:, 1:], _f(pp["ln_scale"]), _f(pp["ln_bias"]),
                   lm["projector_eps"])
    b, n, w = x.shape
    g = math.isqrt(n)
    rows = []
    for bi in range(g // m):
        for bj in range(g // m):
            rows.append(torch.cat([x[:, (bi * m + i) * g + bj * m + j]
                                   for i in range(m) for j in range(m)], -1))
    x = torch.stack(rows, dim=1)
    x = F.gelu(ar.mm(x, pp["w1"]) + _f(pp["b1"]))
    return ar.mm(x, pp["w2"]) + _f(pp["b2"])


def rms_norm(x, w, eps):
    return _f(w) * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, d) at positions 0..S-1, the published
    ``apply_rotary_pos_emb``."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float()
                           / d))
    freqs = torch.arange(s, device=x.device).float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def attention(lay: dict, i: int, h: torch.Tensor, c: dict, ar: Arith):
    """Causal latent attention over h (B, S, D), the published form."""
    b, s, _ = h.shape
    nh, nope, rp, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"],
                           c["qk_rope_head_dim"], c["v_head_dim"],
                           c["kv_lora_rank"])
    q = ar.mm(h, lay["wq"][i]).reshape(b, s, nh, nope + rp).transpose(1, 2)
    kva = ar.mm(h, lay["wkva"][i])
    c_kv = rms_norm(kva[..., :r], lay["kv_norm"][i], c["rms_norm_eps"])
    k_pe = rope(kva[..., r:], c["rope_theta"])                # (B, S, rope)
    kv = ar.mm(c_kv, lay["wkvb"][i]).reshape(b, s, nh, nope + vd) \
        .transpose(1, 2)
    qs = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    ks = torch.cat([kv[..., :nope], k_pe[:, None].expand(b, nh, s, rp)], -1)
    scores = ar.mm(qs, ks.transpose(-1, -2)) / math.sqrt(nope + rp)
    causal = torch.triu(torch.ones(s, s, dtype=torch.bool, device=h.device),
                        1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    ctx = ar.mm(p, kv[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd)
    return ar.mm(ctx, lay["wo"][i])


def swiglu(x, wg, wu, wd, ar: Arith):
    return ar.mm(F.silu(ar.mm(x, wg)) * ar.mm(x, wu), wd)


def moe(mp: dict, j: int, x: torch.Tensor, c: dict, ar: Arith,
        fault: str = None) -> torch.Tensor:
    """x (T, D) → the routed experts weighed and summed, plus the shared
    experts. The router in float32."""
    s = torch.sigmoid(x @ _f(mp["router"][j]))
    choice = s if fault == "no_correction_bias" else \
        s + _f(mp["router_bias"][j])
    idx = torch.topk(choice, c["num_experts_per_tok"], dim=-1).indices
    w = s.gather(1, idx)
    if c["norm_topk_prob"] and fault != "no_renormalization":
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], mp["w_gate"][j][e], mp["w_up"][j][e],
                       mp["w_down"][j][e], ar)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out + swiglu(x, mp["shared_gate"][j], mp["shared_up"][j],
                        mp["shared_down"][j], ar)


def lm_logits(w: dict, c: dict, image_tokens: torch.Tensor,
              ids: torch.Tensor, first: int, ar: Arith = F32,
              fault: str = None) -> torch.Tensor:
    """Logits (B, S - first, V) at positions ``first``.. of the sequences
    ``[image_tokens (B, P, D); ids (B, T)]``, S = P + T."""
    lm = w["lm"]
    x = torch.cat([image_tokens.float(), _f(lm["embed"])[ids]], dim=1)
    b, s, d = x.shape
    lay, nd, eps = lm["layers"], c["first_k_dense_replace"], c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        x = x + attention(lay, i, rms_norm(x, lay["attn_norm"][i], eps), c, ar)
        h = rms_norm(x, lay["mlp_norm"][i], eps).reshape(b * s, d)
        if i < nd:
            dn = lm["dense"]
            f = swiglu(h, dn["w_gate"][i], dn["w_up"][i], dn["w_down"][i], ar)
        else:
            f = moe(lm["moe"], i - nd, h, c, ar, fault)
        x = x + f.reshape(b, s, d)
    return ar.mm(rms_norm(x[:, first:], lm["norm"], eps), lm["lm_head"])


def caption_logits(w: dict, cfg: dict, c: dict, images_u8: torch.Tensor,
                   prompt: torch.Tensor, captions: torch.Tensor,
                   ar: Arith = F32, fault: str = None) -> torch.Tensor:
    """Teacher-forced logits (n, G, V) of the generated tokens ``captions``
    (n, G) from their uint8 images: row g predicts token g, after the image
    tokens, the prompt (T,) and the tokens before it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels = preprocess(images_u8, cfg["preprocess"])
    img = project(w["projector"], c, tower(w["encoder"], cfg["encoder"],
                                           pixels, ar), ar)
    n = images_u8.shape[0]
    ids = torch.cat([prompt[None].expand(n, -1), captions[:, :-1]], dim=1)
    first = img.shape[1] + prompt.shape[0] - 1
    return lm_logits(w, c, img, ids, first, ar, fault)
