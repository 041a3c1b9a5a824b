"""The yardstick's arithmetic for the vision-language cell: model FLOPs of
a batch (the vision tower over every token, the projector, the language
model's prefill and decode tokens at their own key counts) and the grouped
expert kernel's roofline bound. Counts take the configuration's shapes as
numbers only; nothing here touches a tensor. The card's peaks are
``arith``'s."""

from __future__ import annotations

from capbench.arith import PEAK_BF16, bound  # noqa: F401 (PEAK_BF16: mfu)


def tower_flops_per_image(cfg: dict) -> float:
    """The vision tower over all its tokens in every layer: patches, then
    per token the QKV, out and MLP products, and the scores and P.V over
    every token."""
    e = cfg["encoder"]
    d, f, L = e["hidden_size"], e["intermediate_size"], e["num_hidden_layers"]
    n = (e["image_size"] // e["patch_size"]) ** 2
    t = n + 1
    patch = 2 * n * 3 * e["patch_size"] ** 2 * d
    return float(patch + L * (t * 2 * (4 * d * d + 2 * d * f)
                              + 4 * t * t * d))


def projector_flops_per_image(cfg: dict, c: dict) -> float:
    """Two products a merged token: (4w → 4w) and (4w → D)."""
    e = cfg["encoder"]
    n = (e["image_size"] // e["patch_size"]) ** 2 // c["merge"] ** 2
    w4 = c["vision_width"] * c["merge"] ** 2
    return float(n * 2 * (w4 * w4 + w4 * c["hidden_size"]))


def lm_token_flops(c: dict, keys: int, logits: bool) -> float:
    """One token of the language model seeing ``keys`` positions: in every
    layer the four attention products (q, kv_a, kv_b, o), the scores over
    192 dims and the values over 128 a head; the dense FFN or the router,
    six routed experts and the shared experts; with ``logits`` the
    ``lm_head``."""
    d, h, L = c["hidden_size"], c["num_attention_heads"], \
        c["num_hidden_layers"]
    nope, rp, vd, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                       c["v_head_dim"], c["kv_lora_rank"])
    nd = c["first_k_dense_replace"]
    attn = 2 * (d * h * (nope + rp) + d * (r + rp) + r * h * (nope + vd)
                + h * vd * d) + 2 * keys * h * (nope + rp + vd)
    dense = 3 * 2 * d * c["intermediate_size"]
    routed = (2 * d * c["n_routed_experts"]
              + c["num_experts_per_tok"] * 3 * 2 * d
              * c["moe_intermediate_size"]
              + 3 * 2 * d * c["moe_intermediate_size"] * c["n_shared_experts"])
    out = L * attn + nd * dense + (L - nd) * routed
    if logits:
        out += 2 * d * c["vocab_size"]
    return float(out)


def caption_flops(c: dict, t0: int, new_tokens: int) -> float:
    """A caption: the prefill of ``t0`` positions (logits at the last only),
    then ``new_tokens`` - 1 decode tokens, each with logits."""
    pre = sum(lm_token_flops(c, p, p == t0) for p in range(1, t0 + 1))
    dec = sum(lm_token_flops(c, t0 + j, True)
              for j in range(1, new_tokens))
    return pre + dec


def batch_flops(cfg: dict, c: dict, batch: int, t0: int,
                new_tokens: int) -> float:
    return batch * (tower_flops_per_image(cfg)
                    + projector_flops_per_image(cfg, c)
                    + caption_flops(c, t0, new_tokens))


def experts_bound(rows: float, hit: float, d: int, f: int) -> dict:
    """The grouped expert kernel's least time over calls that routed
    ``rows`` rows in all and hit ``hit`` experts in all: the hit experts'
    three bf16 (D, F) matrices and the rows in and out (bf16) once; 2 x 3
    x D x F operations a row."""
    return bound(hit * 3 * d * f * 2 + rows * d * 2 * 2,
                 2 * 3 * d * f * rows, "bf16")
