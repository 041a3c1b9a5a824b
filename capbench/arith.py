"""The yardstick's arithmetic: the card's peaks, the least time a kernel
could take (its roofline bound), the model FLOPs of a step, and caption
lengths.

``bound``, ``attention_bound`` and ``decode_layer_bound`` are copies of
``chip_smoke.py``'s, frozen here so that a later change to the program
or the smoke does not move the yardstick. Counts take the shapes as
numbers only; nothing here touches a tensor.
"""

from __future__ import annotations

# peak rates of one H100 SXM (NVIDIA's data sheet, dense), at 700 W
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BF16 = PEAK_OPS["bf16"]


def dtype_size(dtype: str) -> int:
    return 2 if dtype in ("bf16", "bfloat16", "torch.bfloat16") else 4


def ops_kind(dtype: str) -> str:
    return "bf16" if dtype_size(dtype) == 2 else "f32"


def bound(nbytes, ops, kind):
    """The least time the card could take, in ms: the larger of the bytes
    the function must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate for
    their type."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_bound(b, h, t, s, dtype, n_products=2, extra_bytes=0, hd=64):
    """q, k, v read and the output written once; two (T, S, hd) products."""
    size = dtype_size(dtype)
    nbytes = (2 * b * h * t * hd + 2 * b * h * s * hd) * size + extra_bytes
    ops = n_products * 2 * b * h * t * s * hd
    return bound(nbytes, ops, ops_kind(dtype))


def dropout_attention_bwd_bound(b, h, t, s, dtype, hd=64):
    """The backward of attention with dropout: q, k, v and the output's
    gradient read once, the (B, S) pad row read once, dq, dk and dv written
    once; four (T, S, hd) products (dv, dp, dq, dk) and the recomputed
    scores, five in all."""
    size = dtype_size(dtype)
    nbytes = (4 * b * h * t * hd + 2 * b * h * s * hd) * size \
        + 2 * b * h * s * hd * size + b * s * 4
    ops = 5 * 2 * b * h * t * s * hd
    return bound(nbytes, ops, ops_kind(dtype))


def decode_layer_bound(b, t, dtype, d=512, f=2048):
    """Weights, both caches, x, madd and cross read once, three (B, D) rows
    written; four products and the two attention contractions."""
    return decode_layer_bound_rows([t] * b, dtype, d, f)


def decode_layer_bound_rows(keys, dtype, d=512, f=2048):
    """One launch of the decode layer over the rows that are live, row r
    seeing ``keys[r]`` cache positions: the weights read once; for each
    live row its x, position, mask and cross rows and its two caches up to
    its own keys read once, and three (D,) rows written; each row's four
    products and its two attention contractions over its keys."""
    size = dtype_size(dtype)
    weights = (4 * d * d + 2 * d * f) * size + (9 * d + 3 * d + f) * 4
    b, t = len(keys), sum(keys)
    rows = b * (d * size + 4 + d * 4 + 3 * d * size) \
        + t * (4 + 2 * d * size)
    ops = 2 * b * (4 * d * d + 2 * d * f) + 4 * t * d
    return bound(weights + rows, ops, ops_kind(dtype))


# ----------------------------------------------------------------------
# model FLOPs (a multiply-add counts 2), from the configuration's shapes
# ----------------------------------------------------------------------
def encoder_flops_per_image(cfg: dict) -> float:
    """One image through the frozen encoder and the projection in CLS
    memory: the last layer computes keys and values over every token and
    the rest for the CLS row alone, as the model needs."""
    e, dec = cfg["encoder"], cfg["decoder"]
    d, f, L = e["hidden_size"], e["intermediate_size"], e["num_hidden_layers"]
    n = (e["image_size"] // e["patch_size"]) ** 2
    t = n + 1
    pdim = 3 * e["patch_size"] ** 2
    patch = 2 * n * pdim * d
    per_token = 2 * (4 * d * d + 2 * d * f)
    attn = 4 * t * t * d                    # scores and P.V over all heads
    flops = patch + (L - 1) * (t * per_token + attn)
    # the last layer: K and V over every token; Q, out, MLP, attention for one
    flops += 2 * t * 2 * d * d + 2 * (2 * d * d + 2 * d * f) + 4 * t * d
    if d != dec["embed_dim"]:
        flops += 2 * d * dec["embed_dim"]
    return float(flops)


def decoder_flops_per_sequence(cfg: dict) -> float:
    """The CLS cross-attention constant out_proj(v_proj(memory)) of every
    layer: once a caption."""
    dec = cfg["decoder"]
    d, L = dec["embed_dim"], dec["num_layers"]
    return float(L * 2 * 2 * d * d)


def decoder_flops_per_token(cfg: dict, keys: int) -> float:
    """One generated token with ``keys`` self-attention keys visible (its
    position + 1): the QKV, out and FFN products of every layer, the
    attention over the keys, and the vocabulary projection."""
    dec = cfg["decoder"]
    d, f, L, v = (dec["embed_dim"], dec["ff_dim"], dec["num_layers"],
                  dec["vocab_size"])
    return float(L * (2 * (4 * d * d + 2 * d * f) + 4 * keys * d) + 2 * d * v)


def decoder_flops_per_caption(cfg: dict, generated: int) -> float:
    """A caption of ``generated`` tokens after START: its cross constant
    and each token at its own number of visible keys (1, 2, ...)."""
    dec = cfg["decoder"]
    d, f, L, v = (dec["embed_dim"], dec["ff_dim"], dec["num_layers"],
                  dec["vocab_size"])
    n = generated
    per_token = L * 2 * (4 * d * d + 2 * d * f) + 2 * d * v
    return decoder_flops_per_sequence(cfg) + float(
        n * per_token + 4 * L * d * n * (n + 1) // 2)


def train_flops_per_step(cfg: dict, batch: int, t: int) -> float:
    """Forward and backward (twice the forward) of the decoder and the
    projection over a (batch, t) teacher-forced batch from cached CLS
    features: every position is computed, PAD rows too; the causal
    self-attention counts its full (t, t) products, as computed."""
    e, dec = cfg["encoder"], cfg["decoder"]
    d, f, L, v = (dec["embed_dim"], dec["ff_dim"], dec["num_layers"],
                  dec["vocab_size"])
    tokens = batch * t
    fwd = tokens * (L * 2 * (4 * d * d + 2 * d * f) + 2 * d * v)
    fwd += L * 4 * batch * t * t * d
    fwd += batch * L * 2 * 2 * d * d               # single-key cross attention
    if e["hidden_size"] != d:
        fwd += 2 * batch * e["hidden_size"] * d     # the projection
    return float(3 * fwd)


# ----------------------------------------------------------------------
# captions
# ----------------------------------------------------------------------
def caption_length(tokens, end_id: int) -> int:
    """Tokens a caption, START and END included (up to the first END)."""
    tokens = list(tokens)
    return tokens.index(end_id) + 1 if end_id in tokens else len(tokens)


def length_summary(lengths) -> dict:
    """Mean, quartiles, 95th percentile and the extremes of lengths."""
    xs = sorted(int(x) for x in lengths)
    if not xs:
        return {"n": 0}
    at = lambda q: xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]
    return {"n": len(xs), "mean": sum(xs) / len(xs), "min": xs[0],
            "p25": at(0.25), "p50": at(0.5), "p75": at(0.75),
            "p95": at(0.95), "max": xs[-1]}


def per_second(times) -> list:
    """How many of ``times`` (seconds from a window's start) fall in each
    whole second."""
    out: list = []
    for t in times:
        i = int(t)
        out.extend([0] * (i + 1 - len(out)))
        out[i] += 1
    return out
