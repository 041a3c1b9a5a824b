"""Single-token decoder step with a KV cache (port of
``mit_tpu/decode/step.py``).

Self-attention keys and values live in L per-layer (B, T_max, D) buffers,
heads as column blocks. A step writes this token's fresh K/V row into the
cache in place, then attends over the cache; the JAX package instead attends
over the stale cache with a fresh-row correction and scatters at the end,
which only serves to stop XLA's defensive cache copies — the result is the
same. The cross-attention is precomputed once per sequence by
:func:`init_cache`: in CLS memory mode a per-layer constant (softmax over one
key is 1); over full-sequence or padded memory the projected memory keys and
values, (L, B, H, S, hd), attended every step with the memory's additive
padding mask.

``pos`` is an int, or a (B,) tensor of per-row positions (the service's
slots, each at its own position), on either route: the fresh rows go to
``(row, pos[row])``, a row sees keys ``t <= pos[row]``, and nothing is read
back to the host.

``decoder_step(..., fused=True)`` is the JAX package's ``MIT_FUSED_DECODE``
route: every layer runs :func:`~mit_tpu_torch.ops.decode_layer.
fused_decode_layer`, one kernel launch per layer on a CUDA device, which
also writes the fresh K/V rows into the caches. Its bf16 numerics are the
kernel's, not the unfused step's (f32 fresh rows at ``t == pos``,
unrounded probabilities, an f32 residual stream). The switch is an
argument, never the environment: only the CLI reads ``MIT_FUSED_DECODE``.
On a CUDA device, at a geometry the kernel does not take (:func:`~mit_tpu_torch.
ops.decode_layer.decode_layer_supported`), the step runs unfused, as the JAX
package's does on a TPU where its kernel does not fit; on the CPU the fused
layers' plain version runs at any geometry, as the JAX package's kernel does
in interpret mode. The fused kernel takes the CLS cross constant only, so a
step over full memory runs unfused, as the JAX package's does.
:func:`step_route` makes the choice, from the memory mode, the device type
and the geometry alone and before anything is launched, and
``decoder_step.routes`` counts the steps each route took.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mit_tpu_torch.models.convert import layer_params
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.ops.attention import layer_norm
from mit_tpu_torch.ops.decode_layer import (
    decode_layer_supported,
    fused_decode_layer,
    pack_decode_layers,
    positions,
    write_rows,
)
from mit_tpu_torch.ops.masks import NEG_INF
from mit_tpu_torch.ops.positional import sinusoid_table
from mit_tpu_torch.utils.profiling import span


class DecodeCache(NamedTuple):
    """Per-generation state. ``k`` and ``v`` are written in place. CLS
    memory fills ``cross_const``, full memory the other three."""

    k: list                            # L × (B, T_max, D) self-attn keys
    v: list                            # L × (B, T_max, D) self-attn values
    cross_const: Optional[torch.Tensor] = None  # (L, B, D) CLS-mode constant
    cross_k: Optional[torch.Tensor] = None      # (L, B, H, S, hd) memory keys
    cross_v: Optional[torch.Tensor] = None      # (L, B, H, S, hd) memory values
    cross_mask: Optional[torch.Tensor] = None   # (B, 1, S) f32 additive


def cross_const(cross: dict, memory: torch.Tensor, compute_dtype) -> torch.Tensor:
    """CLS memory (B, 1, D) → the (L, B, D) cross-attention output
    ``out_proj(v_proj(memory))`` of every layer, in ``compute_dtype``."""
    cd = compute_dtype
    vv = torch.einsum("bsd,lde->lbse", memory.to(cd), cross["wv"].to(cd))
    vv = vv + cross["bv"].to(cd)[:, None, None, :]
    out = torch.einsum("lbse,lef->lbsf", vv, cross["wo"].to(cd))
    out = out + cross["bo"].to(cd)[:, None, None, :]
    return out[:, :, 0, :]


def cross_kv(cross: dict, memory: torch.Tensor, num_heads: int,
             compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory (B, S, D) → its projected keys and values, each
    (L, B, H, S, hd) in ``compute_dtype``: the JAX ``init_cache``'s operand
    casts, contraction and head transpose."""
    cd = compute_dtype
    mem = memory.to(cd)
    ck = torch.einsum("bsd,lde->lbse", mem, cross["wk"].to(cd))
    ck = ck + cross["bk"].to(cd)[:, None, None, :]
    cv = torch.einsum("bsd,lde->lbse", mem, cross["wv"].to(cd))
    cv = cv + cross["bv"].to(cd)[:, None, None, :]
    L, b, s, d = ck.shape
    heads = lambda a: a.reshape(L, b, s, num_heads, d // num_heads) \
        .permute(0, 1, 3, 2, 4).contiguous()
    return heads(ck), heads(cv)


def init_cache(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, S, D) projected decoder memory
    memory_padding_mask: Optional[torch.Tensor] = None,   # (B, S) True = PAD
    max_len: Optional[int] = None,
    compute_dtype=torch.float32,
) -> DecodeCache:
    """Allocate the KV cache and precompute the cross-attention terms: the
    CLS constant for unpadded (B, 1, D) memory, else the memory's keys,
    values and padding mask (the JAX package's rule)."""
    cd = compute_dtype
    b, s, d = memory.shape
    t_max = max_len or cfg.max_seq_len
    if t_max > cfg.max_seq_len:
        raise ValueError(
            f"max_len={t_max} exceeds the positional table "
            f"(max_seq_len={cfg.max_seq_len})"
        )
    zeros = lambda: torch.zeros(b, t_max, d, dtype=cd, device=memory.device)
    k = [zeros() for _ in range(cfg.num_layers)]
    v = [zeros() for _ in range(cfg.num_layers)]
    cross = params["layers"]["cross"]
    if s == 1 and memory_padding_mask is None:
        return DecodeCache(k, v, cross_const(cross, memory, cd))
    ck, cv = cross_kv(cross, memory, cfg.num_heads, cd)
    cmask = None
    if memory_padding_mask is not None:
        # -1e9, not -inf: a row of all PAD gets a finite, uniform softmax
        cmask = torch.where(memory_padding_mask.bool(), NEG_INF, 0.0)[:, None, :]
    return DecodeCache(k, v, None, ck, cv, cmask)


def prepare_decode_params(params: dict, compute_dtype=torch.float32,
                          fused: bool = False) -> dict:
    """Cast the weights to the compute dtype and fuse Q/K/V, once per
    generation rather than once per step. LayerNorm parameters and the
    logits bias stay f32. With ``fused`` the result also holds the fused
    kernel's per-layer operands (``"fused_layers"``)."""
    cd = compute_dtype
    layers = params["layers"]
    s, c, f = layers["self"], layers["cross"], layers["ffn"]
    f32 = lambda p: {"scale": p["scale"].float(), "bias": p["bias"].float()}
    out = {
        "emb": params["token_embedding"].to(cd),
        "layers": {
            "wqkv": torch.cat([s["wq"], s["wk"], s["wv"]], -1).to(cd),
            "bqkv": torch.cat([s["bq"], s["bk"], s["bv"]], -1).to(cd),
            "wo": s["wo"].to(cd), "bo": s["bo"].to(cd),
            "cross_wq": c["wq"].to(cd), "cross_bq": c["bq"].to(cd),
            "cross_wo": c["wo"].to(cd), "cross_bo": c["bo"].to(cd),
            "w1": f["w1"].to(cd), "b1": f["b1"].to(cd),
            "w2": f["w2"].to(cd), "b2": f["b2"].to(cd),
            "ln1": f32(layers["ln1"]), "ln2": f32(layers["ln2"]),
            "ln3": f32(layers["ln3"]),
        },
        # logits: compute-dtype operands, f32 accumulation and bias
        "fc_w": params["fc_out_w"].to(cd),
        "fc_b": params["fc_out_b"].float(),
    }
    if fused:
        out["fused_layers"] = pack_decode_layers(out["layers"])
    return out


def step_route(fused: bool, device_type: str, cfg: DecoderConfig,
               cls_memory: bool = True) -> str:
    """``"fused"`` or ``"unfused"``: the layers a step runs when the caller
    asks for ``fused``, on tensors of ``device_type``, with decoder ``cfg``,
    over a cache that holds the CLS cross constant (``cls_memory``) or full
    memory's keys and values.

    The JAX package's rule (``cache.cross_const is not None and
    _fused_supported``): the fused layer takes only the CLS constant; off
    the accelerator it then always runs (here its plain version, on CPU
    tensors); on it, only at a geometry the kernel takes, and the unfused
    layers elsewhere. A kernel that fails to build or launch raises; it
    never changes the route."""
    if not fused or not cls_memory:
        return "unfused"
    if device_type == "cuda" and not decode_layer_supported(
            cfg.embed_dim, cfg.num_heads, cfg.ff_dim):
        return "unfused"
    return "fused"


def decoder_step(
    params: dict,
    cfg: DecoderConfig,
    tokens: torch.Tensor,              # (B,) current input token ids
    pos,                               # int position of `tokens`, or (B,)
    cache: DecodeCache,
    compute_dtype=torch.float32,
    key_pad: Optional[torch.Tensor] = None,   # (B, T_max) bool, True = PAD key
    fused: bool = False,
) -> Tuple[torch.Tensor, DecodeCache]:
    """One decode step → (logits (B, V) f32, cache).

    Takes raw decoder params or :func:`prepare_decode_params` output.
    ``key_pad`` marks generated-PAD positions, which stay masked as keys, as
    the reference's per-step ``tgt_key_padding_mask`` masks them. ``fused``
    runs every layer in the fused decode-layer kernel (see the module
    docstring) where :func:`step_route` allows it, and the unfused layers
    elsewhere. ``pos`` may be a (B,) integer tensor of per-row positions on
    either route; its positional rows are taken at ``pos`` clipped to
    ``max_seq_len - 1``, as the JAX service's are, and a fresh row whose
    position lies outside the cache is not written.
    """
    with span("mit.decode.step"):
        return _decoder_step(params, cfg, tokens, pos, cache, compute_dtype,
                             key_pad, fused)


def _decoder_step(params, cfg, tokens, pos, cache, compute_dtype, key_pad,
                  fused):
    h, d = cfg.num_heads, cfg.embed_dim
    fused = step_route(fused, tokens.device.type, cfg,
                       cache.cross_const is not None) == "fused"
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    decoder_step.routes["fused" if fused else "unfused"] += 1
    if "emb" not in params:
        params = prepare_decode_params(params, compute_dtype, fused)
    cd = compute_dtype
    hd = d // h
    b = tokens.shape[0]
    t_max = cache.k[0].shape[1]
    lay = params["layers"]
    device = tokens.device

    x = params["emb"][tokens] * torch.tensor(math.sqrt(d), dtype=cd)
    table = sinusoid_table(cfg.max_seq_len, d, cd, device)
    x = x + (table[pos.long().clamp(0, cfg.max_seq_len - 1)] if per_row
             else table[pos])

    steps = torch.arange(t_max, device=device)
    visible = (steps[None, :] <= pos[:, None]) if per_row else \
        (steps <= pos)[None, :]                                       # (B|1, T)
    if key_pad is not None:
        visible = visible & ~key_pad                                  # (B, T)

    if fused:
        packed = params.get("fused_layers") or pack_decode_layers(lay)
        # one additive f32 mask for all layers; -1e9, not -inf, so a fully
        # masked row stays finite
        madd = torch.where(visible, 0.0, NEG_INF).expand(b, t_max).contiguous()
        posv = positions(pos, b, device).contiguous()
        cross = cache.cross_const.float()
        for i in range(cfg.num_layers):
            x, _, _ = fused_decode_layer(
                x, posv, madd, cache.k[i], cache.v[i], cross[i], packed, i, h,
                write_cache=True,
            )
        logits = x.float() @ params["fc_w"].float() + params["fc_b"]
        return logits, cache

    visible = visible[:, None, :]                                     # (B|1, 1, T)
    scale = 1.0 / math.sqrt(hd)
    posv = positions(pos, b, device) if per_row else None

    for i in range(cfg.num_layers):
        layer = layer_params(lay, i)
        qf, kf, vf = (x @ layer["wqkv"] + layer["bqkv"]).split(d, dim=-1)
        if per_row:
            write_rows(cache.k[i], cache.v[i], posv, kf, vf)
        else:
            cache.k[i][:, pos] = kf
            cache.v[i][:, pos] = vf
        k_i = cache.k[i].view(b, t_max, h, hd)
        v_i = cache.v[i].view(b, t_max, h, hd)
        # f32 scores and context from compute-dtype operands: the JAX
        # einsums' preferred_element_type=f32 (upcasting is exact)
        scores = torch.einsum(
            "bhe,bthe->bht", qf.reshape(b, h, hd).float(), k_i.float()
        ) * scale
        scores = torch.where(visible, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cd)
        ctx = torch.einsum("bht,bthe->bhe", probs.float(), v_i.float())
        sa = ctx.to(cd).reshape(b, d) @ layer["wo"] + layer["bo"]
        x = layer_norm(layer["ln1"], x + sa)
        if cache.cross_const is not None:
            ca = cache.cross_const[i].to(cd)
        else:
            # the same rounding points as the self-attention: f32 scores
            # plus the additive mask, probabilities and context rounded to cd
            qc = (x @ layer["cross_wq"] + layer["cross_bq"]).reshape(b, h, hd)
            cs = torch.einsum("bhe,bhse->bhs", qc.float(),
                              cache.cross_k[i].float()) * scale
            if cache.cross_mask is not None:
                cs = cs + cache.cross_mask
            cprobs = torch.softmax(cs, dim=-1).to(cd)
            cctx = torch.einsum("bhs,bhse->bhe", cprobs.float(),
                                cache.cross_v[i].float()).to(cd)
            ca = cctx.reshape(b, d) @ layer["cross_wo"] + layer["cross_bo"]
        x = layer_norm(layer["ln2"], x + ca)
        y = torch.relu(x @ layer["w1"] + layer["b1"]) @ layer["w2"] + layer["b2"]
        x = layer_norm(layer["ln3"], x + y)

    logits = x.float() @ params["fc_w"].float() + params["fc_b"]
    return logits, cache


# steps taken on each route, decided from the geometry alone
decoder_step.routes = {"fused": 0, "unfused": 0}


def grow_cache(cache: DecodeCache, bucket: int) -> DecodeCache:
    """Copy the self-attention K/V into a larger T_max (ladder growth); the
    cross-attention terms stay as they are."""

    def grow(a):
        out = a.new_zeros((a.shape[0], bucket) + tuple(a.shape[2:]))
        out[:, : a.shape[1]] = a
        return out

    with span("mit.decode.grow"):
        return cache._replace(k=[grow(a) for a in cache.k],
                              v=[grow(a) for a in cache.v])


def reindex_cache(cache: DecodeCache, idx: torch.Tensor) -> DecodeCache:
    """Gather batch rows (beam reordering): idx (B,) into the batch dim."""
    take = lambda a, dim: None if a is None else a.index_select(dim, idx)
    return DecodeCache(
        [a.index_select(0, idx) for a in cache.k],
        [a.index_select(0, idx) for a in cache.v],
        take(cache.cross_const, 1),
        take(cache.cross_k, 1),
        take(cache.cross_v, 1),
        take(cache.cross_mask, 0),
    )
