"""Single-token decoder step with a KV cache (port of
``mit_tpu/decode/step.py``, CLS memory mode).

Self-attention keys and values live in L per-layer (B, T_max, D) buffers,
heads as column blocks. A step writes this token's fresh K/V row into the
cache in place, then attends over the cache; the JAX package instead attends
over the stale cache with a fresh-row correction and scatters at the end,
which only serves to stop XLA's defensive cache copies — the result is the
same. In CLS memory mode the cross-attention is a per-layer constant
(softmax over one key is 1), computed once per sequence by
:func:`init_cache`.

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
in interpret mode. :func:`step_route` makes the choice, from the device type
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
)
from mit_tpu_torch.ops.masks import NEG_INF
from mit_tpu_torch.ops.positional import sinusoid_table

FULL_MEMORY_NOT_PORTED = (
    "decoding over full-sequence or padded memory is not ported yet: "
    "ROADMAP.md, queue 1, full-memory decoding and the service"
)


class DecodeCache(NamedTuple):
    """Per-generation state. ``k`` and ``v`` are written in place."""

    k: list                            # L × (B, T_max, D) self-attn keys
    v: list                            # L × (B, T_max, D) self-attn values
    cross_const: torch.Tensor          # (L, B, D) CLS-mode cross-attention


def init_cache(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, 1, D) projected CLS memory
    memory_padding_mask: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
    compute_dtype=torch.float32,
) -> DecodeCache:
    """Allocate the KV cache and precompute the cross-attention constant."""
    cd = compute_dtype
    b, s, d = memory.shape
    t_max = max_len or cfg.max_seq_len
    if t_max > cfg.max_seq_len:
        raise ValueError(
            f"max_len={t_max} exceeds the positional table "
            f"(max_seq_len={cfg.max_seq_len})"
        )
    if s != 1 or memory_padding_mask is not None:
        raise NotImplementedError(FULL_MEMORY_NOT_PORTED)
    zeros = lambda: torch.zeros(b, t_max, d, dtype=cd, device=memory.device)
    cross = params["layers"]["cross"]
    # out_proj(v_proj(memory)) per layer
    vv = torch.einsum("bsd,lde->lbse", memory.to(cd), cross["wv"].to(cd))
    vv = vv + cross["bv"].to(cd)[:, None, None, :]
    out = torch.einsum("lbse,lef->lbsf", vv, cross["wo"].to(cd))
    out = out + cross["bo"].to(cd)[:, None, None, :]
    return DecodeCache(
        [zeros() for _ in range(cfg.num_layers)],
        [zeros() for _ in range(cfg.num_layers)],
        out[:, :, 0, :],
    )


def prepare_decode_params(params: dict, compute_dtype=torch.float32,
                          fused: bool = False) -> dict:
    """Cast the weights to the compute dtype and fuse Q/K/V, once per
    generation rather than once per step. LayerNorm parameters and the
    logits bias stay f32. With ``fused`` the result also holds the fused
    kernel's per-layer operands (``"fused_layers"``)."""
    cd = compute_dtype
    layers = params["layers"]
    s, f = layers["self"], layers["ffn"]
    f32 = lambda p: {"scale": p["scale"].float(), "bias": p["bias"].float()}
    out = {
        "emb": params["token_embedding"].to(cd),
        "layers": {
            "wqkv": torch.cat([s["wq"], s["wk"], s["wv"]], -1).to(cd),
            "bqkv": torch.cat([s["bq"], s["bk"], s["bv"]], -1).to(cd),
            "wo": s["wo"].to(cd), "bo": s["bo"].to(cd),
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


def step_route(fused: bool, device_type: str, cfg: DecoderConfig) -> str:
    """``"fused"`` or ``"unfused"``: the layers a step runs when the caller
    asks for ``fused``, on tensors of ``device_type``, with decoder ``cfg``.

    The JAX package's rule (``_fused_supported``): off the accelerator the
    fused layer always runs (here its plain version, on CPU tensors); on it,
    only at a geometry the kernel takes, and the unfused layers elsewhere.
    A kernel that fails to build or launch raises; it never changes the
    route."""
    if not fused:
        return "unfused"
    if device_type == "cuda" and not decode_layer_supported(
            cfg.embed_dim, cfg.num_heads, cfg.ff_dim):
        return "unfused"
    return "fused"


def decoder_step(
    params: dict,
    cfg: DecoderConfig,
    tokens: torch.Tensor,              # (B,) current input token ids
    pos,                               # int position of `tokens`; fused: or (B,)
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
    elsewhere. On the fused route ``pos`` may be a (B,) int32 tensor of
    per-row positions, and no position is read back from the device; the
    unfused route has no per-row positions yet and raises on them, also
    where ``fused`` was asked for and the geometry sent the step there.
    """
    h, d = cfg.num_heads, cfg.embed_dim
    fused = step_route(fused, tokens.device.type, cfg) == "fused"
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    if per_row and not fused:
        raise TypeError(
            "per-row positions need the fused route: fused=True at a "
            "geometry the fused kernel takes"
        )
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
    x = x + sinusoid_table(cfg.max_seq_len, d, cd, device)[pos]

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

    for i in range(cfg.num_layers):
        layer = layer_params(lay, i)
        qf, kf, vf = (x @ layer["wqkv"] + layer["bqkv"]).split(d, dim=-1)
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
        x = layer_norm(layer["ln2"], x + cache.cross_const[i])
        y = torch.relu(x @ layer["w1"] + layer["b1"]) @ layer["w2"] + layer["b2"]
        x = layer_norm(layer["ln3"], x + y)

    logits = x.float() @ params["fc_w"].float() + params["fc_b"]
    return logits, cache


# steps taken on each route, decided from the geometry alone
decoder_step.routes = {"fused": 0, "unfused": 0}


def grow_cache(cache: DecodeCache, bucket: int) -> DecodeCache:
    """Copy the self-attention K/V into a larger T_max (ladder growth)."""

    def grow(a):
        out = a.new_zeros((a.shape[0], bucket) + tuple(a.shape[2:]))
        out[:, : a.shape[1]] = a
        return out

    return cache._replace(k=[grow(a) for a in cache.k],
                          v=[grow(a) for a in cache.v])


def reindex_cache(cache: DecodeCache, idx: torch.Tensor) -> DecodeCache:
    """Gather batch rows (beam reordering): idx (B,) into the batch dim."""
    return DecodeCache(
        [a.index_select(0, idx) for a in cache.k],
        [a.index_select(0, idx) for a in cache.v],
        cache.cross_const.index_select(1, idx),
    )
