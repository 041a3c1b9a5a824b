"""Multi-head attention and LayerNorm (port of ``mit_tpu/ops/attention.py``).

torch ``nn.MultiheadAttention`` semantics with (in, out) projection
matrices: ``params = {wq, wk, wv, wo: (D, D); bq, bk, bv, bo: (D,)}``, and
dropout on the attention probabilities while training.

Randomness: JAX's ``jax.random`` streams cannot be reproduced in torch, so
dropout draws from an explicit :class:`DropoutGenerators` pair. Its
``device`` generator draws the Bernoulli masks on the activations' device;
its ``host`` generator draws, on the CPU, the int32 seed of each fused
dropout-attention call (a seed read back from the device would put a sync
into every layer). :meth:`DropoutGenerators.for_step` derives both from
(seed, step), the counterpart of ``fold_in(rng, step)``, so a resumed run
draws the masks of an uninterrupted one. Library functions never read the
environment: ``fused_dropout`` comes from the caller.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mit_tpu_torch.ops.dropout_attention import (
    flash_attention_dropout,
    flash_attention_dropout_plain,
)
from mit_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_btd,
    takes_bhtd,
)
from mit_tpu_torch.ops.masks import causal_mask

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class DropoutGenerators(NamedTuple):
    """The dropout streams of one forward pass."""

    device: torch.Generator     # Bernoulli masks, on the activations' device
    host: torch.Generator       # the fused kernel's int32 seeds, on the CPU

    @classmethod
    def for_step(cls, seed: int, step: int, device) -> "DropoutGenerators":
        """Both generators as a pure function of (seed, step)."""
        base = _splitmix64(_splitmix64(seed & _M64) ^ (step & _M64))
        dev = torch.Generator(device=device)
        dev.manual_seed(_splitmix64(base ^ 1) >> 1)
        host = torch.Generator()
        host.manual_seed(_splitmix64(base ^ 2) >> 1)
        return cls(dev, host)


def _linear(x, params, w, b, cd):
    return x.to(cd) @ params[w].to(cd) + params[b].to(cd)


def dropout(x: torch.Tensor, rate: float, generator: Optional[DropoutGenerators],
            deterministic: bool = True) -> torch.Tensor:
    """Inverted dropout: ``where(keep, x / (1 − rate), 0)`` with keep drawn
    Bernoulli(1 − rate) from ``generator.device`` (``_dropout`` of the JAX
    decoder)."""
    if rate <= 0.0 or deterministic:
        return x
    keep = torch.rand(x.shape, generator=generator.device,
                      device=x.device) < 1.0 - rate
    # a 0-dim device tensor made by a fill kernel: an IEEE divide (a
    # Python scalar would become a multiply by 1/c on CUDA) with no copy
    # from the host, which would wait for the device
    scale = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, 0.0)


def _split_heads(x, num_heads):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


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
    dropout_rate: float = 0.0,
    generator: Optional[DropoutGenerators] = None,
    deterministic: bool = True,
    fused_dropout: bool = False,
) -> torch.Tensor:
    """q_in (B, T, D) attends over kv_in (B, S, D) → (B, T, D).

    The dispatch of the JAX package's ``multihead_attention``:

    - dropout active (``dropout_rate > 0`` and not ``deterministic``) with
      ``fused_dropout``: heads split, :func:`flash_attention_dropout` (the
      hash-mask kernels; their plain versions when ``use_kernel`` is False),
      heads merged. The mask is given structurally as ``causal`` +
      ``pad_add``.
    - no dropout and ``use_kernel`` (``use_flash`` in the JAX package): the
      score/mask/softmax/P·V chain runs in :func:`flash_attention_btd`, or,
      at the shapes :func:`takes_bhtd` names (the BLIP-384 encoder in f32),
      in :func:`flash_attention` between a head split and a head merge.
    - otherwise the plain path, which also takes a materialized additive
      ``mask`` broadcastable to (B, H, T, S) and drops out the probabilities
      with a Bernoulli mask drawn from ``generator.device``.
    """
    cd = compute_dtype
    b, t, d = q_in.shape
    s = kv_in.shape[1]
    hd = d // num_heads
    dropout_active = dropout_rate > 0.0 and not deterministic
    q = _linear(q_in, params, "wq", "bq", cd)
    k = _linear(kv_in, params, "wk", "bk", cd)
    v = _linear(kv_in, params, "wv", "bv", cd)

    if dropout_active and fused_dropout:
        if mask is not None:
            raise ValueError(
                "the fused dropout path takes causal/pad_add, not a dense mask"
            )
        if pad_add is None:
            pad_add = torch.zeros((b, s), dtype=torch.float32, device=q.device)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator.host))
        attend = flash_attention_dropout if use_kernel else \
            flash_attention_dropout_plain
        ctx = attend(*(_split_heads(x, num_heads).contiguous()
                       for x in (q, k, v)),
                     pad_add.float().contiguous(), seed, causal,
                     float(dropout_rate))
        return _merge_heads(ctx) @ params["wo"].to(cd) + params["bo"].to(cd)

    if use_kernel and not dropout_active:
        if mask is not None:
            raise ValueError(
                "the kernel path takes causal/pad_add, not a dense mask"
            )
        if takes_bhtd(t, s, d, q.element_size()):
            out = _merge_heads(flash_attention(
                *(_split_heads(x, num_heads).contiguous() for x in (q, k, v)),
                pad_add, causal))
        else:
            out = flash_attention_btd(q, k, v, pad_add, causal, hd)
        return out @ params["wo"].to(cd) + params["bo"].to(cd)

    if mask is None and (causal or pad_add is not None):
        mask = torch.zeros((1, 1, t, s), dtype=torch.float32, device=q.device)
        if causal:
            mask = mask + causal_mask(t, s, q.device)
        if pad_add is not None:
            mask = mask + pad_add[:, None, None, :]
    # f32 scores and P·V accumulation from compute-dtype operands (the JAX
    # einsums' preferred_element_type=f32): upcasting is exact.
    scores = torch.einsum(
        "bhtd,bhsd->bhts", _split_heads(q, num_heads).float(),
        _split_heads(k, num_heads).float(),
    ) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask.float()
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator,
                    deterministic)
    ctx = torch.einsum(
        "bhts,bhsd->bhtd", probs.to(cd).float(),
        _split_heads(v, num_heads).float(),
    ).to(cd)
    return _merge_heads(ctx) @ params["wo"].to(cd) + params["bo"].to(cd)


def single_key_cross_attention(
    params: dict,
    q_len: int,
    kv_in: torch.Tensor,
    num_heads: int,
    compute_dtype=torch.float32,
    dropout_rate: float = 0.0,
    generator: Optional[DropoutGenerators] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Cross-attention over a memory of length 1 (CLS-only mode).

    softmax over one key is 1, so every query's context is that key's value:
    ``out_proj(v_proj(memory))`` broadcast over the q_len positions. While
    training, the probability dropout becomes a (B, H, T, 1) Bernoulli mask
    on the per-head context, as in the JAX package.
    kv_in: (B, 1, D). Returns (B, q_len, D).
    """
    b, s, d = kv_in.shape
    if s != 1:
        raise ValueError(f"single_key_cross_attention needs memory length 1, got {s}")
    cd = compute_dtype
    v = _linear(kv_in, params, "wv", "bv", cd)
    if dropout_rate <= 0.0 or deterministic:
        return _linear(v, params, "wo", "bo", cd).expand(b, q_len, d)
    hd = d // num_heads
    ctx = v.reshape(b, 1, num_heads, hd).transpose(1, 2).expand(
        b, num_heads, q_len, hd)
    keep = torch.rand((b, num_heads, q_len, 1), generator=generator.device,
                      device=v.device) < 1.0 - dropout_rate
    scale = torch.full((), 1.0 - dropout_rate, dtype=cd, device=v.device)
    ctx = torch.where(keep, ctx / scale, 0.0)
    return _merge_heads(ctx) @ params["wo"].to(cd) + params["bo"].to(cd)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
