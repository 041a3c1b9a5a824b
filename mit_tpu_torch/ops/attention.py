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
draws the masks of an uninterrupted one. A forward captured into a CUDA
graph gives its generators :class:`SeedSlots`: each fused call then takes
a device slot in place of a host draw, and the step stages into the slots
the draws the host generator would have made (:meth:`DropoutGenerators.
kernel_seeds`). Library functions never read the environment:
``fused_dropout`` comes from the caller.

Under a device mesh a :class:`~mit_tpu_torch.parallel.collectives.Shard`
(``shard``) says which rows, heads and FFN columns this rank holds. Every
rank draws each Bernoulli mask at its global shape and keeps its slice, and
the fused kernel hashes global cells, so a rank's dropout is its slice of
the single-device step's. With a "model" group, the projections are
Megatron's: ``q_in``/``kv_in`` enter through ``copy_to_model``, the
heads are this rank's, and the out projection's partial sums are summed
over "model" (``reduce_from_model``) before its bias.
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
from mit_tpu_torch.parallel.collectives import (
    Shard,
    copy_to_model,
    reduce_from_model,
)

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class SeedSlots:
    """Device slots for the fused kernel's seeds of one forward: the i-th
    fused call takes the 0-dim int32 view ``buffer[i]``, which the kernels
    read when they run, so a CUDA graph's replay finds the seeds staged
    there for its step. Without a buffer every call takes a fresh zero,
    and ``taken`` counts the calls."""

    def __init__(self, buffer: Optional[torch.Tensor] = None, device=None):
        self.buffer, self.device, self.taken = buffer, device, 0

    def take(self) -> torch.Tensor:
        i, self.taken = self.taken, self.taken + 1
        if self.buffer is None:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        return self.buffer[i]


class DropoutGenerators(NamedTuple):
    """The dropout streams of one forward pass."""

    device: torch.Generator     # Bernoulli masks, on the activations' device
    host: torch.Generator       # the fused kernel's int32 seeds, on the CPU
    # where set, the fused calls take device slots in place of host draws
    seeds: Optional[SeedSlots] = None

    @staticmethod
    def step_seeds(seed: int, step: int) -> tuple:
        """(device generator's seed, host generator's seed) of (seed,
        step)."""
        base = _splitmix64(_splitmix64(seed & _M64) ^ (step & _M64))
        return _splitmix64(base ^ 1) >> 1, _splitmix64(base ^ 2) >> 1

    @classmethod
    def for_step(cls, seed: int, step: int, device) -> "DropoutGenerators":
        """Both generators as a pure function of (seed, step)."""
        dev_seed, host_seed = cls.step_seeds(seed, step)
        dev = torch.Generator(device=device)
        dev.manual_seed(dev_seed)
        host = torch.Generator()
        host.manual_seed(host_seed)
        return cls(dev, host)

    @classmethod
    def kernel_seeds(cls, seed: int, step: int, n: int) -> list:
        """The seeds the first ``n`` fused calls of (seed, step)'s forward
        draw, in order: the host generator of :meth:`for_step` and the
        draws of :func:`kernel_seed`."""
        host = torch.Generator()
        host.manual_seed(cls.step_seeds(seed, step)[1])
        return [_draw_seed(host) for _ in range(n)]


def _draw_seed(host: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (), generator=host))


def kernel_seed(generator: DropoutGenerators):
    """The seed of the next fused dropout-attention call: a host int drawn
    from ``generator.host``, or the next of ``generator.seeds``' slots."""
    if generator.seeds is not None:
        return generator.seeds.take()
    return _draw_seed(generator.host)


def _linear(x, params, w, b, cd):
    return x.to(cd) @ params[w].to(cd) + params[b].to(cd)


def keep_mask_for(shape, rate: float, generator: DropoutGenerators, device,
                  shard: Optional[Shard] = None,
                  split_dim: Optional[int] = None) -> torch.Tensor:
    """Bernoulli(1 − rate) keep-mask of ``shape`` from ``generator.device``;
    under ``shard`` this rank's slice of the global mask (``split_dim``: the
    dimension split over "model")."""
    if shard is None:
        return torch.rand(shape, generator=generator.device,
                          device=device) < 1.0 - rate
    return shard.keep(shape, rate, generator.device, device, split_dim)


def dropout(x: torch.Tensor, rate: float, generator: Optional[DropoutGenerators],
            deterministic: bool = True, shard: Optional[Shard] = None,
            split_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout: ``where(keep, x / (1 − rate), 0)`` with keep drawn
    Bernoulli(1 − rate) from ``generator.device`` (``_dropout`` of the JAX
    decoder), this rank's slice of it under ``shard``."""
    if rate <= 0.0 or deterministic:
        return x
    keep = keep_mask_for(x.shape, rate, generator, x.device, shard, split_dim)
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
    shard: Optional[Shard] = None,
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

    The route depends on the arguments alone, never on the shapes or the
    device: a kernel wrapper runs its plain version for CPU tensors and, for
    CUDA tensors, launches a kernel at every shape it has one for (the tiled
    kernels at head width 64, the any-shape kernels elsewhere) or raises.
    ``multihead_attention.routes`` counts every call by the route it took:
    ``"kernel"`` for the first two above, ``"plain"`` for the third.

    ``num_heads`` is the model's; under ``shard`` with a "model" group,
    ``params`` hold this rank's heads (``num_heads / m`` of them).
    """
    cd = compute_dtype
    b, t, d = q_in.shape
    s = kv_in.shape[1]
    hd = d // num_heads
    group = shard.group if shard is not None else None
    if group is not None:
        num_heads //= shard.m
        same = kv_in is q_in
        q_in = copy_to_model(q_in, group)
        kv_in = q_in if same else copy_to_model(kv_in, group)
    dropout_active = dropout_rate > 0.0 and not deterministic
    q = _linear(q_in, params, "wq", "bq", cd)
    k = _linear(kv_in, params, "wk", "bk", cd)
    v = _linear(kv_in, params, "wv", "bv", cd)

    def out_proj(ctx):
        part = reduce_from_model(ctx @ params["wo"].to(cd), group)
        return part + params["bo"].to(cd)

    if dropout_active and fused_dropout:
        if mask is not None:
            raise ValueError(
                "the fused dropout path takes causal/pad_add, not a dense mask"
            )
        if pad_add is None:
            pad_add = torch.zeros((b, s), dtype=torch.float32, device=q.device)
        seed = kernel_seed(generator)
        attend = flash_attention_dropout if use_kernel else \
            flash_attention_dropout_plain
        multihead_attention.routes["kernel" if use_kernel else "plain"] += 1
        cells = None if shard is None else (
            shard.b0, num_heads * shard.m, shard.m_index * num_heads)
        ctx = attend(*(_split_heads(x, num_heads).contiguous()
                       for x in (q, k, v)),
                     pad_add.float().contiguous(), seed, causal,
                     float(dropout_rate), cells)
        return out_proj(_merge_heads(ctx))

    if use_kernel and not dropout_active:
        if mask is not None:
            raise ValueError(
                "the kernel path takes causal/pad_add, not a dense mask"
            )
        multihead_attention.routes["kernel"] += 1
        if takes_bhtd(t, s, d, q.element_size()):
            out = _merge_heads(flash_attention(
                *(_split_heads(x, num_heads).contiguous() for x in (q, k, v)),
                pad_add, causal))
        else:
            out = flash_attention_btd(q, k, v, pad_add, causal, hd)
        return out_proj(out)

    multihead_attention.routes["plain"] += 1
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
                    deterministic, shard, split_dim=1)
    ctx = torch.einsum(
        "bhts,bhsd->bhtd", probs.to(cd).float(),
        _split_heads(v, num_heads).float(),
    ).to(cd)
    return out_proj(_merge_heads(ctx))


# every call, by the route its arguments gave it
multihead_attention.routes = {"kernel": 0, "plain": 0}


def single_key_cross_attention(
    params: dict,
    q_len: int,
    kv_in: torch.Tensor,
    num_heads: int,
    compute_dtype=torch.float32,
    dropout_rate: float = 0.0,
    generator: Optional[DropoutGenerators] = None,
    deterministic: bool = True,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """Cross-attention over a memory of length 1 (CLS-only mode).

    softmax over one key is 1, so every query's context is that key's value:
    ``out_proj(v_proj(memory))`` broadcast over the q_len positions. While
    training, the probability dropout becomes a (B, H, T, 1) Bernoulli mask
    on the per-head context, as in the JAX package.
    kv_in: (B, 1, D). Returns (B, q_len, D). Under ``shard`` as
    :func:`multihead_attention`.
    """
    b, s, d = kv_in.shape
    if s != 1:
        raise ValueError(f"single_key_cross_attention needs memory length 1, got {s}")
    cd = compute_dtype
    hd = d // num_heads
    group = shard.group if shard is not None else None
    if group is not None:
        num_heads //= shard.m
        kv_in = copy_to_model(kv_in, group)
    v = _linear(kv_in, params, "wv", "bv", cd)

    def out_proj(ctx):
        part = reduce_from_model(ctx @ params["wo"].to(cd), group)
        return part + params["bo"].to(cd)

    if dropout_rate <= 0.0 or deterministic:
        return out_proj(v).expand(b, q_len, d)
    ctx = v.reshape(b, 1, num_heads, hd).transpose(1, 2).expand(
        b, num_heads, q_len, hd)
    keep = keep_mask_for((b, num_heads, q_len, 1), dropout_rate, generator,
                         v.device, shard, split_dim=1)
    scale = torch.full((), 1.0 - dropout_rate, dtype=cd, device=v.device)
    ctx = torch.where(keep, ctx / scale, 0.0)
    return out_proj(_merge_heads(ctx))


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
