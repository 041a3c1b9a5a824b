"""Stochastic decoding: temperature, top-k and top-p sampling (port of
``mit_tpu/decode/sampling.py``).

The greedy loop's machinery with a drawn next token: a categorical draw
over the filtered, temperature-scaled distribution. :func:`filter_logits`
is held to the JAX function exactly. JAX's PRNG streams cannot be
reproduced in torch, so :func:`sample_generate` draws from an explicit
``torch.Generator`` on the memory's device: the same seed repeats the same
captions, and ``temperature=0`` is greedy decoding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mit_tpu_torch.decode.greedy import (
    check_bucket_sizes,
    check_max_len,
    laddered_decode_loop,
    select_argmax,
    start_tokens,
)
from mit_tpu_torch.decode.step import init_cache, prepare_decode_params
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.utils.profiling import span

_NEG = -1e30


def filter_logits(
    logits: torch.Tensor,              # (B, V) f32
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Scale by temperature, then mask everything outside top-k / top-p."""
    if temperature != 1.0:
        # a tensor divisor: an IEEE divide (a Python scalar would become a
        # multiply by its reciprocal on CUDA), made by a fill kernel
        logits = logits / torch.full((), max(temperature, 1e-6),
                                     dtype=logits.dtype, device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, _NEG, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the mass *before* them is < p (always ≥ 1 token)
        keep_sorted = (cum - probs) < top_p
        # threshold logit = smallest kept logit per row
        thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, _NEG, logits)
    return logits


@torch.inference_mode()
def sample_generate(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, S, D)
    generator: Optional[torch.Generator],   # on memory's device; None: global
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    memory_padding_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B, max_len), lengths (B,)): the greedy loop with a sampled
    next-token rule. ``temperature=0`` degenerates to argmax (greedy)."""
    check_max_len(max_len, cfg)
    bucket_sizes = check_bucket_sizes(bucket_sizes, max_len)
    with span("mit.decode.prepare"):
        cache = init_cache(params, cfg, memory, memory_padding_mask,
                           bucket_sizes[0], compute_dtype)
        prepared = prepare_decode_params(params, compute_dtype, fused)
    tokens = start_tokens(memory.shape[0], max_len, start_id, pad_id,
                          memory.device)

    def select(logits, gen):
        filtered = filter_logits(logits, temperature, top_k, top_p)
        return torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                 generator=gen)[:, 0]

    tokens = laddered_decode_loop(
        prepared, cfg, cache, tokens,
        select_argmax if temperature == 0.0 else select, generator, end_id,
        pad_id, max_len, bucket_sizes, compute_dtype, fused,
    )
    return tokens, (tokens != pad_id).sum(dim=1)
