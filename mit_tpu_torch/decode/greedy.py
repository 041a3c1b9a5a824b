"""Batched KV-cached greedy decoding (port of ``mit_tpu/decode/greedy.py``).

Start from START, append the argmax of each step's logits, stop a row at
END (later positions hold PAD) and stop the loop when every row has ended.
The KV cache grows through a ladder of sizes (16, 32, ..., max_len), so
short captions never pay the attention reads of a max_len-sized cache.
``lax.while_loop``'s early exit becomes a host check of ``finished.all()``
before each step. :func:`laddered_decode_loop` takes the rule that picks
the next token, so greedy decoding and sampling share it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mit_tpu_torch.decode.step import (
    DecodeCache,
    decoder_step,
    grow_cache,
    init_cache,
    prepare_decode_params,
)
from mit_tpu_torch.models.decoder import DecoderConfig


def _bucket_schedule(max_len: int, first: int = 16) -> Tuple[int, ...]:
    """KV-cache growth ladder: first, 2*first, ... capped at max_len."""
    buckets = []
    b = first
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def check_bucket_sizes(bucket_sizes, max_len: int) -> Tuple[int, ...]:
    if bucket_sizes is None:
        bucket_sizes = _bucket_schedule(max_len)
    bucket_sizes = tuple(bucket_sizes)
    if (
        not bucket_sizes
        or tuple(sorted(set(bucket_sizes))) != bucket_sizes
        or bucket_sizes[-1] != max_len
    ):
        raise ValueError(
            "bucket_sizes must be strictly increasing and end at "
            f"max_len={max_len}: {bucket_sizes}"
        )
    return bucket_sizes


def laddered_decode_loop(
    params: dict,                      # prepare_decode_params output
    cfg: DecoderConfig,
    cache: DecodeCache,                # allocated at bucket_sizes[0]
    tokens: torch.Tensor,              # (B, max_len), slot 0 = START; written in place
    select_fn,                         # (logits (B, V) f32, generator) → (B,) ids
    generator: Optional[torch.Generator],   # handed to select_fn
    end_id: int,
    pad_id: int,
    max_len: int,
    bucket_sizes: Tuple[int, ...],
    compute_dtype,
    fused: bool = False,
) -> torch.Tensor:
    """The token loop over the cache ladder → tokens. ``select_fn`` picks
    each step's next tokens from the logits; finished rows get PAD."""
    finished = torch.zeros(tokens.shape[0], dtype=torch.bool,
                           device=tokens.device)
    pos = 0
    for i, bucket in enumerate(bucket_sizes):
        if i > 0:
            cache = grow_cache(cache, bucket)
        # a step at pos needs cache slot pos, so this bucket serves pos < bucket
        while pos < min(bucket, max_len - 1):
            if bool(finished.all()):
                return tokens
            logits, cache = decoder_step(
                params, cfg, tokens[:, pos], pos, cache, compute_dtype,
                key_pad=(tokens == pad_id)[:, :bucket], fused=fused,
            )
            nxt = torch.where(finished, pad_id, select_fn(logits, generator))
            tokens[:, pos + 1] = nxt
            finished |= nxt == end_id
            pos += 1
    return tokens


def start_tokens(batch: int, max_len: int, start_id: int, pad_id: int,
                 device) -> torch.Tensor:
    """(B, max_len) int64 of PAD with START in slot 0."""
    tokens = torch.full((batch, max_len), pad_id, dtype=torch.long,
                        device=device)
    tokens[:, 0] = start_id
    return tokens


def check_max_len(max_len: int, cfg: DecoderConfig) -> None:
    if max_len > cfg.max_seq_len:
        raise ValueError(
            f"max_len={max_len} exceeds the positional table "
            f"(max_seq_len={cfg.max_seq_len})"
        )


def select_argmax(logits: torch.Tensor, generator=None) -> torch.Tensor:
    return logits.argmax(-1)


@torch.inference_mode()
def greedy_generate(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, 1, D) projected decoder memory
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
    memory_padding_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B, max_len) int64 incl. the leading START, lengths (B,)).

    ``lengths`` counts tokens incl. START and END (when generated);
    positions past a row's END hold PAD. ``fused`` runs every step's layers
    in the fused decode-layer kernel.
    """
    check_max_len(max_len, cfg)
    bucket_sizes = check_bucket_sizes(bucket_sizes, max_len)
    cache = init_cache(params, cfg, memory, memory_padding_mask,
                       bucket_sizes[0], compute_dtype)
    params = prepare_decode_params(params, compute_dtype, fused)
    tokens = start_tokens(memory.shape[0], max_len, start_id, pad_id,
                          memory.device)
    tokens = laddered_decode_loop(params, cfg, cache, tokens, select_argmax,
                                  None, end_id, pad_id, max_len, bucket_sizes,
                                  compute_dtype, fused)
    return tokens, (tokens != pad_id).sum(dim=1)
