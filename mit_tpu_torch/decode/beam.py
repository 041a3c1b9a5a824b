"""Batched KV-cached beam search (port of ``mit_tpu/decode/beam.py``).

- log-probability beam search over K beams per item, batched: B·K rows run
  through one decoder step, rows grouped per item [i0b0..i0bK, i1b0..];
- finished beams are frozen: they only ever extend with PAD at score 0, so
  their totals stay comparable while alive beams keep expanding;
- beam reordering gathers the KV cache along the batch axis each step;
- the returned hypothesis is the beam of highest total log-probability among
  finished and max-length-unfinished candidates (no length penalty), in
  greedy's output format.

With ``beam_size=1`` this reduces to greedy decoding. The cache grows
through the same ladder as greedy's; ``lax.while_loop``'s early exit
becomes a host check of ``finished.all()`` before each step.

Ties. ``lax.top_k`` returns the lowest index first among equal values;
``torch.topk`` promises no order. :func:`top_k_lowest_first` takes the
first K of a stable descending sort, which does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mit_tpu_torch.decode.greedy import (
    check_bucket_sizes,
    check_max_len,
    start_tokens,
)
from mit_tpu_torch.decode.step import (
    decoder_step,
    grow_cache,
    init_cache,
    prepare_decode_params,
    reindex_cache,
)
from mit_tpu_torch.models.decoder import DecoderConfig

_NEG = -1e30


def top_k_lowest_first(x: torch.Tensor, k: int):
    """The k largest of each row → (values, indices), in descending order
    and, among equal values, the lowest index first (``lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def beam_generate(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, 1, D) projected decoder memory
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
    beam_size: int = 3,
    memory_padding_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B, max_len) int64, scores (B,) f32): the best beam per
    item and the sum of its token log-probabilities."""
    b = memory.shape[0]
    k = beam_size
    v = cfg.vocab_size
    device = memory.device
    check_max_len(max_len, cfg)
    bucket_sizes = check_bucket_sizes(bucket_sizes, max_len)

    mem = memory.repeat_interleave(k, dim=0)
    mem_mask = (None if memory_padding_mask is None
                else memory_padding_mask.repeat_interleave(k, dim=0))
    cache = init_cache(params, cfg, mem, mem_mask, bucket_sizes[0],
                       compute_dtype)
    params = prepare_decode_params(params, compute_dtype, fused)

    tokens = start_tokens(b * k, max_len, start_id, pad_id, device)
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    # Only beam 0 of each item is alive at step 0: all beams are copies of
    # START, and top-k would otherwise pick k duplicates.
    scores = torch.where(torch.arange(k, device=device) == 0, 0.0, _NEG)
    scores = scores[None, :].expand(b, k)
    item_offset = (torch.arange(b, device=device) * k)[:, None]    # (B, 1)
    # a finished beam's only continuation: PAD at zero incremental score
    pad_onehot = torch.where(torch.arange(v, device=device) == pad_id, 0.0,
                             _NEG)

    pos = 0
    for i, bucket in enumerate(bucket_sizes):
        if i > 0:
            cache = grow_cache(cache, bucket)
        while pos < min(bucket, max_len - 1) and not bool(finished.all()):
            logits, cache = decoder_step(
                params, cfg, tokens[:, pos], pos, cache, compute_dtype,
                key_pad=(tokens == pad_id)[:, :bucket], fused=fused,
            )
            logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
            logp = torch.where(finished[..., None], pad_onehot, logp)
            total = scores[..., None] + logp                       # (B, K, V)
            scores, flat_idx = top_k_lowest_first(total.reshape(b, k * v), k)
            src_beam = flat_idx // v                               # parent beam
            new_tok = flat_idx % v

            gather = (item_offset + src_beam).reshape(-1)          # (B*K,) rows
            tokens = tokens.index_select(0, gather)
            tokens[:, pos + 1] = new_tok.reshape(-1)
            cache = reindex_cache(cache, gather)
            finished = finished.gather(1, src_beam) | (new_tok == end_id)
            pos += 1

    # The best total log-probability, finished or not: finished beams
    # stopped accumulating, so raw sums compare fairly.
    best = scores.argmax(dim=1)                                    # (B,)
    rows = torch.arange(b, device=device) * k + best
    return tokens.index_select(0, rows), scores.gather(1, best[:, None])[:, 0]
