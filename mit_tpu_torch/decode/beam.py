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

from mit_tpu_torch.decode.graphs import (
    DecodeGraphs,
    LoopState,
    engages,
    ladder,
)
from mit_tpu_torch.decode.greedy import (
    check_bucket_sizes,
    check_max_len,
    start_tokens,
)
from mit_tpu_torch.decode.step import (
    cross_const,
    decoder_step,
    grow_cache,
    init_cache,
    prepare_decode_params,
    reindex_cache,
)
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.utils.profiling import span

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
    memory: torch.Tensor,              # (B, S, D) projected decoder memory
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
    beam_size: int = 3,
    memory_padding_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    fused: bool = False,
    steps: Optional[DecodeGraphs] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B, max_len) int64, scores (B,) f32): the best beam per
    item and the sum of its token log-probabilities. ``steps`` (one a
    caller, kept across calls) replays the loop from CUDA graphs where it
    engages (:mod:`~mit_tpu_torch.decode.graphs`); without it every step
    runs eagerly."""
    b = memory.shape[0]
    k = beam_size
    device = memory.device
    check_max_len(max_len, cfg)
    bucket_sizes = check_bucket_sizes(bucket_sizes, max_len)
    if steps is not None and engages(fused, cfg, memory, memory_padding_mask):
        out = replay_beam(steps, params, cfg, memory, start_id, end_id,
                          pad_id, max_len, k, bucket_sizes, compute_dtype)
        if out is not None:
            return out

    mem = memory.repeat_interleave(k, dim=0)
    mem_mask = (None if memory_padding_mask is None
                else memory_padding_mask.repeat_interleave(k, dim=0))
    with span("mit.decode.prepare"):
        cache = init_cache(params, cfg, mem, mem_mask, bucket_sizes[0],
                           compute_dtype)
        params = prepare_decode_params(params, compute_dtype, fused)

    tokens = start_tokens(b * k, max_len, start_id, pad_id, device)
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    scores = first_scores(b, k, device)
    item_offset = (torch.arange(b, device=device) * k)[:, None]    # (B, 1)
    pad_row = pad_continuation(cfg.vocab_size, pad_id, device)

    with span("mit.decode.loop"):
        for i, pos, grows in ladder(bucket_sizes, max_len, lambda: finished):
            if grows:
                cache = grow_cache(cache, bucket_sizes[i])
            logits, cache = decoder_step(
                params, cfg, tokens[:, pos], pos, cache, compute_dtype,
                key_pad=(tokens == pad_id)[:, :bucket_sizes[i]], fused=fused,
            )
            if steps is not None:
                steps.eager_steps += 1
            with span("mit.decode.select"):
                scores, src_beam, new_tok, gather = beam_select(
                    logits, finished, scores, pad_row, item_offset)
                tokens = tokens.index_select(0, gather)
                tokens[:, pos + 1] = new_tok.reshape(-1)
            with span("mit.decode.reorder"):
                cache = reindex_cache(cache, gather)
            with span("mit.decode.select"):
                finished = beam_finished(finished, src_beam, new_tok, end_id)

    return best_beams(tokens, scores)


def beam_select(logits: torch.Tensor, finished: torch.Tensor,
                scores: torch.Tensor, pad_row: torch.Tensor,
                item_offset: torch.Tensor):
    """One step's choice: each item's K best continuations over its beams'
    totals, ties to the lowest flat index (:func:`top_k_lowest_first`); a
    finished beam's only continuation is ``pad_row``. logits (B*K, V) f32,
    finished and scores (B, K), item_offset (B, 1) → (scores (B, K),
    parent beams (B, K), new tokens (B, K), parent rows (B*K,))."""
    b, k = scores.shape
    v = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
    logp = torch.where(finished[..., None], pad_row, logp)
    total = scores[..., None] + logp                               # (B, K, V)
    scores, flat_idx = top_k_lowest_first(total.reshape(b, k * v), k)
    src_beam = flat_idx // v                                       # parent beam
    new_tok = flat_idx % v
    return scores, src_beam, new_tok, (item_offset + src_beam).reshape(-1)


def beam_finished(finished: torch.Tensor, src_beam: torch.Tensor,
                  new_tok: torch.Tensor, end_id) -> torch.Tensor:
    """The finished flags (B, K) after a step: the parent beam's, or END
    just chosen."""
    return finished.gather(1, src_beam) | (new_tok == end_id)


def replay_beam(steps: DecodeGraphs, params: dict, cfg: DecoderConfig,
                memory: torch.Tensor, start_id: int, end_id: int, pad_id: int,
                max_len: int, k: int, bucket_sizes: Tuple[int, ...],
                compute_dtype):
    """:func:`beam_generate`'s fused loop over CLS ``memory`` (B, 1, D),
    replayed by ``steps`` → (tokens, scores), or None where the call is not
    the holder's key (the caller then steps eagerly)."""
    b, device = memory.shape[0], memory.device
    st = steps.loop(
        params, (cfg, b, k, max_len, bucket_sizes, compute_dtype, pad_id,
                 "beam"), device,
        lambda: BeamLoop(
            prepare_decode_params(params, compute_dtype, True), cfg, b * k,
            (b, k), max_len, bucket_sizes, compute_dtype, pad_id, device, 2),
        lambda: cross_const(params["layers"]["cross"],
                            memory.repeat_interleave(k, dim=0), compute_dtype),
        start_id, end_id, max_len)
    return None if st is None else best_beams(st.tokens, st.scores)


def first_scores(b: int, k: int, device) -> torch.Tensor:
    """(B, K) f32: only beam 0 of each item is alive at step 0. All beams
    are copies of START, and top-k would otherwise pick k duplicates."""
    scores = torch.where(torch.arange(k, device=device) == 0, 0.0, _NEG)
    return scores[None, :].expand(b, k)


def pad_continuation(v: int, pad_id: int, device) -> torch.Tensor:
    """(V,) f32: a finished beam's only continuation, PAD at zero
    incremental score."""
    return torch.where(torch.arange(v, device=device) == pad_id, 0.0, _NEG)


def best_beams(tokens: torch.Tensor, scores: torch.Tensor):
    """tokens (B*K, max_len), scores (B, K) → the beam of the best total
    log-probability of each item, finished or not (finished beams stopped
    accumulating, so raw sums compare fairly), and its score."""
    b, k = scores.shape
    best = scores.argmax(dim=1)                                    # (B,)
    rows = torch.arange(b, device=scores.device) * k + best
    return tokens.index_select(0, rows), scores.gather(1, best[:, None])[:, 0]


class BeamLoop(LoopState):
    """The beam loop's static state (:class:`~mit_tpu_torch.decode.graphs.
    LoopState`, two cache sets): also the scores (B, K) and the loop's
    constants."""

    def __init__(self, params, cfg, rows, finished_shape, *args):
        super().__init__(params, cfg, rows, finished_shape, *args)
        b, k = finished_shape
        device = self.tokens.device
        self.start_scores = first_scores(b, k, device)
        self.scores = self.start_scores.clone()
        self.item_offset = (torch.arange(b, device=device) * k)[:, None]
        self.pad_row = pad_continuation(cfg.vocab_size, self.pad_id, device)

    def reset(self, cross, start_id, end_id) -> None:
        super().reset(cross, start_id, end_id)
        self.scores.copy_(self.start_scores)

    def iteration(self, i: int, p: int) -> None:
        """The eager loop's step on the static buffers: the fused step from
        set ``p`` (:meth:`~mit_tpu_torch.decode.graphs.LoopState.step`),
        :func:`beam_select`, the tokens reordered and written at
        ``pos + 1``, set ``p``'s caches and cross constant gathered into
        set ``1 - p``, the finished flags and the scores."""
        src, dst = self.caches[i][p], self.caches[i][1 - p]
        col = self.pos.view(1)
        logits = self.step(i, p)
        with span("mit.decode.select"):
            scores, src_beam, new_tok, gather = beam_select(
                logits, self.finished, self.scores, self.pad_row,
                self.item_offset)
            self.tokens.copy_(self.tokens.index_select(0, gather))
            self.tokens.index_copy_(1, col + 1, new_tok.reshape(-1, 1))
        with span("mit.decode.reorder"):
            for a, out in zip(src.k + src.v, dst.k + dst.v):
                torch.index_select(a, 0, gather, out=out)
            torch.index_select(src.cross_const, 1, gather,
                               out=dst.cross_const)
        with span("mit.decode.select"):
            self.finished.copy_(beam_finished(self.finished, src_beam,
                                              new_tok, self.end))
            self.scores.copy_(scores)
            self.pos += 1
