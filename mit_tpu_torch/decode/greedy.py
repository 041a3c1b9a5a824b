"""Batched KV-cached greedy decoding (port of ``mit_tpu/decode/greedy.py``).

Start from START, append the argmax of each step's logits, stop a row at
END (later positions hold PAD) and stop the loop when every row has ended.
The KV cache grows through a ladder of sizes (16, 32, ..., max_len), so
short captions never pay the attention reads of a max_len-sized cache.
``lax.while_loop``'s early exit becomes a host check of ``finished.all()``
before each step, under :func:`~mit_tpu_torch.decode.graphs.ladder`.
:func:`laddered_decode_loop` takes the rule that picks the next token, so
greedy decoding and sampling share it.
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
from mit_tpu_torch.decode.step import (
    DecodeCache,
    cross_const,
    decoder_step,
    grow_cache,
    init_cache,
    prepare_decode_params,
)
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.utils.profiling import span


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
    steps: Optional[DecodeGraphs] = None,
) -> torch.Tensor:
    """The token loop over the cache ladder → tokens. ``select_fn`` picks
    each step's next tokens from the logits; finished rows get PAD.
    ``steps`` counts the steps in its ``eager_steps``."""
    finished = torch.zeros(tokens.shape[0], dtype=torch.bool,
                           device=tokens.device)
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
                tokens[:, pos + 1] = next_tokens(
                    select_fn(logits, generator), finished, pad_id, end_id)
    return tokens


def next_tokens(picked: torch.Tensor, finished: torch.Tensor, pad_id: int,
                end_id) -> torch.Tensor:
    """A step's tokens: ``picked`` (B,), PAD in the rows already finished.
    ``finished`` (B,) takes in place the rows that chose END."""
    nxt = torch.where(finished, pad_id, picked)
    finished |= nxt == end_id
    return nxt


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
    memory: torch.Tensor,              # (B, S, D) projected decoder memory
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
    memory_padding_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    fused: bool = False,
    steps: Optional[DecodeGraphs] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B, max_len) int64 incl. the leading START, lengths (B,)).

    ``lengths`` counts tokens incl. START and END (when generated);
    positions past a row's END hold PAD. ``fused`` runs every step's layers
    in the fused decode-layer kernel. ``steps`` (one a caller, kept across
    calls) replays the loop from CUDA graphs where it engages
    (:mod:`~mit_tpu_torch.decode.graphs`); without it every step runs
    eagerly.
    """
    check_max_len(max_len, cfg)
    bucket_sizes = check_bucket_sizes(bucket_sizes, max_len)
    if steps is not None and engages(fused, cfg, memory, memory_padding_mask):
        out = replay_greedy(steps, params, cfg, memory, start_id, end_id,
                            pad_id, max_len, bucket_sizes, compute_dtype)
        if out is not None:
            return out
    with span("mit.decode.prepare"):
        cache = init_cache(params, cfg, memory, memory_padding_mask,
                           bucket_sizes[0], compute_dtype)
        params = prepare_decode_params(params, compute_dtype, fused)
    tokens = start_tokens(memory.shape[0], max_len, start_id, pad_id,
                          memory.device)
    tokens = laddered_decode_loop(params, cfg, cache, tokens, select_argmax,
                                  None, end_id, pad_id, max_len, bucket_sizes,
                                  compute_dtype, fused, steps)
    return tokens, (tokens != pad_id).sum(dim=1)


def replay_greedy(steps: DecodeGraphs, params: dict, cfg: DecoderConfig,
                  memory: torch.Tensor, start_id: int, end_id: int,
                  pad_id: int, max_len: int, bucket_sizes: Tuple[int, ...],
                  compute_dtype):
    """:func:`greedy_generate`'s fused loop over CLS ``memory`` (B, 1, D),
    replayed by ``steps`` → (tokens, lengths), or None where the call is
    not the holder's key (the caller then steps eagerly)."""
    b, device = memory.shape[0], memory.device
    st = steps.loop(
        params, (cfg, b, 1, max_len, bucket_sizes, compute_dtype, pad_id,
                 "greedy"), device,
        lambda: GreedyLoop(
            prepare_decode_params(params, compute_dtype, True), cfg, b, (b,),
            max_len, bucket_sizes, compute_dtype, pad_id, device, 1),
        lambda: cross_const(params["layers"]["cross"], memory, compute_dtype),
        start_id, end_id, max_len)
    if st is None:
        return None
    tokens = st.tokens.clone()
    return tokens, (tokens != pad_id).sum(dim=1)


class GreedyLoop(LoopState):
    """The greedy loop's static state (:class:`~mit_tpu_torch.decode.graphs.
    LoopState`, one cache set)."""

    def iteration(self, i: int, p: int) -> None:
        """The fused step (:meth:`~mit_tpu_torch.decode.graphs.LoopState.
        step`), the argmax, PAD after END, the token written at
        ``pos + 1``."""
        logits = self.step(i, p)
        with span("mit.decode.select"):
            nxt = next_tokens(select_argmax(logits), self.finished,
                              self.pad_id, self.end)
            self.tokens.index_copy_(1, self.pos.view(1) + 1, nxt[:, None])
            self.pos += 1


@torch.inference_mode()
def greedy_generate_uncached(
    params: dict,
    cfg: DecoderConfig,
    memory: torch.Tensor,              # (B, S, D) projected decoder memory
    start_id: int,
    end_id: int,
    pad_id: int,
    max_len: int,
) -> torch.Tensor:
    """Greedy decoding with no KV cache: the whole decoder re-runs over the
    growing prefix at every step, as the reference's loop does. The oracle
    of :func:`greedy_generate` and a readable spec of it; O(T²) in the
    caption's length, not for serving. → tokens (B, max_len) int64, START
    first, PAD after a row's END."""
    from mit_tpu_torch.models.decoder import decoder_forward

    b = memory.shape[0]
    seqs = [[start_id] for _ in range(b)]
    done = [False] * b
    for _ in range(max_len - 1):
        t = max(len(s) for s in seqs)
        batch = torch.full((b, t), pad_id, dtype=torch.int64)
        for i, s in enumerate(seqs):
            batch[i, :len(s)] = torch.tensor(s)
        logits = decoder_forward(params, cfg, batch.to(memory.device), memory)
        last = torch.tensor([len(s) - 1 for s in seqs], device=logits.device)
        nxt = logits[torch.arange(b, device=logits.device), last].argmax(-1)
        for i, tok in enumerate(nxt.tolist()):
            if done[i]:
                continue
            seqs[i].append(tok)
            done[i] = tok == end_id
        if all(done):
            break
    out = torch.full((b, max_len), pad_id, dtype=torch.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = torch.tensor(s[:max_len])
    return out.to(memory.device)
