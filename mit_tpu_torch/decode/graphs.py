"""The batch decode loops' control, and their replay from CUDA graphs.

:func:`ladder` is the control every batch loop (``greedy.py``,
``beam.py``, ``sampling.py``) runs its steps under: the cache ladder,
with the host's read of ``finished.all()`` before each step.

:class:`DecodeGraphs` is how one captioner runs the greedy and beam loops.
A loop engages it only where the graphed iteration is the eager fused
route's own work (:func:`engages`): CUDA tensors, the fused step over the
CLS cross constant. Under the rule of :mod:`mit_tpu_torch.utils.cuda_graphs`,
keyed by (weights, decoder config, batch, beams, ``max_len``, bucket
ladder, compute dtype, PAD id, method, device), it keeps the first key's
loop state in static buffers (:class:`LoopState`: the prepared weights, the
K/V caches of every bucket of the ladder, the tokens, the finished flags, a
position counter and the END id) and captures one whole iteration of the
loop at each bucket as a CUDA graph (beam search: two a bucket, one from
each of two cache sets, so the beams' cache gather writes the other set
instead of a fresh cache). Every later call of that key resets the state,
copies in the cross-attention constant and replays under the same
:func:`ladder`, so the steps taken, the tokens and the beam scores are the
eager fused route's, bit for bit. Every loop that does not engage steps
through the loop's own code.

The weights are prepared (cast and packed) once, at the first call of the
key, and kept: the holder does not see a later in-place change to them.

:func:`capture` captures all buckets at the first call, so a later batch
never captures. A replay runs none of the iteration's Python:
``decoder_step.routes`` and ``fused_decode_layer.launches`` count the
warm-ups and captures only, and the spans inside the iteration reach a
trace only from them; each replay runs under ``mit.decode.replay``.
``graph_replays`` counts iterations replayed, ``eager_steps`` the steps
run eagerly through a loop given this holder.
"""

from __future__ import annotations

from typing import Optional

import torch

from mit_tpu_torch.decode.step import DecodeCache, decoder_step, step_route
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.utils import cuda_graphs
from mit_tpu_torch.utils.profiling import span


def all_finished(finished: torch.Tensor) -> bool:
    """Whether every row has ended: the host's read-back before a step."""
    with span("mit.decode.sync"):
        return bool(finished.all())


def ladder(buckets, max_len: int, finished):
    """The batch loops' control → (bucket index, position, whether the
    cache grows into this bucket first) for each step. A step at ``pos``
    needs cache slot ``pos``, so bucket ``i`` serves ``pos < buckets[i]``,
    up to ``max_len - 1``; before every step the host reads
    ``finished().all()``, and the loop ends at the first that reads true."""
    pos = 0
    for i, bucket in enumerate(buckets):
        first = i > 0
        while pos < min(bucket, max_len - 1):
            if all_finished(finished()):
                return
            yield i, pos, first
            first = False
            pos += 1


def engages(fused: bool, cfg: DecoderConfig, memory,
            memory_padding_mask: Optional[torch.Tensor]) -> bool:
    """Whether the loops over ``memory`` replay graphs: on CUDA tensors,
    where every step takes the fused route over the CLS cross constant
    (unpadded (B, 1, D) memory, ``init_cache``'s rule)."""
    cls_memory = memory.shape[1] == 1 and memory_padding_mask is None
    return memory.is_cuda and step_route(fused, "cuda", cfg,
                                         cls_memory) == "fused"


def capture(st: "LoopState", device: torch.device) -> dict:
    """→ {(bucket index, cache set): CUDA graph} of ``st``'s iteration, each
    warmed up from position 0. All share one memory pool: they replay one
    at a time on one stream, and none keeps a tensor of its own between
    replays."""
    pool = torch.cuda.graph_pool_handle()
    graphs = {}
    for i in range(len(st.buckets)):
        for p in range(st.sets):
            st.pos.zero_()                 # the warm-up writes inside max_len
            graphs[i, p], _ = cuda_graphs.capture(
                lambda: st.iteration(i, p), device, pool)
    return graphs


class LoopState:
    """The static buffers of one key's loop: the prepared weights, the
    tokens (rows, ``max_len``), the finished flags, the position counter
    and the END id (0-dim int64), the cross-attention constant of each
    cache set (L, rows, D) and, for every bucket, ``sets`` caches of
    (rows, bucket, D) a layer, each holding its set's constant. A loop's
    subclass adds its own buffers and :meth:`iteration`."""

    def __init__(self, params: dict, cfg: DecoderConfig, rows: int,
                 finished_shape, max_len: int, buckets, compute_dtype,
                 pad_id: int, device, sets: int):
        self.params, self.cfg, self.buckets = params, cfg, tuple(buckets)
        self.compute_dtype, self.pad_id, self.sets = compute_dtype, pad_id, sets
        long = dict(dtype=torch.long, device=device)
        self.tokens = torch.full((rows, max_len), pad_id, **long)
        self.finished = torch.zeros(finished_shape, dtype=torch.bool,
                                    device=device)
        self.pos = torch.zeros((), **long)
        self.end = torch.zeros((), **long)
        d, layers = cfg.embed_dim, cfg.num_layers
        zeros = lambda *shape: torch.zeros(shape, dtype=compute_dtype,
                                           device=device)
        self.cross = [zeros(layers, rows, d) for _ in range(sets)]
        self.caches = [
            [DecodeCache([zeros(rows, t, d) for _ in range(layers)],
                         [zeros(rows, t, d) for _ in range(layers)],
                         self.cross[p]) for p in range(sets)]
            for t in self.buckets]

    def reset(self, cross: torch.Tensor, start_id: int, end_id: int) -> None:
        """A new batch: tokens PAD with START in slot 0, nothing finished,
        position 0, ``cross`` (L, rows, D) in set 0 and set 0's first
        caches zero, as ``init_cache`` makes them."""
        self.tokens.fill_(self.pad_id)
        self.tokens[:, 0] = start_id
        self.finished.zero_()
        self.pos.zero_()
        self.end.fill_(end_id)
        self.cross[0].copy_(cross)
        first = self.caches[0][0]
        for a in first.k + first.v:
            a.zero_()

    def grow(self, i: int, p: int) -> None:
        """Set ``p``'s caches of bucket ``i - 1`` into bucket ``i``'s, the
        new rows zero (``grow_cache``)."""
        src, dst = self.caches[i - 1][p], self.caches[i][p]
        with span("mit.decode.grow"):
            for a, b in zip(src.k + src.v, dst.k + dst.v):
                b[:, :a.shape[1]].copy_(a)
                b[:, a.shape[1]:].zero_()

    def step(self, i: int, p: int) -> torch.Tensor:
        """The fused decoder step from set ``p``'s caches of bucket ``i``,
        at the counter's position (``decoder_step``'s per-row route) →
        logits (rows, V) f32."""
        col = self.pos.view(1)
        logits, _ = decoder_step(
            self.params, self.cfg, self.tokens.index_select(1, col)[:, 0],
            self.pos.expand(self.tokens.shape[0]), self.caches[i][p],
            self.compute_dtype,
            key_pad=(self.tokens == self.pad_id)[:, :self.buckets[i]],
            fused=True,
        )
        return logits

    def iteration(self, i: int, p: int) -> None:
        """One step of the loop at bucket ``i`` from cache set ``p``, on
        the static buffers only."""
        raise NotImplementedError


class DecodeGraphs(cuda_graphs.GraphHolder):
    """One captioner's graphs of its decode loops (see the module
    docstring)."""

    @property
    def state(self) -> Optional[LoopState]:
        """The first key's static state; None before it is captured."""
        return None if self.held is None else self.held[0]

    def loop(self, params: dict, key: tuple, device: torch.device, build,
             cross, start_id: int, end_id: int,
             max_len: int) -> Optional[LoopState]:
        """The loop of ``key`` (about ``params``, the raw weights, on
        ``device``) replayed on its static state, ``build()``'s, whose
        graphs the first call captures; ``cross()`` gives the batch's
        cross-attention constant. → the state after the loop, or None for
        any key but the first, whose loop steps eagerly. The caller has
        checked that the loop :func:`engages`."""
        def captured():
            st = build()
            with span("mit.decode.capture"):
                graphs = capture(st, device)
            self.graph_captures += len(graphs)
            # the weights stay referenced, so their id keys them
            return st, graphs, params

        held = self.held_for((id(params), device) + key, captured)
        if held is None:
            return None
        st, graphs, _ = held
        with span("mit.decode.prepare"):
            st.reset(cross(), start_id, end_id)
        p = 0
        with span("mit.decode.loop"):
            for i, _, grows in ladder(st.buckets, max_len,
                                      lambda: st.finished):
                if grows:
                    st.grow(i, p)
                with span("mit.decode.replay"):
                    self.replay(graphs[i, p])
                # a step from set p leaves the next step's caches in the
                # next set
                p = (p + 1) % st.sets
        return st
