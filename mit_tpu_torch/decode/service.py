"""Continuously batched captioning service (port of
``mit_tpu/decode/service.py``).

A static set of decode slots is kept full: when one caption ends, the next
queued image is admitted into its slot at the next window, instead of
waiting for the whole batch. Slots decode at their own positions, so the
step takes a per-slot position vector; it is the batch path's
:func:`~mit_tpu_torch.decode.step.decoder_step` itself, run over a
:class:`~mit_tpu_torch.decode.step.DecodeCache` view of the service's
buffers, so service and batch decoding share one step by construction (the
JAX package keeps two bit-identical copies, for XLA's sake).

- **Windows.** :func:`service_decode_window` advances every slot
  ``n_steps`` tokens; the token, position, active flag and PAD-key mask of
  each slot advance on the device between the micro-steps (the ``done``
  rule ``pos + 1 >= Tc - 1`` included), so the host reads back one
  (S, n_steps) block of token ids a window and replays it. Inactive slots
  are bit-frozen; a freed slot's cache rows are not cleared: the per-row
  visibility mask (key ``t`` visible iff ``t <= pos[row]``) hides them.
- **Beam search** (:func:`service_beam_window`): a slot owns K consecutive
  decoder rows, and the cache reorder gathers inside the slot's block.
  Scores freeze when a slot deactivates; the host replays (new_tok,
  src_beam). Ties break as :func:`~mit_tpu_torch.decode.beam.beam_generate`
  breaks them (:func:`~mit_tpu_torch.decode.beam.top_k_lowest_first`).
- **Sampling** draws from an explicit ``torch.Generator``, one stream a
  window, derived from the service's ``seed``; the overflow drain draws from
  streams of their own (the JAX package's ``fold_in(base, (1 << 20) +
  wave)``). JAX's PRNG streams cannot be reproduced in torch.
- **Memory modes.** CLS memory keeps an (L, R, D) f32 cross constant a
  decoder row (computed from f32 memory and weights, as the JAX service
  does; the batch path's ``init_cache`` computes it in the compute dtype,
  so the two differ in bf16 by design); full memory keeps (L, R, H, S_mem,
  hd) memory keys and values in the compute dtype. Both are computed when a
  chunk of memories lands (:meth:`CaptionService.submit_memory_batch`), and
  admission gathers a chunk's rows into the slots on the device: the memory
  never visits the host.
- **Routes.** With ``fused`` the CLS service runs every layer in
  ``fused_decode_layer`` at per-row positions; full memory runs the unfused
  layers (:func:`~mit_tpu_torch.decode.step.step_route`).
- **Buckets.** ``cache_len`` below ``max_len`` gives smaller caches; a
  caption that reaches the bucket without ending is evicted and re-decoded
  at full length through the batch loops when the service drains.

- **A device mesh** (``mesh``, the single-process form of
  ``parallel.mesh``): the slots split evenly over the "data" devices. Each
  device holds its ``num_slots / d`` slots' caches and cross state and a
  replica of the prepared weights; the host bookkeeping stays one. A window
  issues every device's part from this one thread, so the host's issue time
  grows with the number of devices. Greedy and beam windows run each
  device's slots alone; a sampling window gathers every slot's logits onto
  the first device and draws there from the one generator, so tokens equal
  the unsharded service's under every method. Chunks of memory land on the
  first device, and admission gathers a slot's cross rows there and moves
  them to its device. One code path serves one device or several: two
  shards on one device (the CPU, or one card) run every line of it, but
  it has not yet run across two cards.

One stream a device: the fused decode layer's grid barrier allows one
launch at a time on a card, so the service and the encoder chunks it pulls
run on the current stream. Left behind from the JAX package: the beam
gather skip (``MIT_BEAM_GATHER_SKIP``) and the power-of-two padding of
admission waves and encoder chunks, which bounds only XLA's compile cache.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mit_tpu_torch.decode.beam import top_k_lowest_first
from mit_tpu_torch.decode.sampling import filter_logits
from mit_tpu_torch.decode.step import (
    DecodeCache,
    cross_const,
    cross_kv,
    decoder_step,
    prepare_decode_params,
)
from mit_tpu_torch.models.decoder import DecoderConfig

# beam-score mask, as decode/beam.py's (service beam == beam_generate)
_NEG = -1e30
# the overflow drain's sampling streams: the JAX package's fold_in offset
_DRAIN_STREAM = 1 << 20


def _one_token_logits(params, cfg, tokens, pos, key_pad, k_cache, v_cache,
                      cross, compute_dtype, fused=False) -> torch.Tensor:
    """Advance every row one token at its own position → logits (R, V) f32.

    ``cross`` is ``{"const": (L, R, D)}`` (CLS memory) or ``{"k": (L, R, H,
    S_mem, hd), "v": ...}`` (full memory); the fresh K/V rows are written
    into ``k_cache`` / ``v_cache`` at ``(row, pos[row])`` in place."""
    cache = DecodeCache(k_cache, v_cache, cross.get("const"), cross.get("k"),
                        cross.get("v"), None)
    logits, _ = decoder_step(params, cfg, tokens, pos, cache, compute_dtype,
                             key_pad=key_pad, fused=fused)
    return logits


@torch.inference_mode()
def service_decode_window(
    shards: Sequence[tuple],           # one entry a device, as below
    cfg: DecoderConfig,
    end_id: int,
    pad_id: int,
    compute_dtype=torch.float32,
    n_steps: int = 1,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    fused: bool = False,
) -> List[tuple]:
    """``n_steps`` tokens for every slot → one (ids (S_j, n_steps), pos',
    active') a shard.

    Each entry of ``shards`` holds one device's slots: (params, a
    ``prepare_decode_params`` output; tokens (S_j,), the current token a
    slot; pos (S_j,); active (S_j,) bool; key_pad (S_j, T) bool, True = PAD
    key, updated in place; k_cache and v_cache, L × (S_j, T, D), written in
    place; cross, ``{"const"}`` or ``{"k", "v"}``). The slots are the
    shards' rows in order.

    Slot state advances on the device between the micro-steps with the host
    loop's semantics, so a window is token-identical to ``n_steps`` windows
    of one. ``temperature=0`` picks each shard's argmax on its device
    (greedy); otherwise every shard's logits are gathered on the first
    shard's device and each slot's token is drawn there from the
    temperature-scaled, top-k/top-p-filtered distribution
    (:func:`~mit_tpu_torch.decode.sampling.filter_logits`) with
    ``generator``, so the tokens do not depend on how the slots split."""
    states = [list(sh[1:5]) for sh in shards]
    first = shards[0][1].device
    outs: List[list] = [[] for _ in shards]
    for _ in range(n_steps):
        logits = [_one_token_logits(sh[0], cfg, tok, pos, kp, *sh[5:],
                                    compute_dtype, fused)
                  for sh, (tok, pos, _, kp) in zip(shards, states)]
        if temperature == 0.0:
            nxt = [lg.argmax(-1) for lg in logits]
        else:
            every = torch.cat([lg.to(first) for lg in logits])
            probs = torch.softmax(
                filter_logits(every, temperature, top_k, top_p), dim=-1)
            drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
            nxt = [x.to(lg.device) for x, lg in zip(
                drawn.split([lg.shape[0] for lg in logits]), logits)]
        for sh, st, out, x in zip(shards, states, outs, nxt):
            out.append(x)
            st[:3] = _advance(x, *st, sh[5][0].shape[1], end_id, pad_id)
    return [(torch.stack(out, dim=1), st[1], st[2])
            for out, st in zip(outs, states)]


def _advance(nxt, tokens, pos, active, key_pad, t_max, end_id, pad_id):
    """One micro-step of the slots' state on the device: the token, the
    position, the PAD-key mask (in place) and the ``done`` rule at cache
    length ``t_max``."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    newpos = (pos + 1).clamp(max=t_max - 1)
    key_pad[rows, newpos] = torch.where(active, nxt == pad_id,
                                        key_pad[rows, newpos])
    done = active & ((nxt == end_id) | (pos + 1 >= t_max - 1))
    tokens = torch.where(active, nxt, tokens)
    pos = torch.where(active, newpos, pos)
    return tokens, pos, active & ~done


@torch.inference_mode()
def service_beam_window(
    params: dict,
    cfg: DecoderConfig,
    tokens: torch.Tensor,              # (R,) current token per beam row
    pos: torch.Tensor,                 # (S,) decode position per slot
    active: torch.Tensor,              # (S,) bool
    key_pad: torch.Tensor,             # (R, T) bool
    k_cache: list,                     # L × (R, T, D); entries replaced
    v_cache: list,
    cross: dict,                       # each slot's state on its K rows
    scores: torch.Tensor,              # (S, K) f32 total log-probability
    finished: torch.Tensor,            # (S, K) bool
    end_id: int,
    pad_id: int,
    beam_size: int = 3,
    compute_dtype=torch.float32,
    n_steps: int = 1,
    fused: bool = False,
):
    """``n_steps`` beam-search tokens for every slot → (new_tok (S, K, n),
    src_beam (S, K, n), scores', finished', pos', active'). ``k_cache`` and
    ``v_cache`` (lists) hold the reordered caches after the call.

    Every slot owns K consecutive rows; each micro-step scores all R = S·K
    rows in one decoder step, takes the slot's top K of its K·V
    continuations and gathers its K cache and PAD-key rows by parent beam.
    Finished beams extend with PAD at zero score; a slot deactivates when
    all its beams are finished or the length cap is hit, and is then frozen.
    """
    k = beam_size
    r = tokens.shape[0]
    s = r // k
    t_max = k_cache[0].shape[1]
    v = params["fc_b"].shape[0]
    device = tokens.device
    rows = torch.arange(r, device=device)
    slot_offset = (torch.arange(s, device=device) * k)[:, None]   # (S, 1)
    ident = slot_offset + torch.arange(k, device=device)[None, :]  # (S, K)
    pad_onehot = torch.where(torch.arange(v, device=device) == pad_id, 0.0,
                             _NEG)
    tok_outs, src_outs = [], []
    for _ in range(n_steps):
        logits = _one_token_logits(params, cfg, tokens,
                                   pos.repeat_interleave(k), key_pad, k_cache,
                                   v_cache, cross, compute_dtype, fused)
        logp = torch.log_softmax(logits, dim=-1).reshape(s, k, v)
        logp = torch.where(finished[..., None], pad_onehot, logp)
        total = scores[..., None] + logp                            # (S, K, V)
        new_scores, flat_idx = top_k_lowest_first(total.reshape(s, k * v), k)
        src_beam = flat_idx // v
        new_tok = flat_idx % v
        tok_outs.append(new_tok)
        src_outs.append(src_beam)

        # inactive slots: the identity gather, their state unchanged
        gather = torch.where(active[:, None], slot_offset + src_beam,
                             ident).reshape(-1)                     # (R,)
        for i in range(len(k_cache)):
            k_cache[i] = k_cache[i].index_select(0, gather)
            v_cache[i] = v_cache[i].index_select(0, gather)
        key_pad = key_pad.index_select(0, gather)
        finished = torch.where(
            active[:, None],
            finished.gather(1, src_beam) | (new_tok == end_id), finished)
        scores = torch.where(active[:, None], new_scores, scores)

        newpos = (pos + 1).clamp(max=t_max - 1)
        sel_tok = torch.where(active[:, None], new_tok,
                              tokens.reshape(s, k)).reshape(-1)
        newpos_rows = newpos.repeat_interleave(k)
        key_pad[rows, newpos_rows] = torch.where(
            active.repeat_interleave(k), sel_tok == pad_id,
            key_pad[rows, newpos_rows])
        tokens = sel_tok
        done = active & (finished.all(dim=1) | (pos + 1 >= t_max - 1))
        pos = torch.where(active, newpos, pos)
        active = active & ~done
    return (torch.stack(tok_outs, dim=2), torch.stack(src_outs, dim=2),
            scores, finished, pos, active)


def service_decode_step(params, cfg, tokens, pos, active, key_pad, k_cache,
                        v_cache, cross, compute_dtype=torch.float32,
                        fused=False) -> torch.Tensor:
    """One greedy token for every slot → next ids (S,)."""
    (ids, _, _), = service_decode_window(
        [(params, tokens, pos, active, key_pad, k_cache, v_cache, cross)],
        cfg, -1, -1, compute_dtype, 1, fused=fused)
    return ids[:, 0]


def _cross_const_for(cross: dict, memory: torch.Tensor) -> torch.Tensor:
    """(L, B, D) f32 CLS cross constant of f32 memory (B, 1, D)."""
    return cross_const(cross, memory, torch.float32)


def _cross_kv_for(cross: dict, memory: torch.Tensor, h: int, cd) -> dict:
    """Full-memory cross keys and values ``{"k", "v"}``, each (L, B, H, S,
    hd) in ``cd``: the batch path's ``init_cache`` terms, so service
    captions equal batch full-memory captions."""
    ck, cv = cross_kv(cross, memory, h, cd)
    return {"k": ck, "v": cv}


def _scatter_cross_rows(cross: dict, rows: dict, idx) -> None:
    """cross rows ``idx`` (W,) ← ``rows`` (one per index), in place. Every
    entry keeps the decoder-row dimension on axis 1."""
    for name, c in cross.items():
        c[:, idx] = rows[name]


def _to_device(tree, device):
    """A parameter tree on ``device`` (a leaf already there is kept, not
    copied)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _derived_seed(base: int, salt: int) -> int:
    """A 63-bit seed for stream ``salt`` of base seed ``base``."""
    return (base * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (1 << 63)


class _SlotShard:
    """One device's slots ``lo .. hi`` (its decoder rows from 0): their
    caches and cross state, and the prepared weights and cross projections
    on that device."""

    def __init__(self, device, lo, hi, prepared, cross_proj, k_cache,
                 v_cache, cross):
        self.device, self.lo, self.hi = device, lo, hi
        self.prepared, self.cross_proj = prepared, cross_proj
        self.k_cache, self.v_cache, self.cross = k_cache, v_cache, cross


class CaptionService:
    """Host-side orchestration of the continuously batched decode loop."""

    def __init__(
        self,
        captioner,                     # decode.api.Captioner
        num_slots: int = 64,
        max_len: Optional[int] = None,
        compute_dtype=None,
        steps_per_sync: int = 1,
        method: str = "greedy",
        beam_size: Optional[int] = None,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        cache_len: Optional[int] = None,
        fused: Optional[bool] = None,
        mesh=None,
    ):
        """``steps_per_sync``: tokens a window, between two read-backs
        (token-identical to 1; admission waits for the window's end).

        ``cache_len``: the slots' static cache length (default ``max_len``).
        Every step reads the whole cache, so set it just above the typical
        caption length; a caption that reaches it without ending is evicted
        and re-decoded at full ``max_len`` through the batch loops when the
        service drains: token-identical for greedy and beam, a fresh stream
        for ``method="sample"``.

        ``method``: ``"greedy"``, ``"beam"`` (K = ``beam_size`` or the
        captioner's) or ``"sample"`` (temperature, top-k, top-p, drawn from
        generators derived from ``seed``; the same seed and submission order
        repeat the same captions).

        ``compute_dtype`` and ``fused`` default to the captioner's.

        ``mesh``: a single-process ``parallel.mesh.Mesh`` (``create_mesh``);
        the slots split evenly over its "data" devices, so ``num_slots``
        must divide by their count."""
        if method not in ("greedy", "beam", "sample"):
            raise ValueError(
                f"method must be 'greedy', 'beam' or 'sample', got {method!r}")
        if captioner.mcfg.language_model != "decoder":
            raise NotImplementedError(
                "CaptionService serves the 'decoder' language model only, "
                f"not {captioner.mcfg.language_model!r}")
        if cache_len is not None and cache_len < 4:
            raise ValueError(
                f"cache_len={cache_len} leaves no room to decode (START and at "
                "least two generated tokens); use >= 4")
        self.cap = captioner
        cfg = captioner.mcfg.decoder
        self.cfg = cfg
        self.full_mem = captioner.mcfg.memory_mode != "cls"
        self.s_mem = captioner.mcfg.vision.seq_len if self.full_mem else 1
        self.S = num_slots
        self.T = min(max_len or cfg.max_seq_len, cfg.max_seq_len)
        # the slots' cache length; below T, overflow goes to the batch loops
        self.Tc = min(cache_len, self.T) if cache_len is not None else self.T
        self.cd = captioner.compute_dtype if compute_dtype is None \
            else compute_dtype
        self.fused = captioner.fused_decode if fused is None else bool(fused)
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.method = method
        self.K = (beam_size or captioner.beam_size) if method == "beam" else 1
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._seed = int(seed)
        self._wave = 0
        dec = captioner.params["decoder"]
        devices = [dec["token_embedding"].device]
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("CaptionService takes the single-process "
                                 "mesh of parallel.mesh.create_mesh")
            n_data = mesh.shape["data"]
            if num_slots % n_data != 0:
                raise ValueError(
                    f"num_slots={num_slots} must be divisible by the mesh "
                    f"data axis ({n_data}).")
            devices = [mesh.devices[i, 0] for i in range(n_data)]
        self.mesh = mesh
        self.device = devices[0]
        self.R = num_slots * self.K
        per = num_slots // len(devices)
        replicas = {}           # device -> (prepared, cross projections)
        self.shards = []
        for j, dev in enumerate(devices):
            if dev not in replicas:
                replicas[dev] = self._replica(_to_device(dec, dev))
            self.shards.append(_SlotShard(
                dev, j * per, (j + 1) * per, *replicas[dev],
                *self._state(per * self.K, dev)))
        self._cross_proj = self.shards[0].cross_proj
        pad = captioner.tokenizer.pad_id
        if method == "beam":
            # (S, K, Tc) token history per beam, replayed on the host
            self.tokens = np.full((num_slots, self.K, self.Tc), pad, np.int64)
            self.scores = np.zeros((num_slots, self.K), np.float32)
            self.finished = np.zeros((num_slots, self.K), bool)
        else:
            self.tokens = np.full((num_slots, self.Tc), pad, np.int64)
        self.pos = np.zeros((num_slots,), np.int64)
        self.active = np.zeros((num_slots,), bool)
        self.slot_request: List[Optional[int]] = [None] * num_slots
        # each active slot's memory: a host (1, S_mem, D) array, or a
        # ("dev", chunk_id, row) reference into a device-resident chunk
        self.slot_memory: List[Optional[object]] = [None] * num_slots
        self._queue: List[Tuple[int, object]] = []
        # chunk_id -> {"mem": (C, S_mem, D) f32, "cross": its cross state}
        self._chunks: Dict[int, Dict[str, object]] = {}
        self._next_chunk = 0
        self._overflow: List[Tuple[int, np.ndarray]] = []
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        self.steps_run = 0
        self.overflowed = 0
        self.windows = 0
        # admissions into a slot that had served a request, while another
        # slot was still decoding: continuous batching at work
        self.reused = 0
        self._served = np.zeros((num_slots,), bool)

    def _replica(self, dec: dict):
        """(prepared weights, f32 cross projections) of ``dec``."""
        cross_raw = dec["layers"]["cross"]
        return (prepare_decode_params(dec, self.cd, self.fused),
                {k: cross_raw[k].float()
                 for k in (("wk", "bk", "wv", "bv") if self.full_mem
                           else ("wv", "bv", "wo", "bo"))})

    def _state(self, rows: int, device):
        """Zeroed caches and cross state of ``rows`` decoder rows."""
        L, d = self.cfg.num_layers, self.cfg.embed_dim
        zeros = lambda *shape, dtype=self.cd: torch.zeros(
            shape, dtype=dtype, device=device)
        k_cache = [zeros(rows, self.Tc, d) for _ in range(L)]
        v_cache = [zeros(rows, self.Tc, d) for _ in range(L)]
        if self.full_mem:
            h = self.cfg.num_heads
            cross = {"k": zeros(L, rows, h, self.s_mem, d // h),
                     "v": zeros(L, rows, h, self.s_mem, d // h)}
        else:
            cross = {"const": zeros(L, rows, d, dtype=torch.float32)}
        return k_cache, v_cache, cross

    # the first device's caches and cross state (all of them without a mesh)
    k_cache = property(lambda self: self.shards[0].k_cache)
    v_cache = property(lambda self: self.shards[0].v_cache)
    cross = property(lambda self: self.shards[0].cross)

    # ------------------------------------------------------------------
    def _put(self, a: np.ndarray, device=None) -> torch.Tensor:
        """A host array on ``device`` (default the service's first); on a
        card through pinned memory, so the copy does not wait for it."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.array(a))           # a copy: never aliased
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Device tensors → numpy arrays, with one wait for each device."""
        if all(t.device.type != "cuda" for t in tensors):
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        for dev in {t.device for t in tensors}:
            torch.cuda.current_stream(dev).synchronize()
        return [h.numpy() for h in host]

    def _generator(self, salt: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_derived_seed(self._seed, salt))
        return g

    def _cross_rows_for(self, mem: torch.Tensor) -> dict:
        """(W, S_mem, D) f32 memories → their cross state."""
        if self.full_mem:
            return _cross_kv_for(self._cross_proj, mem, self.cfg.num_heads,
                                 self.cd)
        return {"const": _cross_const_for(self._cross_proj, mem)}

    def _enqueue(self, memory) -> int:
        if isinstance(memory, torch.Tensor):
            memory = memory.detach().float().cpu().numpy()
        rid = self._next_id
        self._next_id += 1
        self._queue.append(
            (rid, np.asarray(memory, np.float32).reshape(1, self.s_mem, -1)))
        return rid

    def submit(self, image) -> int:
        """Queue one PIL image → its request id."""
        return self._enqueue(self.cap.memory_from_images([image]))

    def submit_memory(self, memory_row) -> int:
        """Queue one memory row ((S_mem, D) or (1, S_mem, D)) from the host."""
        return self._enqueue(memory_row)

    @torch.inference_mode()
    def submit_memory_batch(self, memory, real: Optional[int] = None
                            ) -> List[int]:
        """Queue a chunk of memories that stays on the device: (C, D) or
        (C, 1, D) CLS memory, or (C, S_mem, D) full memory. Its cross state
        is computed here, when the chunk lands, so admission only gathers
        rows on the device. ``real``: the leading rows to queue (default
        all)."""
        mem = torch.as_tensor(memory).to(self.device, torch.float32)
        c = mem.shape[0]
        mem = mem.reshape(c, self.s_mem, -1)
        real = c if real is None else real
        cid = self._next_chunk
        self._next_chunk += 1
        self._chunks[cid] = {"mem": mem, "cross": self._cross_rows_for(mem)}
        ids = []
        for r in range(real):
            rid = self._next_id
            self._next_id += 1
            self._queue.append((rid, ("dev", cid, r)))
            ids.append(rid)
        return ids

    def _gc_chunks(self) -> None:
        """Drop the chunks that no queued request or active slot needs."""
        if not self._chunks:
            return
        live = {m[1] for _, m in self._queue
                if isinstance(m, tuple) and m[0] == "dev"}
        live |= {m[1] for m in self.slot_memory
                 if isinstance(m, tuple) and m[0] == "dev"}
        for cid in [c for c in self._chunks if c not in live]:
            del self._chunks[cid]

    def submit_batch(self, images: Sequence,
                     encode_batch_size: int = 256) -> List[int]:
        """Queue many images, encoded in chunks of ``encode_batch_size``
        that stay on the device (:meth:`submit_memory_batch`)."""
        ids: List[int] = []
        for i in range(0, len(images), encode_batch_size):
            chunk = list(images[i:i + encode_batch_size])
            ids.extend(self.submit_memory_batch(
                self.cap.memory_from_images(chunk)))
        return ids

    @torch.inference_mode()
    def _admit(self) -> None:
        """Fill free slots from the queue: host bookkeeping, then one
        gather-and-scatter of cross state on the device for each run of
        admissions from one source. The caches need no reset."""
        free = [i for i in range(self.S) if not self.active[i]]
        runs: List[list] = []          # [kind, chunk_id, rows, slots]
        tok = self.cap.tokenizer
        busy = bool(self.active.any())
        while free and self._queue:
            slot = free.pop()
            self.reused += int(busy and self._served[slot])
            self._served[slot] = True
            rid, memory = self._queue.pop(0)
            if isinstance(memory, tuple) and memory[0] == "dev":
                _, cid, r = memory
                if runs and runs[-1][0] == "dev" and runs[-1][1] == cid:
                    runs[-1][2].append(r)
                    runs[-1][3].append(slot)
                else:
                    runs.append(["dev", cid, [r], [slot]])
            else:
                row = np.asarray(memory, np.float32).reshape(self.s_mem, -1)
                if runs and runs[-1][0] == "host":
                    runs[-1][2].append(row)
                    runs[-1][3].append(slot)
                else:
                    runs.append(["host", None, [row], [slot]])
            self.tokens[slot] = tok.pad_id
            if self.method == "beam":
                self.tokens[slot, :, 0] = tok.start_id
                # only beam 0 is alive at step 0 (K copies of START)
                self.scores[slot] = _NEG
                self.scores[slot, 0] = 0.0
                self.finished[slot] = False
            else:
                self.tokens[slot, 0] = tok.start_id
            self.pos[slot] = 0
            self.active[slot] = True
            self.slot_request[slot] = rid
            self.slot_memory[slot] = memory
        for kind, cid, payload, slots in runs:
            for sh in self.shards:
                sel = [i for i, s in enumerate(slots) if sh.lo <= s < sh.hi]
                if sel:
                    self._admit_rows(sh, kind, cid, [payload[i] for i in sel],
                                     [slots[i] - sh.lo for i in sel])
        if runs:
            self._gc_chunks()

    def _admit_rows(self, sh: _SlotShard, kind: str, cid, payload,
                    slots) -> None:
        """Cross state into one device's ``slots`` (its own numbering): from
        the chunk ``cid``'s rows ``payload``, or from host memory rows."""
        # a slot's K consecutive rows share its memory
        idx = self._put(np.array(
            [s * self.K + k for s in slots for k in range(self.K)]), sh.device)
        if kind == "dev":
            # gathered where the chunk lies, then moved to the shard's device
            src = self._put(np.repeat(np.array(payload), self.K))
            rows = {name: c[:, src].to(sh.device)
                    for name, c in self._chunks[cid]["cross"].items()}
        else:
            mems = self._put(np.repeat(np.stack(payload), self.K, axis=0),
                             sh.device)
            rows = (_cross_kv_for(sh.cross_proj, mems, self.cfg.num_heads,
                                  self.cd) if self.full_mem else
                    {"const": _cross_const_for(sh.cross_proj, mems)})
        _scatter_cross_rows(sh.cross, rows, idx)

    def _finish(self, slot: int) -> None:
        rid = self.slot_request[slot]
        if self.method == "beam":
            # the best total log-probability, finished or length-capped
            best = int(np.argmax(self.scores[slot]))
            row = self.tokens[slot, best]
            length = int((row != self.cap.tokenizer.pad_id).sum())
            self._results[rid] = row[:length].tolist()
        else:
            self._results[rid] = self.tokens[slot, :int(self.pos[slot]) + 1
                                             ].tolist()
        self.active[slot] = False
        self.slot_request[slot] = None
        self.slot_memory[slot] = None

    def _overflow_slot(self, slot: int) -> None:
        """Evict a caption that outgrew the cache; it is re-decoded at full
        length when the service drains."""
        m = self.slot_memory[slot]
        if isinstance(m, tuple) and m[0] == "dev":
            # the one row, so that its chunk can be dropped
            m = self._chunks[m[1]]["mem"][m[2]][None].cpu().numpy()
        self._overflow.append((self.slot_request[slot], m))
        self.overflowed += 1
        self.active[slot] = False
        self.slot_request[slot] = None
        self.slot_memory[slot] = None

    def _drain_overflow(self) -> None:
        """Batch-decode every evicted request at full length. Greedy and
        beam decoding are deterministic, so this repeats the bucketed prefix
        and goes on past it, as an unbucketed service would (a greedy or
        sampled caption ends at its END, as a slot's does; the JAX service
        cuts it at its count of tokens that are not PAD, which a PAD
        generated inside the caption makes shorter)."""
        if not self._overflow:
            return
        from mit_tpu_torch.decode.beam import beam_generate
        from mit_tpu_torch.decode.greedy import greedy_generate
        from mit_tpu_torch.decode.sampling import sample_generate

        pending, self._overflow = self._overflow, []
        tok = self.cap.tokenizer
        dec = self.cap.params["decoder"]
        rids = [r for r, _ in pending]
        mem = torch.from_numpy(np.concatenate([m for _, m in pending])) \
            .to(self.device)
        self._gc_chunks()
        common = dict(compute_dtype=self.cd, fused=self.fused)
        if self.method == "beam":
            tokens, _ = beam_generate(dec, self.cfg, mem, tok.start_id,
                                      tok.end_id, tok.pad_id, self.T, self.K,
                                      **common)
            lengths = (tokens != tok.pad_id).sum(dim=1)
        elif self.method == "sample":
            gen = self._generator(_DRAIN_STREAM + self._wave)
            self._wave += 1
            tokens, lengths = sample_generate(
                dec, self.cfg, mem, gen, tok.start_id, tok.end_id, tok.pad_id,
                self.T, temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, **common)
        else:
            tokens, lengths = greedy_generate(dec, self.cfg, mem, tok.start_id,
                                              tok.end_id, tok.pad_id, self.T,
                                              **common)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        if self.method != "beam":
            # up to the END, as a slot's caption is: a generated PAD inside
            # the caption is not the end of it (the batch loops' lengths
            # count the tokens that are not PAD)
            ended = tokens == tok.end_id
            lengths = np.where(ended.any(1), ended.argmax(1) + 1, self.T)
        for i, rid in enumerate(rids):
            self._results[rid] = tokens[i, :lengths[i]].tolist()

    def step(self) -> None:
        """Admissions, then one window (``steps_per_sync`` tokens) for the
        active slots."""
        self._admit()
        if not self.active.any():
            return
        self.windows += 1
        if self.method == "beam":
            self._step_beam()
        else:
            self._step_flat()

    def _step_flat(self) -> None:
        """A greedy or sampling window: one decoder row a slot."""
        end_id = self.cap.tokenizer.end_id
        pad_id = self.cap.tokenizer.pad_id
        if self.method == "sample":
            gen, temperature = self._generator(self._wave), self.temperature
            self._wave += 1
        else:
            gen, temperature = None, 0.0
        cur = self.tokens[np.arange(self.S), self.pos]
        key_pad = self.tokens == pad_id
        outs = service_decode_window(
            [(sh.prepared, *(self._put(a[sh.lo:sh.hi], sh.device)
                             for a in (cur, self.pos, self.active, key_pad)),
              sh.k_cache, sh.v_cache, sh.cross) for sh in self.shards],
            self.cfg, end_id, pad_id, self.cd, self.steps_per_sync, gen,
            temperature, self.top_k, self.top_p, self.fused)
        ids = np.concatenate(self._fetch(*(o[0] for o in outs)))  # (S, n)
        # replay the window's micro-steps (the device ran the same rules)
        for i in range(ids.shape[1]):
            act = self.active.copy()
            if not act.any():
                break
            nxt = ids[:, i]
            p = self.pos + 1
            self.tokens[np.where(act)[0], p[act]] = nxt[act]
            self.pos[act] = p[act]
            self.steps_run += 1
            ended = act & (nxt == end_id)
            capped = act & ~ended & (p >= self.Tc - 1)
            for slot in np.where(ended | capped)[0]:
                if capped[slot] and self.Tc < self.T:
                    self._overflow_slot(int(slot))
                else:
                    self._finish(int(slot))

    def _step_beam(self) -> None:
        """A beam window: K decoder rows a slot, the reorder replayed."""
        end_id = self.cap.tokenizer.end_id
        pad_id = self.cap.tokenizer.pad_id
        s_idx = np.arange(self.S)[:, None]
        cur = self.tokens[s_idx, np.arange(self.K)[None, :], self.pos[:, None]]
        key_pad = self.tokens == pad_id                     # (S, K, Tc)
        outs = []
        for sh in self.shards:
            sl, n = slice(sh.lo, sh.hi), (sh.hi - sh.lo) * self.K
            put = lambda a: self._put(a, sh.device)
            outs.extend(service_beam_window(
                sh.prepared, self.cfg, put(cur[sl].reshape(n)),
                put(self.pos[sl]), put(self.active[sl]),
                put(key_pad[sl].reshape(n, self.Tc)), sh.k_cache, sh.v_cache,
                sh.cross, put(self.scores[sl]), put(self.finished[sl]), end_id,
                pad_id, self.K, self.cd, self.steps_per_sync, self.fused)[:3])
        got = self._fetch(*outs)
        ids, srcs, scores = (np.concatenate(got[i::3]) for i in range(3))
        # scores freeze at deactivation: the window's are each slot's final
        self.scores = scores.copy()
        for i in range(ids.shape[2]):
            act = self.active.copy()
            if not act.any():
                break
            nt = ids[:, :, i]                                   # (S, K)
            sb = srcs[:, :, i]
            p = self.pos + 1
            idx = np.where(act)[0]
            sb_a = sb[idx]
            self.tokens[idx] = np.take_along_axis(self.tokens[idx],
                                                  sb_a[:, :, None], axis=1)
            self.tokens[idx[:, None], np.arange(self.K)[None, :],
                        p[idx][:, None]] = nt[idx]
            self.finished[idx] = (
                np.take_along_axis(self.finished[idx], sb_a, axis=1)
                | (nt[idx] == end_id))
            self.pos[act] = p[act]
            self.steps_run += 1
            all_fin = self.finished.all(axis=1)
            done = act & (all_fin | (p >= self.Tc - 1))
            for slot in np.where(done)[0]:
                # a capped slot with live beams could still find a better
                # finished hypothesis at full length
                if not all_fin[slot] and self.Tc < self.T:
                    self._overflow_slot(int(slot))
                else:
                    self._finish(int(slot))

    # ------------------------------------------------------------------
    def run_to_completion(self, max_steps: int = 100000) -> Dict[int, List[int]]:
        steps = 0
        while (self._queue or self.active.any()) and steps < max_steps:
            self.step()
            steps += 1
        self._drain_overflow()
        self._gc_chunks()
        return dict(self._results)

    def run_stream(self, encodes: Iterator, lookahead: int = 2,
                   max_steps: int = 100000) -> List[int]:
        """Drive the decode loop over a lazy stream of encoder chunks →
        request ids in stream order.

        ``encodes`` yields ``(memory, real_rows)``: a (chunk, S_mem, D)
        memory on the device, of which the leading ``real_rows`` are
        requests. Each ``next()`` issues one chunk's encoder work, which the
        device runs after the window already queued while the host replays
        that window; ``lookahead`` chunks are pulled ahead. A chunk enters
        the queue when the queue holds fewer than ``num_slots`` requests."""
        ids: List[int] = []
        inflight: List[Tuple[torch.Tensor, int]] = []
        exhausted = False

        def pull():
            nonlocal exhausted
            if exhausted:
                return
            try:
                inflight.append(next(encodes))
            except StopIteration:
                exhausted = True

        while len(inflight) < max(1, lookahead) and not exhausted:
            pull()
        steps = 0
        while steps < max_steps:
            while inflight and len(self._queue) < self.S:
                memory, real = inflight.pop(0)
                ids.extend(self.submit_memory_batch(memory, real))
                pull()
            if not (self._queue or self.active.any() or inflight):
                break
            self.step()
            steps += 1
        self._drain_overflow()
        self._gc_chunks()
        return ids

    def caption_stream(self, images: Sequence,
                       encode_batch_size: int = 256) -> List[str]:
        """Images → captions in submission order, through :meth:`run_stream`
        with chunks of ``encode_batch_size``."""
        def encodes():
            for i in range(0, len(images), encode_batch_size):
                chunk = list(images[i:i + encode_batch_size])
                yield self.cap.memory_from_images(chunk), len(chunk)

        ids = self.run_stream(encodes())
        return [self.cap.postprocess(self._results[r]) for r in ids]

    def result(self, request_id: int) -> Optional[List[int]]:
        return self._results.get(request_id)
