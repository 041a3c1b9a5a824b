"""An open loop of single images served by ``CaptionService``.

Requests arrive on a schedule fixed before the window opens, whether or
not earlier ones have finished: the inter-arrival gaps are the quantiles
of an exponential distribution at ``rate`` (a Poisson stream), the same
set for every seed, in an order drawn from the seed. Each request is one
uint8 host image of ``image_hw`` from a pool made from the seed.

Every turn of the loop uploads, preprocesses and encodes the requests that
have come due as one chunk (at most ``max_chunk``; the rest wait for the
next turn), hands the chunk's memory to ``submit_memory_batch``, runs one
``step()`` (admissions, then a window of ``steps_per_sync`` tokens ending
in its read-back) and polls ``result()`` for every request in flight. A
request's latency runs from when it was due to the turn whose read-back
returned its caption. After the window closes, arrivals go on until every
request due in the window has its caption; one that has none a minute
past the close has failed.

In the profiled stretch of a traced run the loop also counts the least
time the decoder's layers could take over each window
(``serve.decode_layer_bound_ms``), from the slots it sees live around the
window (their positions, whether they are active, and the request each
holds, before and after ``step()``) and the lengths of the captions the
window finished.
"""

from __future__ import annotations

import time

import numpy as np

from capbench import arith, check as checks, core, program
from capbench.inputs import SEED_MASK, make_images, make_served_weights

PRODUCES = {"latency_p95_ms": "ms", "latency_p50_ms": "ms"}
DRAIN_S = 60.0


class State:
    pass


def schedule(rate: float, seconds: float, seed: int):
    """Due times (s from the window's start) of the arrivals."""
    n = int(rate * seconds) + 1
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    np.random.default_rng((seed * 7 + 1) & SEED_MASK).shuffle(gaps)
    return np.cumsum(gaps)


def _encode(ctx, st, rows):
    torch = ctx.torch
    with ctx.rec.span("serve.encode"):
        host = np.stack([st.images[i] for i in rows])
        x = torch.from_numpy(host).to(ctx.device)
        mem = st.cap.memory_from_pixels(program.preprocess(ctx.cfg, x))
    ctx.rec.count("serve.images", len(rows))
    return mem


def _slots(svc):
    return svc.pos.copy(), svc.active.copy(), list(svc.slot_request)


def live_keys(before, after, lengths: dict, n_steps: int) -> list:
    """For each micro-step of one window, the keys (position + 1) that
    every slot live at it sees. ``before`` and ``after`` are the slots'
    (positions, active, request ids) around the window, ``lengths`` the
    caption lengths (START and END included) of the requests it finished.
    A slot live before the window runs on from its position, one admitted
    in it from 0; it runs to the step before its position after the
    window, or to the step that put its END (its length − 2)."""
    (pos_b, act_b, req_b), (pos_a, act_a, req_a) = before, after
    spans, seen = [], set()
    for s in range(len(pos_b)):
        rb = req_b[s] if act_b[s] else None
        ra = req_a[s] if act_a[s] else None
        if rb is not None:
            seen.add(rb)
            last = pos_a[s] - 1 if ra == rb else lengths.get(rb, 0) - 2
            spans.append((int(pos_b[s]), int(last)))
        elif ra is not None:
            seen.add(ra)
            spans.append((0, int(pos_a[s]) - 1))
    spans += [(0, n - 2) for rid, n in lengths.items() if rid not in seen]
    steps = [[] for _ in range(n_steps)]
    for first, last in spans:
        for p in range(first, min(last, first + n_steps - 1) + 1):
            steps[p - first].append(p + 1)
    return steps


def _window_bound_ms(ctx, keys_by_step) -> float:
    dc = ctx.cfg["decoder"]
    return sum(dc["num_layers"] * arith.decode_layer_bound_rows(
        keys, ctx.cfg["compute_dtype"], dc["embed_dim"],
        dc["ff_dim"])["bound_ms"] for keys in keys_by_step if keys)


def setup(ctx):
    from mit_tpu_torch.decode.service import CaptionService

    p, cfg = ctx.params, ctx.cfg
    st = State()
    st.weights, ctx.info["end_margin"] = make_served_weights(ctx, cfg)
    pool = make_images(p["pool"], p["image_hw"], ctx.seed, ctx.device)
    st.images = pool.cpu().numpy()
    del pool
    st.cap = program.captioner(cfg, st.weights)
    sv = cfg["service"]
    st.svc = CaptionService(st.cap, num_slots=sv["num_slots"],
                            steps_per_sync=sv["steps_per_sync"],
                            method="greedy", cache_len=sv["cache_len"])
    rng = np.random.default_rng((ctx.seed * 7 + 2) & SEED_MASK)
    st.due = schedule(p["rate"], ctx.seconds + 10.0, ctx.seed)
    st.image_of = rng.integers(0, p["pool"], st.due.size)
    # every chunk size the loop can form, each through the whole service
    for c in range(1, p["max_chunk"] + 1):
        st.svc.submit_memory_batch(_encode(ctx, st, list(range(c))))
        st.svc.run_to_completion()
    ctx.rec.counts.clear()
    st.svc_base = {k: getattr(st.svc, k) for k in
                   ("windows", "steps_run", "reused", "overflowed")}
    return st


def window(ctx, st):
    p, svc, rec = ctx.params, st.svc, ctx.rec
    seconds, due = ctx.seconds, st.due
    in_window = int(np.searchsorted(due, seconds))
    enc_flops = arith.encoder_flops_per_image(ctx.cfg)
    submitted = np.full(due.size, np.nan)
    done = np.full(due.size, np.nan)
    captions, flight, chunks, ticks = {}, {}, [], []
    nxt = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        ctx.sub.tick(now)
        if now >= seconds and not any(r < in_window for r in flight.values()) \
                and nxt >= in_window:
            break
        if now >= seconds + DRAIN_S:
            break
        k = nxt
        while k < due.size and due[k] <= now and k - nxt < p["max_chunk"]:
            k += 1
        if k > nxt:
            rows = list(range(nxt, k))
            mem = _encode(ctx, st, [st.image_of[r] for r in rows])
            ids = svc.submit_memory_batch(mem)
            submitted[nxt:k] = now
            flight.update(zip(ids, rows))
            chunks.append(k - nxt)
            rec.count("serve.encode_flops", (k - nxt) * enc_flops)
            nxt = k
        if flight:
            watch = rec.profiling
            before = _slots(svc) if watch else None
            with rec.span("serve.window"):
                svc.step()
            rec.count("serve.windows")
            t_read = time.perf_counter() - t0
            ticks.append(t_read)
            lengths = {}
            for rid, r in list(flight.items()):
                cap = svc.result(rid)
                if cap is not None:
                    lengths[rid] = len(cap)
                    done[r] = t_read
                    del flight[rid]
                    if r < in_window:
                        captions[r] = cap
                    n = len(cap) - 1
                    rec.count("serve.tokens", n)
                    rec.count("serve.decode_flops",
                              arith.decoder_flops_per_caption(ctx.cfg, n))
            if watch:
                rec.count("serve.decode_layer_bound_ms", _window_bound_ms(
                    ctx, live_keys(before, _slots(svc), lengths,
                                   svc.steps_per_sync)))
        elif nxt < due.size:
            wait = due[nxt] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.002))
    lat = (done[:in_window] - due[:in_window]) * 1e3
    failed = int(np.isnan(lat).sum())
    lat = np.where(np.isnan(lat), np.inf, lat)
    late = (submitted[:in_window] - due[:in_window]) * 1e3
    late = late[~np.isnan(late)]
    ctx.info.update(
        rate=p["rate"], due=in_window, completed=in_window - failed,
        generator_late_ms={"p50": core.percentile(late, 50),
                           "p99": core.percentile(late, 99),
                           "max": float(late.max()) if late.size else 0.0},
        chunk_sizes=arith.length_summary(chunks),
        caption_lengths=arith.length_summary(
            arith.caption_length(c, ctx.cfg["special_ids"]["end"])
            for c in captions.values()),
        windows_by_second=arith.per_second(t for t in ticks if t < seconds),
        backlog_at_close=int(np.sum(~np.isnan(submitted[:in_window])
                                    & (done[:in_window] > seconds))))
    st.captions = captions
    return {"attempted": in_window, "failed": failed,
            "metrics": {"latency_p95_ms": core.percentile(lat, 95),
                        "latency_p50_ms": core.percentile(lat, 50)}}


def counters(ctx, st) -> dict:
    out = {k: getattr(st.svc, k) - v for k, v in st.svc_base.items()}
    out.update(program.counters())
    return out


def release(ctx, st) -> None:
    st.svc = st.cap = None


def faults(ctx) -> tuple:
    return ()


def check(ctx, st, out, control: bool = False, fault: str = None) -> dict:
    rng = np.random.default_rng((ctx.seed * 7 + 3) & SEED_MASK)
    p = ctx.params
    return checks.served(ctx, st.weights, st.images, st.captions,
                        {r: st.image_of[r] for r in st.captions}, rng,
                        p["check_tokens"], p["check_captions"], control)
