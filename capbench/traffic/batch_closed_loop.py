"""A closed loop of offline captioning batches.

One caller captions a photo library in batches of ``batch`` uint8 host
images of ``image_hw``: each batch is uploaded from pageable host memory,
preprocessed on the card (``device_preprocess``), encoded
(``Captioner.memory_from_pixels``) and decoded
(``Captioner.generate_from_memory`` with ``method``, and ``beam_size``
for beam search) to token lists on the host; the next batch starts when
that one has returned. The host batches are ``batches`` distinct ones made
from the seed, visited in an order drawn from it. The window runs whole
batches until ``--seconds`` have passed; the rate is the captions of every
batch over the time they took.
"""

from __future__ import annotations

import time

import numpy as np

from capbench import arith, check as checks, program
from capbench.inputs import SEED_MASK, make_images, make_served_weights

PRODUCES = {"captions_per_s": "captions/s",
            "captions_per_s.beam": "captions/s"}
NEVER = -1          # an END id no token has: decoding runs to max_len


class State:
    pass


def _run(ctx, st, b, end_id=None):
    torch, rec, cap, p = ctx.torch, ctx.rec, st.cap, ctx.params
    with rec.span("batch.preprocess"):
        x = torch.from_numpy(st.batches[b]).to(ctx.device)
        px = program.preprocess(ctx.cfg, x)
    with rec.span("batch.encode"):
        mem = cap.memory_from_pixels(px)
    with rec.span("batch.decode"):
        return cap.generate_from_memory(
            mem, end_token_id=end_id, method=p["method"],
            beam_size=p.get("beam_size"),
            max_len=ctx.cfg["decoder"]["max_seq_len"])


def setup(ctx):
    p, cfg = ctx.params, ctx.cfg
    st = State()
    st.weights, ctx.info["end_margin"] = make_served_weights(ctx, cfg)
    n = p["batches"] * p["batch"]
    imgs = make_images(n, p["image_hw"], ctx.seed, ctx.device).cpu().numpy()
    st.batches = [imgs[i * p["batch"]:(i + 1) * p["batch"]]
                  for i in range(p["batches"])]
    st.cap = program.captioner(cfg, st.weights)
    # every cache bucket of the decode loop, then a batch as served
    _run(ctx, st, 0, end_id=NEVER)
    _run(ctx, st, 0)
    ctx.rec.counts.clear()
    rng = np.random.default_rng((ctx.seed * 7 + 4) & SEED_MASK)
    st.order = np.concatenate([rng.permutation(p["batches"])
                               for _ in range(1000)])
    return st


def window(ctx, st):
    p, rec, cfg = ctx.params, ctx.rec, ctx.cfg
    enc = arith.encoder_flops_per_image(cfg)
    beams = (p.get("beam_size") or 1) if p["method"] == "beam" else 1
    first = {}                   # (batch, row) → tokens, first visit
    lengths, n_caps, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        b = int(st.order[i])
        i += 1
        toks = _run(ctx, st, b)
        n_caps += len(toks)
        flops = len(toks) * enc
        for r, t in enumerate(toks):
            first.setdefault((b, r), t)
            lengths.append(len(t))
            flops += beams * arith.decoder_flops_per_caption(cfg, len(t) - 1)
        rec.count("batch.batches")
        rec.count("batch.flops", flops)
        elapsed = time.perf_counter() - t0
        ctx.sub.tick(elapsed)
        if elapsed >= ctx.seconds:
            break
    ctx.info.update(batches=i, captions=n_caps,
                    caption_lengths=arith.length_summary(lengths))
    st.captions = first
    name = "captions_per_s.beam" if p["method"] == "beam" else \
        "captions_per_s"
    return {"attempted": n_caps, "failed": 0,
            "metrics": {name: n_caps / elapsed}}


def counters(ctx, st) -> dict:
    return program.counters()


def release(ctx, st) -> None:
    st.cap = None


def faults(ctx) -> tuple:
    """The faults whose readings ``readings.py --faults`` takes: greedy
    decoding in place of a beam search."""
    return ("greedy",) if ctx.params["method"] == "beam" else ()


def check(ctx, st, out, control: bool = False, fault: str = None) -> dict:
    p = ctx.params
    rng = np.random.default_rng((ctx.seed * 7 + 5) & SEED_MASK)
    keys = sorted(st.captions)
    index = {k: i for i, k in enumerate(keys)}
    caps = {index[k]: st.captions[k] for k in keys}
    images = {index[(b, r)]: st.batches[b][r] for b, r in keys}
    k = p["beam_size"] if p["method"] == "beam" else 1
    return checks.served(ctx, st.weights, images, caps,
                         {i: i for i in caps}, rng, p["check_tokens"],
                         p["check_captions"], control, k, judged=fault)
