"""Decoder training from cached CLS features, fed as the training loop
feeds it.

Host batches hold ``batch`` rows of bfloat16 features (the feature
cache's type) and caption rows padded as the dataset pads them, shifted
for teacher forcing (``collate``); ``prefetch_to_device`` copies each to
the card one batch ahead of the step that ``make_train_step`` returned
(bf16 compute, AdamW with global-norm clipping, dropout with the hash-mask
attention kernels). ``batches`` distinct host batches are made from the
seed and visited in turn.

Set-up builds the one training state, drives it through the window's own
feed and call for its first ``check_steps`` steps (which also warm every
shape up), keeps what the check needs from them, and hands the same state
and feed to the window. The rate is the images of every step the window
ran over its time, the device's queue drained at the close. Once the
window has closed and the peak has been read, ``release`` drives the
window's final state ``check_steps`` steps further through the same call
and feed, keeps what the check needs from them, and frees the program.

The check holds both stretches against the plain reference: the first
from the initial weights, the second from the program's state after the
window (its parameters, moments and step count, which number the dropout
streams), on the host batches the feed is due to hand over; its numbers
carry the prefix ``end_``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from capbench import arith, check as checks, program
from capbench.inputs import SEED_MASK, make_captions, make_features, \
    make_weights
from capbench.reference import model as ref

PRODUCES = {"train_images_per_s": "images/s"}


class State:
    pass


def _optimizer(cfg):
    from mit_tpu_torch.train.steps import make_optimizer

    tr = cfg["train"]
    conf = SimpleNamespace(
        LEARNING_RATE=tr["learning_rate"], WEIGHT_DECAY=tr["weight_decay"],
        GRAD_CLIP_VALUE=tr["grad_clip"], ADAM_BETA1=tr["adam_beta1"],
        ADAM_BETA2=tr["adam_beta2"], ADAM_EPS=tr["adam_eps"],
        WARMUP_STEPS=tr["warmup_steps"], NUM_EPOCHS=1)
    return make_optimizer(conf)[0]


def host_batches(ctx):
    """The distinct host batches, as the loader and the feature cache
    hand them to the step."""
    from mit_tpu_torch.data.dataset import collate

    p, cfg = ctx.params, ctx.cfg
    n, b = p["batches"] * p["batch"], p["batch"]
    feats = make_features(n, cfg["encoder"]["hidden_size"], ctx.seed,
                          ctx.device).cpu()
    rows = make_captions(n, cfg, p["mean_words"], ctx.seed)
    pad = cfg["special_ids"]["pad"]
    out = []
    for i in range(p["batches"]):
        items = [{"image_path": f"{j}", "caption_tokens": rows[j]}
                 for j in range(i * b, (i + 1) * b)]
        c = collate(items, pad, b)
        out.append({"features": feats[i * b:(i + 1) * b],
                    "decoder_input_tokens": c["decoder_input_tokens"],
                    "target_tokens": c["target_tokens"]})
    return out


def _feed(ctx, st):
    from mit_tpu_torch.data.dataset import prefetch_to_device, to_device

    def cycle():
        while True:
            yield from st.host

    return prefetch_to_device(cycle(), lambda b: to_device(b, ctx.device))


def _drive(ctx, st) -> dict:
    """``check_steps`` steps of ``st.state`` through the window's own call
    and feed: their losses, the first step's gradient as the optimizer got
    it (from its first moment before and after), and the parameters
    after them; ``st.state`` moves on."""
    state, losses, first = st.state, [], None
    mu0 = {k: v.clone() for k, v in ref.leaves(state.opt_state.mu).items()}
    for i in range(ctx.params["check_steps"]):
        state, loss = st.step(state, {}, next(st.feed), ctx.seed)
        losses.append(loss)
        if i == 0:
            first = {k: (v - st.b1 * mu0[k]) / (1.0 - st.b1)
                     for k, v in ref.leaves(state.opt_state.mu).items()}
    ctx.sync()
    st.state = state
    return {"losses": [float(x) for x in losses], "first_grad": first,
            "params": ref.leaves(state.params)}


def setup(ctx):
    from mit_tpu_torch.models.model import split_trainable
    from mit_tpu_torch.train.steps import init_train_state, make_train_step

    p, cfg = ctx.params, ctx.cfg
    st = State()
    weights = make_weights(cfg, ctx.seed, ctx.device, shaped=False)
    st.trainable, _ = split_trainable(weights)
    del weights
    st.host = host_batches(ctx)
    opt = _optimizer(cfg)
    state = init_train_state(st.trainable, opt)
    st.step = make_train_step(program.model_config(cfg), opt,
                              cfg["special_ids"]["pad"],
                              program.compute_dtype(cfg), from_features=True,
                              fused_dropout=cfg["train"]["fused_dropout"])
    st.feed = _feed(ctx, st)
    st.b1 = cfg["train"]["adam_beta1"]
    st.state = state
    st.prog = _drive(ctx, st)
    st.prog["start"] = ref.leaves(st.trainable)
    ctx.rec.counts.clear()
    return st


def window(ctx, st):
    p, rec = ctx.params, ctx.rec
    flops = arith.train_flops_per_step(ctx.cfg, p["batch"],
                                       ctx.cfg["decoder"]["max_seq_len"] - 1)
    state, step, feed, n = st.state, st.step, st.feed, 0
    ticks = []
    t0 = time.perf_counter()
    while True:
        batch = next(feed)
        with rec.span("train.step"):
            state, loss = step(state, {}, batch, ctx.seed)
        n += 1
        rec.count("train.steps")
        rec.count("train.flops", flops)
        elapsed = time.perf_counter() - t0
        ticks.append(elapsed)
        ctx.sub.tick(elapsed)
        if elapsed >= ctx.seconds:
            break
    last = float(loss)                     # waits for the queued steps
    elapsed = time.perf_counter() - t0
    st.state = state
    st.window_steps = n
    ctx.info.update(steps=n, last_loss=last,
                    steps_by_second=arith.per_second(ticks))
    ok = np.isfinite(last)
    return {"attempted": n, "failed": 0 if ok else 1,
            "metrics": {"train_images_per_s": n * p["batch"] / elapsed}}


def counters(ctx, st) -> dict:
    return program.counters()


def release(ctx, st) -> None:
    state = st.state
    clone = lambda t: {k: v.clone() for k, v in ref.leaves(t).items()}
    st.resume = {"params": clone(state.params),
                 "mu": clone(state.opt_state.mu),
                 "nu": clone(state.opt_state.nu), "step": state.step}
    st.prog_end = _drive(ctx, st)
    st.prog_end["start"] = st.resume["params"]
    st.state = st.step = st.feed = None


def _batches(ctx, st, first: int) -> list:
    torch, p = ctx.torch, ctx.params
    return [{k: torch.as_tensor(v).to(ctx.device)
             for k, v in st.host[(first + i) % p["batches"]].items()}
            for i in range(p["check_steps"])]


def reference(ctx, st, precision: str = "f32", half_batch: bool = False,
              end: bool = False):
    """The reference's steps over the host batches the program's feed was
    due to hand over: from the initial weights, or with ``end`` from the
    program's state after the window."""
    if end:
        first = ctx.params["check_steps"] + st.window_steps
        return ref.train_steps(None, ctx.cfg, _batches(ctx, st, first),
                               ctx.seed, ref.Arith(precision), half_batch,
                               resume=st.resume)
    return ref.train_steps(st.trainable, ctx.cfg, _batches(ctx, st, 0),
                           ctx.seed, ref.Arith(precision), half_batch)


def faults(ctx) -> tuple:
    """The faults whose readings ``readings.py --faults`` takes: the mean
    over half of each batch, planted in the reference."""
    return ("half_batch",)


def check(ctx, st, out, control: bool = False, fault: str = None) -> dict:
    res = {}
    for end, prog in ((False, st.prog), (True, st.prog_end)):
        want = reference(ctx, st, end=end)
        if control or fault:
            got = reference(ctx, st, "fp8" if control else "f32",
                            half_batch=fault == "half_batch", end=end)
        else:
            got = prog
        pre = "end_" if end else ""
        ctx.info[pre + "check_losses"] = {"program": got["losses"],
                                          "reference": want["losses"]}
        res.update({pre + k: v for k, v in
                    checks.training(got, want).items()})
    return res
