"""A closed loop of offline captioning batches through a vision-language
model whose language side is a large sparse decoder (``language_model``
"kimi_vl" of the port).

One caller captions a photo library in batches of ``batch`` uint8 host
images of ``image_hw``: each batch is uploaded from pageable host memory,
preprocessed on the card (``device_preprocess``), encoded to image tokens
(``Captioner.memory_from_pixels``: the vision tower and the projector) and
decoded (``Captioner.generate_from_memory``: a prefill over ``[image
tokens; prompt]``, then greedy steps through the latent cache) to
``new_tokens`` ids a caption on the host; the next batch starts when that
one has returned. One instruction prompt of ``prompt_tokens`` ids drawn
from the seed follows every image; END never ends a row, so every caption
is ``new_tokens`` long, whatever the random weights prefer. The host
batches are ``batches`` distinct ones made from the seed, visited in an
order drawn from it. The window runs whole batches until ``--seconds``
have passed; the rate is the captions of every batch over their time.

Weights are made on the run's device from the seed, leaf by leaf in the
configuration's compute dtype, in the layout the program takes (frozen
here: :func:`lm_leaves`): matrices, biases and the router's correction
bias N(0, ``assumed.weight_std``), the token embedding N(0,
``assumed.embed_std``), norm scales 1, the projector's LayerNorm bias 0;
then attention's out-projection times ``assumed.attention_scale`` and the
last product of each FFN branch (:data:`BRANCH_OUT`) times
``assumed.branch_scale``; the vision tower as ``inputs.make_weights`` makes
it, in float32. Under ``--rehearse`` the language model's shape and those
four settings are the configuration's ``rehearsal_lm``.

The check teacher-forces ``check_captions`` captions drawn from the seed
through the plain reference (``capbench/reference/kimi_vl.py``) from
their images, and reads each generated token's gap below the best logit
at its position. ``faults``: routing without the correction bias, gate
weights without renormalization, each planted in the reference.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from capbench import arith_vlm, program
from capbench.inputs import SEED_MASK, _put, _spec, make_images
from capbench.reference import kimi_vl as ref
from capbench.reference.model import Arith

PRODUCES = {"captions_per_s": "captions/s"}
NEVER = -1          # an END id no token has: every caption runs its budget
PHASES = ("prefill", "decode")
# the program's counters of its expert layer, read after each batch
MOE_COUNTS = ("calls", "rows", "experts_hit")


class State:
    pass


def lm_keys(ctx) -> dict:
    """The language model's published keys, the rehearsal's shape under
    ``--rehearse``, with the projector's settings and the tower's width."""
    c = {k: v for k, v in ctx.cfg.items() if not isinstance(v, (dict, list))
         or k == "rope_scaling"}
    if ctx.rehearse:
        c.update(ctx.cfg["rehearsal_lm"])
    pj = ctx.cfg["projector"]
    c.update(merge=pj["merge_kernel_size"][0],
             projector_eps=pj["pre_norm_eps"],
             vision_width=ctx.cfg["encoder"]["hidden_size"])
    return c


def lm_leaves(c: dict) -> list:
    """[(path, shape)] of the language model and the projector, in the
    program's layout and a fixed order."""
    d, h, v = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    Lm = L - Ld
    e, fe, f = (c["n_routed_experts"], c["moe_intermediate_size"],
                c["intermediate_size"])
    fs = fe * c["n_shared_experts"]
    nope, rp, vd, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                       c["v_head_dim"], c["kv_lora_rank"])
    w, w4 = c["vision_width"], c["vision_width"] * c["merge"] ** 2
    return [
        ("lm/embed", (v, d)),
        ("lm/layers/attn_norm", (L, d)), ("lm/layers/mlp_norm", (L, d)),
        ("lm/layers/wq", (L, d, h * (nope + rp))),
        ("lm/layers/wkva", (L, d, r + rp)), ("lm/layers/kv_norm", (L, r)),
        ("lm/layers/wkvb", (L, r, h * (nope + vd))),
        ("lm/layers/wo", (L, h * vd, d)),
        ("lm/dense/w_gate", (Ld, d, f)), ("lm/dense/w_up", (Ld, d, f)),
        ("lm/dense/w_down", (Ld, f, d)),
        ("lm/moe/router", (Lm, d, e)), ("lm/moe/router_bias", (Lm, e)),
        ("lm/moe/w_gate", (Lm, e, d, fe)), ("lm/moe/w_up", (Lm, e, d, fe)),
        ("lm/moe/w_down", (Lm, e, fe, d)),
        ("lm/moe/shared_gate", (Lm, d, fs)), ("lm/moe/shared_up", (Lm, d, fs)),
        ("lm/moe/shared_down", (Lm, fs, d)),
        ("lm/norm", (d,)), ("lm/lm_head", (d, v)),
        ("projector/ln_scale", (w,)), ("projector/ln_bias", (w,)),
        ("projector/w1", (w4, w4)), ("projector/b1", (w4,)),
        ("projector/w2", (w4, d)), ("projector/b2", (d,)),
    ]


def make_weights(ctx, c: dict) -> dict:
    """The tower in float32 (``inputs``' spec and draw) and the language
    side in the compute dtype, from the seed, on the run's device."""
    cfg, dev = ctx.cfg, ctx.device
    fake = dict(cfg, decoder={"embed_dim": cfg["encoder"]["hidden_size"],
                              "ff_dim": 1, "num_layers": 0, "vocab_size": 1})
    enc = [s for s in _spec(fake) if s[0].startswith("encoder/")]
    gen = torch.Generator(device=dev)
    gen.manual_seed((ctx.seed * 2 + 1) & SEED_MASK)
    tree: dict = {}
    buf = torch.randn(sum(math.prod(s[1]) for s in enc), generator=gen,
                      device=dev)
    off = 0
    for path, shape, std, mean in enc:
        n = math.prod(shape)
        _put(tree, path, buf[off:off + n].view(shape).mul_(std).add_(mean))
        off += n
    dtype = program.compute_dtype(cfg)
    a = cfg["assumed"]
    std = c.get("weight_std", a["weight_std"])
    for path, shape in lm_leaves(c):
        if path.endswith(("_norm", "/norm", "ln_scale")):
            leaf = torch.ones(shape, device=dev, dtype=dtype)
        elif path.endswith("ln_bias"):
            leaf = torch.zeros(shape, device=dev, dtype=dtype)
        else:
            s = (c.get("embed_std", a.get("embed_std", std))
                 if path == "lm/embed" else std)
            if path == "lm/layers/wo":
                s *= c.get("attention_scale", a.get("attention_scale", 1.0))
            elif path in BRANCH_OUT:
                s *= c.get("branch_scale", a.get("branch_scale", 1.0))
            leaf = torch.randn(shape, generator=gen, device=dev,
                               dtype=dtype).mul_(s)
        _put(tree, path, leaf)
    return tree


# the last product of each FFN branch: the dense FFN's, every expert's and
# the shared experts' down projections (attention's is ``lm/layers/wo``)
BRANCH_OUT = ("lm/dense/w_down", "lm/moe/w_down", "lm/moe/shared_down")


def captioner(ctx, c: dict, weights: dict):
    """The program's captioner for the family (an older program without it
    fails here, before any weight is made)."""
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.kimi_vl import KimiVLConfig
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import VisionConfig

    lm = KimiVLConfig.from_hf(c, vision_width=c["vision_width"])._replace(
        merge=c["merge"], projector_eps=c["projector_eps"])
    e = ctx.cfg["encoder"]
    vision = VisionConfig(
        family=e["family"], image_size=e["image_size"],
        patch_size=e["patch_size"], hidden_size=e["hidden_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"],
        intermediate_size=e["intermediate_size"], hidden_act=e["hidden_act"],
        layer_norm_eps=e["layer_norm_eps"], patch_bias=e["patch_bias"],
        ln_pre=e["ln_pre"], ln_post=e["ln_post"])
    mcfg = ModelConfig(ctx.cfg["encoder_name"], vision, lm, "full",
                       "kimi_vl")
    if weights is None:
        return mcfg
    return Captioner(weights, mcfg, program.ids(ctx.cfg),
                     program.compute_dtype(ctx.cfg))


def _run(ctx, st, b):
    torch, rec, cap, p = ctx.torch, ctx.rec, st.cap, ctx.params
    with rec.span("vlm.encode"):
        with rec.span("vlm.preprocess"):
            x = torch.from_numpy(st.batches[b]).to(ctx.device)
            px = program.preprocess(ctx.cfg, x)
        mem = cap.memory_from_pixels(px)
    with rec.span("vlm.decode"):
        return cap.generate_from_memory(
            mem, prompt_ids=st.prompt, max_new_tokens=p["new_tokens"],
            end_token_id=NEVER)


def _moe_counts() -> dict:
    from mit_tpu_torch.ops import moe

    return {(k, ph): getattr(moe.moe_experts, k)[ph]
            for k in MOE_COUNTS for ph in PHASES}


def setup(ctx):
    p = ctx.params
    st = State()
    split, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        ctx.sync()
        split[name] = time.perf_counter() - t
        t = time.perf_counter()
    st.c = lm_keys(ctx)
    captioner(ctx, st.c, None)                  # fails at once without it
    lap("program_import")
    st.weights = make_weights(ctx, st.c)
    lap("weights")
    rng = np.random.default_rng((ctx.seed * 11 + 3) & SEED_MASK)
    st.prompt = torch.from_numpy(rng.integers(
        0, st.c["vocab_size"], p["prompt_tokens"])).long()
    n = p["batches"] * p["batch"]
    imgs = make_images(n, p["image_hw"], ctx.seed, ctx.device).cpu().numpy()
    st.batches = [imgs[i * p["batch"]:(i + 1) * p["batch"]]
                  for i in range(p["batches"])]
    lap("images")
    st.cap = captioner(ctx, st.c, st.weights)
    lap("captioner")
    _run(ctx, st, 0)        # builds the kernels and captures the step
    lap("first_batch")
    ctx.info["setup_split_s"] = split
    ctx.rec.counts.clear()
    rng = np.random.default_rng((ctx.seed * 7 + 4) & SEED_MASK)
    st.order = np.concatenate([rng.permutation(p["batches"])
                               for _ in range(1000)])
    return st


def window(ctx, st):
    p, rec, cfg, c = ctx.params, ctx.rec, ctx.cfg, st.c
    t0_tokens = (cfg["encoder"]["image_size"] // cfg["encoder"]["patch_size"]
                 ) ** 2 // c["merge"] ** 2 + p["prompt_tokens"]
    flops = arith_vlm.batch_flops(cfg, c, p["batch"], t0_tokens,
                                  p["new_tokens"])
    first, n_caps, i = {}, 0, 0
    before = _moe_counts()
    t0 = time.perf_counter()
    while True:
        b = int(st.order[i])
        i += 1
        toks = _run(ctx, st, b)
        n_caps += len(toks)
        for r, t in enumerate(toks):
            first.setdefault((b, r), t)
        after = _moe_counts()
        for (k, ph), v in after.items():
            rec.count(f"vlm.moe.{ph}.{k}", v - before[(k, ph)])
        before = after
        rec.count("vlm.batches")
        rec.count("vlm.flops", flops)
        elapsed = time.perf_counter() - t0
        ctx.sub.tick(elapsed)
        if elapsed >= ctx.seconds:
            break
    ctx.info.update(batches=i, captions=n_caps)
    st.captions = first
    return {"attempted": n_caps, "failed": 0,
            "metrics": {"captions_per_s": n_caps / elapsed}}


def counters(ctx, st) -> dict:
    from mit_tpu_torch.ops import moe

    out = program.counters()
    out.update({f"moe_experts.{k}": dict(getattr(moe.moe_experts, k))
                for k in MOE_COUNTS})
    out["moe_experts.launches"] = moe.moe_experts.launches
    out["moe_route.max_load"] = moe.moe_route.max_load
    steps = getattr(st.cap, "steps", None)
    if steps is not None:
        out["decode_steps"] = {k: getattr(steps, k) for k in (
            "graph_captures", "graph_replays", "eager_steps")}
    return out


def release(ctx, st) -> None:
    st.cap = None


def faults(ctx) -> tuple:
    """The routing faults ``readings.py --faults`` plants in the
    reference."""
    return ref.FAULTS


def check(ctx, st, out, control: bool = False, fault: str = None) -> dict:
    """Each checked token's gap below the f32 reference's best logit at its
    position: the program's tokens, or with ``control`` the fp8
    reference's choice on the same prefixes, or under ``fault`` the choice
    of the reference with that fault planted."""
    p, c = ctx.params, st.c
    inf = dict.fromkeys(("max_logit_gap", "p99_logit_gap",
                         "mean_logit_gap"), float("inf"))
    caps = st.captions
    if not caps or any(len(t) != p["new_tokens"] or not all(
            0 <= x < c["vocab_size"] for x in t) for t in caps.values()):
        return inf
    rng = np.random.default_rng((ctx.seed * 7 + 5) & SEED_MASK)
    keys = sorted(caps)
    pick = rng.choice(len(keys), min(p["check_captions"], len(keys)),
                      replace=False)
    keys = [keys[i] for i in sorted(pick)]
    images = torch.from_numpy(np.stack([st.batches[b][r] for b, r in keys])
                              ).to(ctx.device)
    tokens = torch.tensor([caps[k] for k in keys], device=ctx.device)
    prompt = st.prompt.to(ctx.device)
    with torch.no_grad():
        exact = ref.caption_logits(st.weights, ctx.cfg, c, images, prompt,
                                   tokens)
        if control or fault:
            judged = ref.caption_logits(
                st.weights, ctx.cfg, c, images, prompt, tokens,
                Arith("fp8") if control else Arith("f32"),
                fault).argmax(-1)
        else:
            judged = tokens
        gaps = (exact.max(-1).values
                - exact.gather(-1, judged[..., None])[..., 0]).flatten()
    gaps = gaps.cpu().numpy()
    ctx.info["check_sample"] = {"captions": len(keys),
                                "tokens": int(gaps.size)}
    return {"max_logit_gap": float(gaps.max()),
            "p99_logit_gap": float(np.quantile(gaps, 0.99)),
            "mean_logit_gap": float(gaps.mean())}
