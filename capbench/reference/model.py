"""Plain float32 reference of the captioning model and its training step.

Written from the published descriptions: the image resize with
antialiasing (a separable filter of triangle or Keys-cubic weights, as the
resize that the model's preprocessing names), a pre-LN ViT or CLIP vision
tower, the linear projection, and the 6-layer post-LN Transformer decoder
of the reference project (embedding × √D, sinusoidal positions, causal
self-attention with PAD keys masked, cross-attention over the memory, ReLU
FFN, vocabulary projection). Parameters are read from the benchmark's
tensors in the layout the program takes (``(in, out)`` matrices, layers
stacked on a leading axis); nothing else of the program is used.

Every matrix product goes through an :class:`Arith`: float32 (TF32 off,
set by the caller), or the control's fp8 (e4m3), which rounds both
operands of every product to 8 bits with a scale a row (a column of the
right operand) and accumulates in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from capbench.reference.dropout import hash_keep, step_generators

NEG = -1e9


class Arith:
    """Matrix products at one precision: "f32" or "fp8"."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.precision == "fp8":
            return _Fp8MatMul.apply(a, b)
        return torch.matmul(a, b)


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale along ``dim`` (its largest
    magnitude at e4m3's largest value, 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in fp8, and the backward's two products
    with theirs in fp8 too (the gradient scaled a row), all accumulated in
    float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(fp8(a, -1), fp8(b, -2))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.matmul(fp8(g, -1), fp8(b, -1).transpose(-1, -2))
        gb = torch.matmul(fp8(a, -2).transpose(-1, -2), fp8(g, -2))
        # broadcast batch dimensions are summed back to the operand's shape
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        return ga, gb


F32 = Arith("f32")


# ----------------------------------------------------------------------
# preprocessing: uint8 (B, H, W, 3) → normalized (B, 3, h, w)
# ----------------------------------------------------------------------
def _filter(name: str):
    if name == "bilinear":
        return lambda x: max(0.0, 1.0 - abs(x)), 2
    if name == "bicubic":
        a = -0.5

        def cubic(x):
            x = abs(x)
            if x < 1.0:
                return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
            if x < 2.0:
                return (((x - 5.0) * x + 8.0) * x - 4.0) * a
            return 0.0
        return cubic, 4
    raise ValueError(f"unknown resample {name!r}")


def resize_matrix(n_in: int, n_out: int, resample: str) -> np.ndarray:
    """(n_out, n_in) weights of a 1-D resize with antialiasing: each output
    sample at centre ``scale · (i + 0.5)`` weighs the inputs within the
    filter's support stretched by ``scale`` (when shrinking), and the
    weights are normalized to sum to 1."""
    fn, size = _filter(resample)
    scale = n_in / n_out
    support = size * 0.5 * scale if scale >= 1.0 else size * 0.5
    inv = 1.0 / scale if scale >= 1.0 else 1.0
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        centre = scale * (i + 0.5)
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        ws = [fn((j - centre + 0.5) * inv) for j in range(lo, hi)]
        total = sum(ws)
        w[i, lo:hi] = [x / total for x in ws] if total != 0 else ws
    return w


def preprocess(images_u8: torch.Tensor, pre: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 3, size, size) f32: resized, /255, and
    normalized by the family's mean and std (``pre`` from the config)."""
    b, h, w, _ = images_u8.shape
    size = pre["size"]
    dev = images_u8.device
    rh = torch.tensor(resize_matrix(h, size, pre["resample"]),
                      dtype=torch.float32, device=dev)
    rw = torch.tensor(resize_matrix(w, size, pre["resample"]),
                      dtype=torch.float32, device=dev)
    x = images_u8.permute(0, 3, 1, 2).float()                 # (B, 3, H, W)
    x = torch.matmul(torch.matmul(rh, x), rw.T)
    mean = torch.tensor(pre["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(pre["std"], dtype=torch.float32, device=dev)
    return (x / 255.0 - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)


# ----------------------------------------------------------------------
# the vision tower
# ----------------------------------------------------------------------
def layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention(q, k, v, heads, ar: Arith, add_mask=None, drop=None):
    """Softmax attention of (B, T, D) queries over (B, S, D) keys and
    values, ``heads`` heads; ``add_mask`` broadcasts to (B, H, T, S);
    ``drop`` (training) drops probabilities out."""
    hd = q.shape[-1] // heads
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    scores = ar.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if add_mask is not None:
        scores = scores + add_mask
    p = torch.softmax(scores, dim=-1)
    if drop is not None:
        p = drop.attention(p)
    return _merge(ar.mm(p, vh))


def encode(enc: dict, e: dict, pixels: torch.Tensor, ar: Arith = F32
           ) -> torch.Tensor:
    """(B, 3, H, W) normalized pixels → the CLS row of the last hidden
    state, (B, 1, D): patch embedding (a convolution of stride = kernel,
    flattened (C, kh, kw)), class token, positions, pre-LN blocks."""
    b = pixels.shape[0]
    p, d = e["patch_size"], e["hidden_size"]
    gh, gw = pixels.shape[2] // p, pixels.shape[3] // p
    x = pixels.reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = ar.mm(x.reshape(b, gh * gw, 3 * p * p), enc["patch_w"])
    if e["patch_bias"]:
        x = x + enc["patch_b"]
    x = torch.cat([enc["cls"].float().expand(b, 1, d), x], dim=1)
    x = x + enc["pos"].float()[None]
    eps = e["layer_norm_eps"]
    if e["ln_pre"]:
        x = layer_norm(x, enc["ln_pre"]["scale"], enc["ln_pre"]["bias"], eps)
    lay = enc["layers"]
    a = lay["attn"]
    if e["hidden_act"] == "quick_gelu":
        act = lambda y: y * torch.sigmoid(1.702 * y)
    else:
        act = lambda y: torch.nn.functional.gelu(y)         # exact erf
    for i in range(e["num_hidden_layers"]):
        h = layer_norm(x, lay["ln1"]["scale"][i], lay["ln1"]["bias"][i], eps)
        q = ar.mm(h, a["wq"][i]) + a["bq"][i]
        k = ar.mm(h, a["wk"][i]) + a["bk"][i]
        v = ar.mm(h, a["wv"][i]) + a["bv"][i]
        ctx = attention(q, k, v, e["num_attention_heads"], ar)
        x = x + ar.mm(ctx, a["wo"][i]) + a["bo"][i]
        h = layer_norm(x, lay["ln2"]["scale"][i], lay["ln2"]["bias"][i], eps)
        h = act(ar.mm(h, lay["fc1"][i]) + lay["b1"][i])
        x = x + ar.mm(h, lay["fc2"][i]) + lay["b2"][i]
    x = x[:, :1]
    if e["ln_post"]:
        x = layer_norm(x, enc["ln_post"]["scale"], enc["ln_post"]["bias"], eps)
    return x


def project(params: dict, features: torch.Tensor, ar: Arith = F32):
    """Encoder features (B, S, H_enc) → decoder memory (B, S, D)."""
    if "projection" not in params:
        return features.float()
    pr = params["projection"]
    return ar.mm(features, pr["w"]) + pr["b"]


# ----------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------
def sinusoids(n: int, d: int, device) -> torch.Tensor:
    """(n, d) positions: sin on even columns, cos on odd ones, at
    wavelengths 10000^(2i/d), computed in float64."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    freq = np.exp(np.arange(0, d, 2, dtype=np.float64)
                  * (-math.log(10000.0) / d))
    table = np.zeros((n, d), np.float64)
    table[:, 0::2] = np.sin(pos * freq)
    table[:, 1::2] = np.cos(pos * freq)
    return torch.tensor(table, dtype=torch.float32, device=device)


class Dropout:
    """The training step's dropout, drawn as the program draws it: the
    Bernoulli masks from the step's device generator in the forward's
    order, the attention's hash mask from a seed of the host generator."""

    def __init__(self, rate: float, seed: int, step: int, device):
        self.rate = rate
        self.dev, self.host = step_generators(seed, step, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.dev,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.host))

    def head_context(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.dev,
                          device=device) < 1.0 - self.rate


class _AttnDrop:
    """The hash mask of one self-attention call."""

    def __init__(self, rate, seed):
        self.rate, self.seed = rate, seed

    def attention(self, p):
        b, h, t, s = p.shape
        keep = hash_keep(b, h, t, s, self.rate, self.seed, p.device)
        return torch.where(keep, p / (1.0 - self.rate), 0.0)


def decoder_logits(dec: dict, dc: dict, tokens: torch.Tensor,
                   memory: torch.Tensor, pad_id: int, ar: Arith = F32,
                   drop: Optional[Dropout] = None) -> torch.Tensor:
    """Teacher-forced logits (B, T, V) of ``tokens`` (B, T) over CLS memory
    (B, 1, D). With ``drop`` (training) dropout falls on the embedding, the
    three residual branches, the FFN hidden and the attention
    probabilities."""
    b, t = tokens.shape
    d, heads = dc["embed_dim"], dc["num_heads"]
    hd = d // heads
    dr = drop if drop is not None else (lambda y: y)
    x = dec["token_embedding"].float()[tokens] * math.sqrt(d)
    x = dr(x + sinusoids(dc["max_seq_len"], d, tokens.device)[:t][None])
    causal = torch.triu(torch.full((t, t), NEG, device=tokens.device), 1)
    pad = torch.where(tokens == pad_id, NEG, 0.0)[:, None, None, :]
    mask = causal[None, None] + pad
    lay = dec["layers"]
    s, c, f = lay["self"], lay["cross"], lay["ffn"]
    mem = memory.float()
    ln = lambda y, name, i: layer_norm(y, lay[name]["scale"][i],
                                       lay[name]["bias"][i], 1e-5)
    for i in range(dc["num_layers"]):
        q = ar.mm(x, s["wq"][i]) + s["bq"][i]
        k = ar.mm(x, s["wk"][i]) + s["bk"][i]
        v = ar.mm(x, s["wv"][i]) + s["bv"][i]
        adrop = (_AttnDrop(drop.rate, drop.attention_seed())
                 if drop is not None else None)
        sa = ar.mm(attention(q, k, v, heads, ar, mask, adrop), s["wo"][i]) \
            + s["bo"][i]
        x = ln(x + dr(sa), "ln1", i)
        # one memory row: its softmax is 1, every query's context is its value
        vm = ar.mm(mem, c["wv"][i]) + c["bv"][i]                # (B, 1, D)
        if drop is not None:
            ctx = vm.reshape(b, 1, heads, hd).transpose(1, 2).expand(
                b, heads, t, hd)
            keep = drop.head_context((b, heads, t, 1), x.device)
            ctx = _merge(torch.where(keep, ctx / (1.0 - drop.rate), 0.0))
            ca = ar.mm(ctx, c["wo"][i]) + c["bo"][i]
        else:
            ca = (ar.mm(vm, c["wo"][i]) + c["bo"][i]).expand(b, t, d)
        x = ln(x + dr(ca), "ln2", i)
        h = torch.relu(ar.mm(x, f["w1"][i]) + f["b1"][i])
        ff = ar.mm(dr(h), f["w2"][i]) + f["b2"][i]
        x = ln(x + dr(ff), "ln3", i)
    return ar.mm(x, dec["fc_out_w"]) + dec["fc_out_b"]


def served_logits(params: dict, cfg: dict, images_u8: torch.Tensor,
                  captions, ar: Arith = F32) -> list:
    """Each caption's teacher-forced logits (n, V) from its image: the
    whole pipeline from uint8 pixels. ``captions[i]`` are the served
    tokens, START first; row j of the result predicts token j + 1."""
    pixels = preprocess(images_u8, cfg["preprocess"])
    memory = project(params, encode(params["encoder"], cfg["encoder"],
                                    pixels, ar), ar)
    out = []
    pad = cfg["special_ids"]["pad"]
    for i, cap in enumerate(captions):
        toks = torch.tensor([cap[:-1]], dtype=torch.int64,
                            device=images_u8.device)
        out.append(decoder_logits(params["decoder"], cfg["decoder"], toks,
                                  memory[i:i + 1], pad, ar)[0])
    return out


def greedy(params: dict, cfg: dict, images_u8: torch.Tensor, max_len: int,
           ar: Arith = F32) -> list:
    """Greedy captions of the reference: the whole prefix re-run at every
    step (no cache), stopping at END or at ``max_len`` tokens."""
    ids = cfg["special_ids"]
    pixels = preprocess(images_u8, cfg["preprocess"])
    memory = project(params, encode(params["encoder"], cfg["encoder"],
                                    pixels, ar), ar)
    out = []
    for i in range(memory.shape[0]):
        seq = [ids["start"]]
        while len(seq) < max_len and seq[-1] != ids["end"]:
            toks = torch.tensor([seq], dtype=torch.int64, device=memory.device)
            logits = decoder_logits(params["decoder"], cfg["decoder"], toks,
                                    memory[i:i + 1], ids["pad"], ar)
            seq.append(int(logits[0, -1].argmax()))
        out.append(seq)
    return out


def beam_search(dec: dict, dc: dict, memory: torch.Tensor, ids: dict,
                k: int, max_len: int, ar: Arith = F32):
    """The reference's log-probability beam search of ``k`` beams over
    memory (B, 1, D), the whole prefix re-run at every step (no cache):
    only beam 0 is alive at the first step, a finished beam extends only
    by PAD at no cost, the search stops once every beam has finished or
    the captions reach ``max_len`` tokens, and each image keeps its beam
    of highest total log-probability, finished or not (no length
    penalty). ``k`` = 1 is greedy decoding. → (captions, START first and
    up to their END or the length cap, as token lists; their totals
    (B,))."""
    b, v, dev = memory.shape[0], dc["vocab_size"], memory.device
    pad = ids["pad"]
    mem = memory.repeat_interleave(k, dim=0)
    toks = torch.full((b * k, max_len), pad, dtype=torch.int64, device=dev)
    toks[:, 0] = ids["start"]
    scores = torch.full((b, k), -1e30, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    pad_only = torch.full((v,), -1e30, device=dev)
    pad_only[pad] = 0.0
    first = (torch.arange(b, device=dev) * k)[:, None]
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        lg = decoder_logits(dec, dc, toks[:, :pos + 1], mem, pad, ar)[:, -1]
        logp = torch.log_softmax(lg, dim=-1).reshape(b, k, v)
        logp = torch.where(finished[..., None], pad_only, logp)
        total = (scores[..., None] + logp).reshape(b, k * v)
        scores, idx = torch.sort(total, dim=-1, descending=True, stable=True)
        scores, idx = scores[:, :k], idx[:, :k]
        src, new = idx // v, idx % v
        toks = toks[(first + src).reshape(-1)]
        toks[:, pos + 1] = new.reshape(-1)
        finished = finished.gather(1, src) | (new == ids["end"])
        pos += 1
    best = scores.argmax(dim=1)
    rows = toks.reshape(b, k, max_len)[torch.arange(b, device=dev), best]
    caps = []
    for r in rows.tolist():
        ends = [j for j in range(1, max_len) if r[j] == ids["end"]]
        caps.append(r[:ends[0] + 1] if ends else r)
    return caps, scores.gather(1, best[:, None])[:, 0]


def caption_logprob(dec: dict, dc: dict, captions, memory: torch.Tensor,
                    pad_id: int, ar: Arith = F32) -> torch.Tensor:
    """(B,) total log-probability of each caption (START first) given its
    memory row (B, 1, D), teacher-forced in one pass: the sum over its
    tokens after START of log-softmax at the position before."""
    n = max(len(c) for c in captions)
    dev = memory.device
    toks = torch.full((len(captions), n), pad_id, dtype=torch.int64,
                      device=dev)
    real = torch.zeros((len(captions), n - 1), dtype=torch.bool, device=dev)
    for i, c in enumerate(captions):
        toks[i, :len(c)] = torch.tensor(c, dtype=torch.int64, device=dev)
        real[i, :len(c) - 1] = True
    logp = torch.log_softmax(decoder_logits(dec, dc, toks[:, :-1], memory,
                                            pad_id, ar), dim=-1)
    picked = logp.gather(-1, toks[:, 1:, None])[..., 0]
    return torch.where(real, picked, 0.0).sum(-1)


def memory_of(params: dict, cfg: dict, images_u8: torch.Tensor,
              ar: Arith = F32) -> torch.Tensor:
    """uint8 images → decoder memory (B, 1, D)."""
    pixels = preprocess(images_u8, cfg["preprocess"])
    return project(params, encode(params["encoder"], cfg["encoder"], pixels,
                                  ar), ar)


# ----------------------------------------------------------------------
# the training step
# ----------------------------------------------------------------------
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def train_steps(trainable: dict, cfg: dict, batches, seed: int,
                ar: Arith = F32, half_batch: bool = False,
                resume: Optional[dict] = None) -> dict:
    """The decoder's first ``len(batches)`` training steps from cached
    features: PAD-masked mean cross entropy, gradients, the PAD embedding
    row's gradient zeroed, clip by global norm (only at or above the
    limit), AdamW (bias corrections at the count after the update, decay
    on every leaf). ``batches`` hold ``features`` (B, 1, H_enc),
    ``decoder_input_tokens`` and ``target_tokens`` (B, T) on the device.

    ``half_batch``: a fault for the check's own test, the step's mean taken
    over the first half of the batch alone.

    ``resume``: go on from a training state instead of from ``trainable``
    at step 0: {"params", "mu", "nu"} (leaf → tensor) and "step", the
    updates applied so far, which numbers the steps' dropout streams and
    bias corrections.

    → {"losses": [...], "first_grad": {leaf: tensor}, "params": {leaf:
    tensor after the steps}, "start": {leaf: tensor before}}.
    """
    tr = cfg["train"]
    dc = cfg["decoder"]
    pad = cfg["special_ids"]["pad"]
    src = resume["params"] if resume else _leaves(trainable)
    params = {k: v.detach().float().clone() for k, v in src.items()}
    start = {k: v.clone() for k, v in params.items()}
    if resume:
        mu = {k: resume["mu"][k].float().clone() for k in params}
        nu = {k: resume["nu"][k].float().clone() for k in params}
    else:
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    b1, b2 = tr["adam_beta1"], tr["adam_beta2"]
    done = resume["step"] if resume else 0
    for step, batch in enumerate(batches, start=done):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        tree = _tree(leaves)
        feats, inp, tgt = (batch["features"], batch["decoder_input_tokens"],
                           batch["target_tokens"])
        if half_batch:
            n = feats.shape[0] // 2
            feats, inp, tgt = feats[:n], inp[:n], tgt[:n]
        drop = Dropout(dc["dropout"], seed, step, feats.device)
        memory = project(tree, feats.float(), ar)
        logits = decoder_logits(tree["decoder"], dc, inp.long(), memory, pad,
                                ar, drop)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
        real = (tgt != pad).float()
        loss = (nll * real).sum() / real.sum().clamp_min(1.0)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True,
            materialize_grads=True)))
        grads["decoder/token_embedding"][pad] = 0.0
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if tr["grad_clip"] and float(norm) >= tr["grad_clip"]:
            grads = {k: g / norm * tr["grad_clip"] for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        count = step + 1
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + tr["adam_eps"])
                u = u + tr["weight_decay"] * params[k]
                params[k] = params[k] - tr["learning_rate"] * u
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first, "params": params,
            "start": start}


def _tree(leaves: dict) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def leaves(tree: dict) -> dict:
    """{"a/b/c": tensor} of a nested dict of tensors."""
    return _leaves(tree)
