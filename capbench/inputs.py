"""What a run makes from its seed: the weights, the host images, the
cached features and the caption tokens.

Weights are drawn on the run's device with one ``torch.Generator`` in two
large calls (one normal buffer for every leaf, cut into views and scaled
leaf by leaf), in float32, the type the program keeps its weights in, and
in the layout the program's parameters take: ``(in, out)`` matrices and
layers stacked on a leading axis. Encoder matrices are N(0, 0.02) (the
published towers' initializer), decoder and projection matrices Xavier
normal, biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02). The last
projection of each of the decoder's residual branches (self-attention out,
cross-attention out, FFN out) and its bias are then scaled by the
configuration's ``branch_scale``, as DeepNet's initialization of post-LN
Transformers scales them (arXiv:2203.00555): without it the random
decoder settles on one token and one END gap for good, and captions end
at once or never. END's output column then gains ``end_position_weight``
times a direction that reads the slowly rising sine columns of the
positional table (:func:`position_direction`), and the token embedding
leaves those columns to the positions alone (zero), so that END's logit
rises with the caption's length, as a trained captioner's does, alike for
every seed. For decoding,
END's logit bias is raised by a margin calibrated for the seed's weights
with the plain reference (:func:`end_margin`), so that captions end at
the configuration's mean length.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def _spec(cfg: dict):
    """[(path, shape, std, mean)] of every leaf, in a fixed order."""
    e, dc = cfg["encoder"], cfg["decoder"]
    d, f, L = e["hidden_size"], e["intermediate_size"], e["num_hidden_layers"]
    t = (e["image_size"] // e["patch_size"]) ** 2 + 1
    pdim = 3 * e["patch_size"] ** 2
    W, B = 0.02, 0.02
    xav = lambda i, o: math.sqrt(2.0 / (i + o))
    out = [("encoder/patch_w", (pdim, d), W, 0.0),
           ("encoder/cls", (d,), W, 0.0), ("encoder/pos", (t, d), W, 0.0)]
    if e["patch_bias"]:
        out.append(("encoder/patch_b", (d,), B, 0.0))
    for k in ("wq", "wk", "wv", "wo"):
        out.append((f"encoder/layers/attn/{k}", (L, d, d), W, 0.0))
    for k in ("bq", "bk", "bv", "bo"):
        out.append((f"encoder/layers/attn/{k}", (L, d), B, 0.0))
    for ln in ("ln1", "ln2"):
        out.append((f"encoder/layers/{ln}/scale", (L, d), B, 1.0))
        out.append((f"encoder/layers/{ln}/bias", (L, d), B, 0.0))
    out += [("encoder/layers/fc1", (L, d, f), W, 0.0),
            ("encoder/layers/b1", (L, f), B, 0.0),
            ("encoder/layers/fc2", (L, f, d), W, 0.0),
            ("encoder/layers/b2", (L, d), B, 0.0)]
    for ln in ("ln_pre", "ln_post"):
        if e[ln]:
            out.append((f"encoder/{ln}/scale", (d,), B, 1.0))
            out.append((f"encoder/{ln}/bias", (d,), B, 0.0))
    D, F, Ld, V = (dc["embed_dim"], dc["ff_dim"], dc["num_layers"],
                   dc["vocab_size"])
    if d != D:
        out += [("projection/w", (d, D), xav(d, D), 0.0),
                ("projection/b", (D,), B, 0.0)]
    out.append(("decoder/token_embedding", (V, D), xav(V, D), 0.0))
    for blk in ("self", "cross"):
        for k in ("wq", "wk", "wv", "wo"):
            out.append((f"decoder/layers/{blk}/{k}", (Ld, D, D), xav(D, D), 0.0))
        for k in ("bq", "bk", "bv", "bo"):
            out.append((f"decoder/layers/{blk}/{k}", (Ld, D), B, 0.0))
    out += [("decoder/layers/ffn/w1", (Ld, D, F), xav(D, F), 0.0),
            ("decoder/layers/ffn/b1", (Ld, F), B, 0.0),
            ("decoder/layers/ffn/w2", (Ld, F, D), xav(F, D), 0.0),
            ("decoder/layers/ffn/b2", (Ld, D), B, 0.0)]
    for ln in ("ln1", "ln2", "ln3"):
        out.append((f"decoder/layers/{ln}/scale", (Ld, D), B, 1.0))
        out.append((f"decoder/layers/{ln}/bias", (Ld, D), B, 0.0))
    out += [("decoder/fc_out_w", (D, V), xav(D, V), 0.0),
            ("decoder/fc_out_b", (V,), B, 0.0)]
    return out


def _put(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def make_weights(cfg: dict, seed: int, device, shaped: bool = True) -> dict:
    """The model's float32 weights on ``device``, drawn from ``seed``;
    ``shaped=False`` leaves out the branch scale and the END readout,
    which serve decoding only (training starts from the initializer)."""
    spec = _spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2 + 1) & SEED_MASK)
    buf = torch.randn(total, generator=gen, device=device)
    tree: dict = {}
    off = 0
    for path, shape, std, mean in spec:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape)
        leaf.mul_(std).add_(mean)
        _put(tree, path, leaf)
        off += n
    if not shaped:
        return tree
    scale = cfg["assumed"].get("branch_scale", 1.0)
    if scale != 1.0:
        lay = tree["decoder"]["layers"]
        for blk, w, b in (("self", "wo", "bo"), ("cross", "wo", "bo"),
                          ("ffn", "w2", "b2")):
            lay[blk][w].mul_(scale)
            lay[blk][b].mul_(scale)
    beta = cfg["assumed"].get("end_position_weight", 0.0)
    if beta:
        u = position_direction(cfg, device)
        tree["decoder"]["fc_out_w"][:, cfg["special_ids"]["end"]] += beta * u
        tree["decoder"]["token_embedding"][:, u > 0] = 0.0
    return tree


def position_direction(cfg: dict, device) -> torch.Tensor:
    """The unit vector over the sine columns of the decoder's positional
    table whose frequencies lie in ``assumed.end_position_band``: over the
    first hundred positions those columns rise with the position."""
    d = cfg["decoder"]["embed_dim"]
    lo, hi = cfg["assumed"]["end_position_band"]
    freq = 10000.0 ** (-np.arange(0, d, 2) / d)
    cols = 2 * np.nonzero((freq >= lo) & (freq <= hi))[0]
    u = torch.zeros(d, device=device)
    u[torch.as_tensor(cols, device=device)] = 1.0
    return u / u.norm()


def end_gaps(cfg: dict, weights: dict, images_u8: torch.Tensor
             ) -> torch.Tensor:
    """(n, max_len − 1): by how much END's logit trails the best other
    token's at each step of the float32 reference's greedy captions of
    ``images_u8`` with END held out (uncached)."""
    from capbench.reference import model as ref

    ids, dc = cfg["special_ids"], cfg["decoder"]
    with torch.no_grad():
        mem = ref.memory_of(weights, cfg, images_u8)
        toks = torch.full((mem.shape[0], 1), ids["start"], dtype=torch.int64,
                          device=mem.device)
        gaps = []
        for _ in range(dc["max_seq_len"] - 1):
            lg = ref.decoder_logits(weights["decoder"], dc, toks, mem,
                                    ids["pad"])[:, -1]
            end = lg[:, ids["end"]].clone()
            lg[:, ids["end"]] = -float("inf")
            best, nxt = lg.max(-1)
            gaps.append(best - end)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(gaps, dim=1)


def lengths_at(gaps: torch.Tensor, margin: float) -> torch.Tensor:
    """Caption lengths, START and END included, with END's bias raised by
    ``margin``: END wins at the first step whose gap is under it."""
    hit = gaps < margin
    steps = gaps.shape[1]
    first = torch.where(hit.any(1), hit.int().argmax(1), steps)
    return torch.where(first < steps, first + 2, steps + 1).float()


def end_margin(cfg: dict, weights: dict, seed: int, device) -> float:
    """The margin by which END's logit bias is raised: the one at which
    the reference's greedy captions of ``assumed.calibration_images``
    images made from the seed have ``assumed.mean_caption_tokens`` tokens
    on average (bisection)."""
    a = cfg["assumed"]
    imgs = make_images(a["calibration_images"], a["image_hw"],
                       seed * 3 + 7, device)
    gaps = end_gaps(cfg, weights, imgs)
    lo, hi = float(gaps.min()) - 1.0, float(gaps.max()) + 1.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if float(lengths_at(gaps, mid).mean()) > a["mean_caption_tokens"]:
            lo = mid
        else:
            hi = mid
    return hi


def make_served_weights(ctx, cfg: dict):
    """Weights for decoding: :func:`make_weights` with END's logit bias
    raised by the seed's calibrated :func:`end_margin`. The calibration is
    the plain reference's work, not the program's: its seconds go to
    ``ctx.reference_s``, which ``setup_s`` leaves out, and the device's
    peak memory is counted afresh after it. → (weights, margin)."""
    w = make_weights(cfg, ctx.seed, ctx.device)
    ctx.sync()
    t0 = time.perf_counter()
    margin = end_margin(cfg, w, ctx.seed, ctx.device)
    ctx.sync()
    ctx.reference_s += time.perf_counter() - t0
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    w["decoder"]["fc_out_b"][cfg["special_ids"]["end"]] += margin
    return w, margin


def make_images(n: int, hw, seed: int, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 images on ``device``: smooth colour fields (a
    random 12 × 16 grid blown up) with fine noise on top, so that the
    resize averages real structure and no two images are alike."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2 + 2) & SEED_MASK)
    h, w = hw
    coarse = torch.rand((n, 3, 12, 16), generator=gen, device=device)
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=False) * 200.0 + 28.0
    x = x + torch.randn((n, 3, h, w), generator=gen, device=device) * 20.0
    return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def make_features(n: int, width: int, seed: int, device) -> torch.Tensor:
    """(n, 1, width) bfloat16 CLS features, N(0, 1) as the tower's final
    LayerNorm leaves them, in the type the feature cache stores."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2 + 3) & SEED_MASK)
    return torch.randn((n, 1, width), generator=gen, device=device) \
        .to(torch.bfloat16)


def make_captions(n: int, cfg: dict, mean_words: float, seed: int
                  ) -> np.ndarray:
    """(n, max_seq_len) int32 caption rows as the dataset pads them: START,
    words drawn from the vocabulary past the special ids, END, then PAD.
    Lengths are a fixed spread of whole numbers around ``mean_words``
    (from 0.5 to 1.5 times the mean), in an order drawn from ``seed``."""
    ids, dc = cfg["special_ids"], cfg["decoder"]
    rng = np.random.default_rng(seed & SEED_MASK)
    lo, hi = max(1, round(0.5 * mean_words)), round(1.5 * mean_words)
    words = np.resize(np.arange(lo, hi + 1), n)
    rng.shuffle(words)
    first = max(ids.values()) + 1
    rows = np.full((n, dc["max_seq_len"]), ids["pad"], np.int32)
    for i, k in enumerate(words):
        k = min(int(k), dc["max_seq_len"] - 2)
        rows[i, 0] = ids["start"]
        rows[i, 1:k + 1] = rng.integers(first, dc["vocab_size"], k)
        rows[i, k + 1] = ids["end"]
    return rows
