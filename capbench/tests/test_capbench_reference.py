"""The plain reference against straightforward recomputations written here
with PyTorch's own modules, on seeded toy weights: the resize, the vision
tower, the decoder's logits, greedy captions (uncached) and the training
step. Nothing here imports the program under test."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from capbench.inputs import make_captions, make_images, make_weights  # noqa
from capbench.reference import model as ref  # noqa: E402
from capbench.reference.dropout import hash_keep  # noqa: E402

ENC = {"family": "vit", "image_size": 32, "patch_size": 8, "hidden_size": 16,
       "num_hidden_layers": 2, "num_attention_heads": 2,
       "intermediate_size": 24, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
       "patch_bias": True, "ln_pre": False, "ln_post": True}
CLIP = dict(ENC, family="clip", hidden_act="quick_gelu", layer_norm_eps=1e-5,
            patch_bias=False, ln_pre=True, ln_post=False)
DEC = {"vocab_size": 40, "embed_dim": 8, "num_heads": 2, "num_layers": 2,
       "ff_dim": 12, "max_seq_len": 12, "dropout": 0.0}
IDS = {"pad": 0, "start": 2, "end": 3, "unk": 1}
TRAIN = {"learning_rate": 1e-2, "weight_decay": 1e-3, "grad_clip": 0.5,
         "adam_beta1": 0.9, "adam_beta2": 0.98, "adam_eps": 1e-9}


def cfg_for(enc):
    return {"encoder": enc, "decoder": DEC, "special_ids": IDS,
            "preprocess": {"size": 32, "resample": "bilinear",
                           "mean": [0.5] * 3, "std": [0.5] * 3},
            "assumed": {"branch_scale": 0.25}, "train": TRAIN}


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_resize_matches_torch_antialiased_interpolate(mode):
    imgs = make_images(3, (40, 56), 7, "cpu")
    pre = {"size": 32, "resample": mode, "mean": [0.4, 0.5, 0.6],
           "std": [0.2, 0.3, 0.25]}
    x = imgs.permute(0, 3, 1, 2).float()
    want = F.interpolate(x, size=(32, 32), mode=mode, antialias=True,
                         align_corners=False)
    mean = torch.tensor(pre["mean"]).view(1, 3, 1, 1)
    std = torch.tensor(pre["std"]).view(1, 3, 1, 1)
    want = (want / 255.0 - mean) / std
    assert torch.allclose(ref.preprocess(imgs, pre), want, atol=2e-4)


def nn_tower(enc, e):
    """The tower as PyTorch modules: a strided convolution and pre-LN
    encoder layers."""
    d, p = e["hidden_size"], e["patch_size"]
    conv = nn.Conv2d(3, d, p, stride=p, bias=e["patch_bias"])
    conv.weight.data = enc["patch_w"].T.reshape(d, 3, p, p).clone()
    if e["patch_bias"]:
        conv.bias.data = enc["patch_b"].clone()
    act = (lambda y: y * torch.sigmoid(1.702 * y)) \
        if e["hidden_act"] == "quick_gelu" else F.gelu
    layers = []
    lay, a = enc["layers"], enc["layers"]["attn"]
    for i in range(e["num_hidden_layers"]):
        m = nn.TransformerEncoderLayer(d, e["num_attention_heads"],
                                       e["intermediate_size"], dropout=0.0,
                                       activation=act,
                                       layer_norm_eps=e["layer_norm_eps"],
                                       batch_first=True, norm_first=True)
        m.self_attn.in_proj_weight.data = torch.cat(
            [a["wq"][i].T, a["wk"][i].T, a["wv"][i].T])
        m.self_attn.in_proj_bias.data = torch.cat(
            [a["bq"][i], a["bk"][i], a["bv"][i]])
        m.self_attn.out_proj.weight.data = a["wo"][i].T.clone()
        m.self_attn.out_proj.bias.data = a["bo"][i].clone()
        m.linear1.weight.data = lay["fc1"][i].T.clone()
        m.linear1.bias.data = lay["b1"][i].clone()
        m.linear2.weight.data = lay["fc2"][i].T.clone()
        m.linear2.bias.data = lay["b2"][i].clone()
        for n, ln in (("norm1", "ln1"), ("norm2", "ln2")):
            getattr(m, n).weight.data = lay[ln]["scale"][i].clone()
            getattr(m, n).bias.data = lay[ln]["bias"][i].clone()
        layers.append(m.eval())

    def run(pixels):
        x = conv(pixels).flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([enc["cls"].expand(b, 1, d), x], 1) + enc["pos"][None]
        if e["ln_pre"]:
            x = F.layer_norm(x, (d,), enc["ln_pre"]["scale"],
                             enc["ln_pre"]["bias"], e["layer_norm_eps"])
        for m in layers:
            x = m(x)
        x = x[:, :1]
        if e["ln_post"]:
            x = F.layer_norm(x, (d,), enc["ln_post"]["scale"],
                             enc["ln_post"]["bias"], e["layer_norm_eps"])
        return x
    return run


@pytest.mark.parametrize("enc", [ENC, CLIP], ids=["vit", "clip"])
def test_tower_matches_torch_modules(enc):
    cfg = cfg_for(enc)
    w = make_weights(cfg, 3, "cpu")
    px = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = nn_tower(w["encoder"], enc)(px)
        got = ref.encode(w["encoder"], enc, px)
    assert torch.allclose(got, want, atol=1e-5)


def nn_decoder(dec):
    """The decoder as ``nn.TransformerDecoderLayer`` modules (post-LN,
    ReLU) around the embedding, positions and vocabulary projection, called
    with ``dec``'s tensors as their parameters (gradients reach them)."""
    from torch.func import functional_call

    d, L = DEC["embed_dim"], DEC["num_layers"]
    m = nn.TransformerDecoderLayer(d, DEC["num_heads"], DEC["ff_dim"],
                                   dropout=0.0, batch_first=True)
    lay = dec["layers"]

    def layer_params(i):
        out = {}
        for mod, key in (("self_attn", "self"), ("multihead_attn", "cross")):
            a = lay[key]
            out[f"{mod}.in_proj_weight"] = torch.cat(
                [a["wq"][i].T, a["wk"][i].T, a["wv"][i].T])
            out[f"{mod}.in_proj_bias"] = torch.cat(
                [a["bq"][i], a["bk"][i], a["bv"][i]])
            out[f"{mod}.out_proj.weight"] = a["wo"][i].T
            out[f"{mod}.out_proj.bias"] = a["bo"][i]
        f = lay["ffn"]
        out.update({"linear1.weight": f["w1"][i].T, "linear1.bias": f["b1"][i],
                    "linear2.weight": f["w2"][i].T, "linear2.bias": f["b2"][i]})
        for n in (1, 2, 3):
            out[f"norm{n}.weight"] = lay[f"ln{n}"]["scale"][i]
            out[f"norm{n}.bias"] = lay[f"ln{n}"]["bias"][i]
        return out

    pe = torch.zeros(DEC["max_seq_len"], d)
    pos = torch.arange(DEC["max_seq_len"], dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(pos * div).float()
    pe[:, 1::2] = torch.cos(pos * div).float()

    def run(tokens, memory):
        t = tokens.shape[1]
        x = dec["token_embedding"][tokens] * math.sqrt(d) + pe[:t]
        causal = torch.triu(torch.full((t, t), float("-inf")), 1)
        pad = torch.where(tokens == IDS["pad"], float("-inf"), 0.0)
        for i in range(L):
            x = functional_call(m, layer_params(i), (x, memory),
                                {"tgt_mask": causal,
                                 "tgt_key_padding_mask": pad})
        return x @ dec["fc_out_w"] + dec["fc_out_b"]
    return run


def test_decoder_logits_match_torch_modules():
    cfg = cfg_for(ENC)
    w = make_weights(cfg, 4, "cpu")
    rows = torch.from_numpy(make_captions(4, cfg, 4, 9)[:, :9]).long()
    mem = torch.randn(4, 1, DEC["embed_dim"],
                      generator=torch.Generator().manual_seed(2))
    run = nn_decoder(w["decoder"])
    with torch.no_grad():
        want = run(rows, mem)
        got = ref.decoder_logits(w["decoder"], DEC, rows, mem, IDS["pad"])
    real = rows != IDS["pad"]
    assert torch.allclose(got[real], want[real], atol=1e-5)


def test_greedy_matches_an_uncached_module_loop():
    cfg = cfg_for(ENC)
    w = make_weights(cfg, 5, "cpu")
    w["decoder"]["fc_out_b"][IDS["end"]] += 0.3
    imgs = make_images(4, (40, 48), 5, "cpu")
    with torch.no_grad():
        got = ref.greedy(w, cfg, imgs, DEC["max_seq_len"])
        mem = ref.project(w, nn_tower(w["encoder"], ENC)(
            ref.preprocess(imgs, cfg["preprocess"])))
        run = nn_decoder(w["decoder"])
        want = []
        for i in range(4):
            seq = [IDS["start"]]
            while len(seq) < DEC["max_seq_len"] and seq[-1] != IDS["end"]:
                lg = run(torch.tensor([seq]), mem[i:i + 1])
                seq.append(int(lg[0, -1].argmax()))
            want.append(seq)
    assert got == want


def test_beam_search_of_one_beam_is_greedy():
    cfg = cfg_for(ENC)
    w = make_weights(cfg, 5, "cpu")
    w["decoder"]["fc_out_b"][IDS["end"]] += 0.3
    imgs = make_images(4, (40, 48), 5, "cpu")
    with torch.no_grad():
        want = ref.greedy(w, cfg, imgs, DEC["max_seq_len"])
        mem = ref.memory_of(w, cfg, imgs)
        got, totals = ref.beam_search(w["decoder"], DEC, mem, IDS, 1,
                                      DEC["max_seq_len"])
        scored = ref.caption_logprob(w["decoder"], DEC, got, mem, IDS["pad"])
    assert got == want
    assert torch.allclose(totals, scored, atol=1e-4)


def test_beam_search_wide_enough_finds_the_best_caption():
    """With as many beams as there are captions, the beam search prunes
    nothing: its best total is the best of every caption, enumerated here
    and scored teacher-forced (a caption ends at its END or at the length
    cap)."""
    import itertools

    dc = dict(DEC, vocab_size=6, max_seq_len=4)
    cfg = dict(cfg_for(ENC), decoder=dc)
    w = make_weights(cfg, 8, "cpu")
    w["decoder"]["fc_out_b"][IDS["end"]] += 1.0
    mem = torch.randn(2, 1, dc["embed_dim"],
                      generator=torch.Generator().manual_seed(4))
    v, n = dc["vocab_size"], dc["max_seq_len"] - 1
    caps = [[IDS["start"], *c] for m in range(1, n + 1)
            for c in itertools.product(range(v), repeat=m)
            if IDS["end"] not in c[:-1]
            and (m == n or c[-1] == IDS["end"])]
    with torch.no_grad():
        got, totals = ref.beam_search(w["decoder"], dc, mem, IDS, v ** n,
                                      dc["max_seq_len"])
        for i in range(2):
            scores = ref.caption_logprob(w["decoder"], dc, caps,
                                         mem[i:i + 1].expand(len(caps), 1,
                                                             -1), IDS["pad"])
            assert math.isclose(float(totals[i]), float(scores.max()),
                                abs_tol=1e-4)


def test_training_steps_match_a_module_step():
    cfg = cfg_for(ENC)
    w = make_weights(cfg, 6, "cpu")
    trainable = {"projection": w["projection"], "decoder": w["decoder"]}
    rows = make_captions(8, cfg, 4, 6)
    feats = torch.randn(8, 1, ENC["hidden_size"],
                        generator=torch.Generator().manual_seed(3))
    batches = [{"features": feats[i:i + 4],
                "decoder_input_tokens": torch.from_numpy(rows[i:i + 4, :-1]),
                "target_tokens": torch.from_numpy(rows[i:i + 4, 1:])}
               for i in (0, 4)]
    got = ref.train_steps(trainable, cfg, batches, seed=0)

    # straightforward: nn modules, cross entropy, clip and AdamW by hand
    params = {k: v.clone() for k, v in ref.leaves(trainable).items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for step, b in enumerate(batches):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        dec = ref._tree({k[8:]: v for k, v in p.items()
                         if k.startswith("decoder/")})
        run = nn_decoder(dec)
        mem = b["features"] @ p["projection/w"] + p["projection/b"]
        logits = run(b["decoder_input_tokens"].long(), mem)
        loss = F.cross_entropy(logits.reshape(-1, DEC["vocab_size"]),
                               b["target_tokens"].long().reshape(-1),
                               ignore_index=IDS["pad"])
        names = list(p)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names], allow_unused=True,
            materialize_grads=True)))
        grads["decoder/token_embedding"][IDS["pad"]] = 0
        norm = math.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        scale = TRAIN["grad_clip"] / norm if norm >= TRAIN["grad_clip"] else 1
        for k, g in grads.items():
            g = g * scale
            mu[k] = 0.9 * mu[k] + 0.1 * g
            nu[k] = 0.98 * nu[k] + 0.02 * g * g
            mhat = mu[k] / (1 - 0.9 ** (step + 1))
            vhat = nu[k] / (1 - 0.98 ** (step + 1))
            params[k] = params[k] - TRAIN["learning_rate"] * (
                mhat / (vhat.sqrt() + 1e-9)
                + TRAIN["weight_decay"] * params[k])
        losses.append(float(loss.detach()))
    assert np.allclose(got["losses"], losses, rtol=1e-5)
    # resumed from the state after the first step, the second step repeats
    first = ref.train_steps(trainable, cfg, batches[:1], seed=0)
    mu1 = {k: (1 - 0.9) * g for k, g in first["first_grad"].items()}
    nu1 = {k: (1 - 0.98) * g * g for k, g in first["first_grad"].items()}
    again = ref.train_steps(None, cfg, batches[1:], seed=0, resume={
        "params": first["params"], "mu": mu1, "nu": nu1, "step": 1})
    assert np.allclose(again["losses"], got["losses"][1:], rtol=1e-6)
    for k in params:
        assert torch.allclose(again["params"][k], got["params"][k],
                              atol=1e-7), k
    # a key's bias is shift-invariant under softmax, and one memory row
    # makes the cross-attention's query and key moot: their gradients are
    # rounding, which Adam scales up to a step of any sign
    moot = ("self/bk", "cross/wq", "cross/bq", "cross/wk", "cross/bk")
    for k in params:
        if not k.endswith(moot):
            assert torch.allclose(got["params"][k], params[k], atol=1e-6), k


def test_hash_keep_matches_a_scalar_loop():
    seed, rate, b, h, t, s = 12345, 0.1, 2, 3, 4, 5
    keep = hash_keep(b, h, t, s, rate, seed, "cpu")

    def scalar(cell, row, col):
        m = 0xFFFFFFFF
        x = ((row * s + col) & m) ^ ((seed * 2654435761) & m) \
            ^ ((cell * 0x9E3779B9) & m)
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & m
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & m
        x ^= x >> 16
        return x >= int(rate * (1 << 32))

    for c in range(b * h):
        for r in range(t):
            for col in range(s):
                assert bool(keep.reshape(b * h, t, s)[c, r, col]) == \
                    scalar(c, r, col)
    assert 0.8 < keep.float().mean() < 1.0


def test_fp8_control_rounds_every_product():
    a = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    b = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    exact = ref.F32.mm(a, b)
    low = ref.Arith("fp8").mm(a, b)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
