"""Kimi-VL-A3B's language model and projector in the port
(``models/kimi_vl.py``, ``ops/mla.py``, ``ops/moe.py``,
``decode/kimi_vl.py``) against the plain float32 reference
(``models/kimi_vl_reference.py``), on seeded random weights at a small
size, in float32 on the CPU.

The JAX package has no such model, so there is no JAX counterpart to hold
the port to: the reference, written from the published modelling code, is
the yardstick. Tolerances: both sides compute in float32 but sum in other
orders (batched products, the absorbed decode, the grouped experts), so
logits agree to about 1e-5 of their spread; 1e-4 leaves room for that and
catches any change to the mathematics, which moves them by 1e-2 or more.
"""

import math

import pytest
import torch

from mit_tpu_torch.decode.api import Captioner
from mit_tpu_torch.decode.kimi_vl import KimiVLCaptioner
from mit_tpu_torch.decode.service import CaptionService
from mit_tpu_torch.models import kimi_vl as kv
from mit_tpu_torch.models import kimi_vl_reference as ref
from mit_tpu_torch.models.model import ModelConfig
from mit_tpu_torch.models.vision import PRESETS, init_vision_params
from mit_tpu_torch.ops import moe

TOL = 1e-4
SMALL = kv.KimiVLConfig(
    vocab_size=256, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=2,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
    v_head_dim=16, n_routed_experts=8, n_shared_experts=1,
    num_experts_per_tok=2, first_k_dense_replace=1, rope_theta=10000.0,
    vision_width=48)
# weights N(0, 1/√64): logits of about unit spread, as the published
# model's N(0, 0.02) at width 2048 gives
STD = 0.125


def params(seed=0, cfg=SMALL):
    p = kv.init_kimi_vl_params(torch.Generator().manual_seed(seed), cfg,
                               std=STD)
    # a correction bias that moves choices: the router's scores spread
    # about 0.2, the bias by as much
    p["lm"]["moe"]["router_bias"] = torch.randn(
        p["lm"]["moe"]["router_bias"].shape,
        generator=torch.Generator().manual_seed(seed + 1)) * 0.2
    return p


def close(a, b, tol=TOL):
    a, b = a.float(), b.float()
    scale = b.abs().max().clamp_min(1.0)
    assert float((a - b).abs().max()) <= tol * scale, \
        float((a - b).abs().max())


def image_tokens(seed, b, n=4, cfg=SMALL):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, cfg.hidden_size), generator=g)


@pytest.mark.parametrize("b,prompt_len", [(1, 3), (3, 5)])
def test_prefill_logits_match_the_reference(b, prompt_len):
    p = params(1)
    lm, layers = p["lm"], kv.prepare(p["lm"], SMALL)
    img = image_tokens(2, b)
    ids = torch.randint(0, SMALL.vocab_size, (b, prompt_len),
                        generator=torch.Generator().manual_seed(3))
    x = torch.cat([img, lm["embed"][ids]], dim=1)
    cache = kv.init_cache(SMALL, b, x.shape[1], "cpu", torch.float32)
    tables = kv.rope_tables(torch.arange(x.shape[1]), SMALL)
    got = kv.lm_prefill(lm, SMALL, layers, x, cache, tables)
    for r in range(b):
        want = ref.forward(lm, SMALL, img[r], ids[r])[-1]
        close(got[r], want)


def test_cached_decode_matches_the_full_forward_at_every_position():
    """A prefill, then 8 tokens through the latent cache: the logits at
    every generated position equal the reference's full forward over
    ``[image; prompt; generated]``, and greedy decoding picks their
    argmax."""
    b, steps = 2, 8
    p = params(4)
    lm, layers = p["lm"], kv.prepare(p["lm"], SMALL)
    img = image_tokens(5, b)
    prompt = torch.tensor([7, 11, 13])
    x = torch.cat([img, lm["embed"][prompt][None].expand(b, -1, -1)], dim=1)
    t0 = x.shape[1]
    cache = kv.init_cache(SMALL, b, t0 + steps - 1, "cpu", torch.float32)
    tables = kv.rope_tables(torch.arange(t0 + steps - 1), SMALL)
    logits = [kv.lm_prefill(lm, SMALL, layers, x, cache, tables)]
    toks = [logits[-1].argmax(-1)]
    for j in range(1, steps):
        logits.append(kv.lm_step(lm, SMALL, layers, toks[-1],
                                 torch.tensor(t0 + j - 1), cache, tables))
        toks.append(logits[-1].argmax(-1))
    toks = torch.stack(toks, 1)
    for r in range(b):
        seq = torch.cat([prompt, toks[r, :-1]])
        want = ref.forward(lm, SMALL, img[r], seq)[t0 - 1:]
        close(torch.stack([lg[r] for lg in logits]), want)
    got = kv.greedy_generate_vlm(lm, SMALL, layers, img, prompt, steps)
    assert torch.equal(got, toks)


def test_generation_ends_a_row_at_its_end_token():
    p = params(6)
    lm, layers = p["lm"], kv.prepare(p["lm"], SMALL)
    img, prompt = image_tokens(7, 3), torch.tensor([1, 2])
    free = kv.greedy_generate_vlm(lm, SMALL, layers, img, prompt, 6)
    end = int(free[0, 2])
    got = kv.greedy_generate_vlm(lm, SMALL, layers, img, prompt, 6, end)
    for r in range(3):
        row = free[r].tolist()
        cut = row.index(end) + 1 if end in row else len(row)
        assert got[r, :cut].tolist() == row[:cut]
        assert (got[r, cut:] == -1).all()


# ----------------------------------------------------------------------
# the router and the expert layer
# ----------------------------------------------------------------------
def _router_inputs(seed, t=40, d=64, e=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((t, d), generator=g),
            torch.randn((d, e), generator=g) * STD,
            torch.randn((e,), generator=g) * 0.2)


@pytest.mark.parametrize("normalize", [True, False])
def test_router_chooses_with_the_bias_and_weighs_without_it(normalize):
    x, w, bias = _router_inputs(8)
    idx, weights = moe.moe_route(x, w, bias, 2, 2.446, normalize)
    s = torch.sigmoid(x @ w)
    want_idx = torch.topk(s + bias, 2).indices
    assert torch.equal(idx, want_idx)
    # the bias moves some choice: without it the top 2 differ somewhere
    assert not torch.equal(torch.topk(s, 2).indices, want_idx)
    chosen = s.gather(1, want_idx)
    if normalize:
        chosen = chosen / chosen.sum(-1, keepdim=True)
        close(weights.sum(-1), torch.full((40,), 2.446))
    close(weights, chosen * 2.446, 1e-6)


def test_router_counts_the_largest_load():
    moe.reset_counters()
    x, w, bias = _router_inputs(9)
    idx, _ = moe.moe_route(x, w, bias, 2, 1.0)
    wg = torch.zeros((8, 64, 32))
    for _ in range(2):
        moe.moe_experts(x, idx, wg, wg, wg.transpose(1, 2), "prefill")
    moe.flush_counters()
    load = torch.bincount(idx.reshape(-1), minlength=8).float()
    assert moe.moe_route.max_load == pytest.approx(
        2 * float(load.max() / load.mean()))


@pytest.mark.parametrize("t,k,e", [(1, 2, 8), (40, 2, 8), (64, 6, 64)])
def test_expert_layer_matches_dense_evaluation(t, k, e):
    """Grouping routes by expert and running only the experts hit equals
    evaluating every expert densely on every token and picking each
    route's; the counters see the call, its rows and the experts hit."""
    g = torch.Generator().manual_seed(t + e)
    d, f = 64, 32
    x = torch.randn((t, d), generator=g)
    wg, wu = (torch.randn((e, d, f), generator=g) * STD for _ in range(2))
    wd = torch.randn((e, f, d), generator=g) * STD
    idx = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)])
    moe.reset_counters()
    got = moe.moe_experts(x, idx, wg, wu, wd, "decode")
    dense = torch.stack([ref.swiglu(x, wg[i], wu[i], wd[i])
                         for i in range(e)])                 # (E, T, D)
    want = dense[idx, torch.arange(t)[:, None]]              # (T, k, D)
    close(got, want)
    moe.flush_counters()
    assert moe.moe_experts.calls == {"prefill": 0, "decode": 1}
    assert moe.moe_experts.rows == {"prefill": 0, "decode": t * k}
    assert moe.moe_experts.experts_hit["decode"] == len(set(
        idx.reshape(-1).tolist()))


def test_grouping_sorts_routes_by_expert_and_skips_empty_ones():
    idx = torch.tensor([[3, 1], [1, 0], [3, 5]])
    order, token, offsets = moe.group_routes(idx, 8)
    assert idx.reshape(-1)[order].tolist() == [0, 1, 1, 3, 3, 5]
    assert token.tolist() == [1, 0, 1, 0, 2, 2]
    assert offsets.tolist() == [0, 1, 3, 3, 5, 5, 6, 6, 6]
    assert moe.row_tile_bound(6, 8) >= 4


def test_moe_layer_adds_the_shared_expert_once():
    p = params(10)
    m, j = p["lm"]["moe"], 0
    x = torch.randn((12, 64), generator=torch.Generator().manual_seed(11))
    got = moe.moe_layer(x, m["router"][j], m["router_bias"][j],
                        m["w_gate"][j], m["w_up"][j], m["w_down"][j],
                        m["shared_gate"][j], m["shared_up"][j],
                        m["shared_down"][j], 2, SMALL.routed_scaling_factor,
                        True, "prefill")
    close(got, ref.moe(m, j, x, SMALL))
    shared = ref.swiglu(x, m["shared_gate"][j], m["shared_up"][j],
                        m["shared_down"][j])
    assert float((got - ref.moe(m, j, x, SMALL) - shared).abs().max()) > 1e-2


# ----------------------------------------------------------------------
# the projector
# ----------------------------------------------------------------------
def test_projector_merges_each_2x2_block_row_major():
    g = 4
    x = torch.arange(g * g, dtype=torch.float32)[None, :, None]
    merged = kv.merge_patches(x, 2)[0, :, :].tolist()
    # block (0, 0): patches (0,0) (0,1) (1,0) (1,1) of the 4 x 4 grid
    assert merged == [[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                      [10, 11, 14, 15]]


def test_projector_matches_the_reference():
    p = params(12)
    feats = torch.randn((2, 17, SMALL.vision_width),
                        generator=torch.Generator().manual_seed(13))
    got = kv.project_patches(p["projector"], SMALL, feats)
    for r in range(2):
        close(got[r], ref.project(p["projector"], SMALL, feats[r]))


# ----------------------------------------------------------------------
# the captioner
# ----------------------------------------------------------------------
class Ids:
    pad_id, start_id, end_id = 0, 1, 2


def captioner():
    vision = PRESETS["mit/tiny-vit-debug"]._replace(hidden_size=48)
    cfg = SMALL._replace(vision_width=48)
    mcfg = ModelConfig("mit/tiny-vit-debug", vision, cfg, "full", "kimi_vl")
    p = params(14, cfg)
    p["encoder"] = init_vision_params(torch.Generator().manual_seed(15),
                                      vision)
    return Captioner(p, mcfg, Ids())


def test_captioner_captions_from_pixels():
    cap = captioner()
    assert isinstance(cap, KimiVLCaptioner)
    px = torch.randn((2, 3, 224, 224),
                     generator=torch.Generator().manual_seed(16))
    mem = cap.memory_from_pixels(px)
    assert mem.shape == (2, 4, 64)
    out = cap.generate_from_memory(mem, prompt_ids=[5, 6],
                                   max_new_tokens=5, end_token_id=-1)
    want = kv.greedy_generate_vlm(cap.params["lm"], cap.mcfg.decoder,
                                  cap.prepared, mem, torch.tensor([5, 6]), 5)
    assert out == want.tolist()


@pytest.mark.parametrize("call", ["beam", "sample", "service", "int8",
                                  "train"])
def test_what_the_family_does_not_do_raises(call):
    cap = captioner()
    mem = torch.zeros((1, 4, 64))
    with pytest.raises(NotImplementedError, match="kimi_vl|decoder"):
        if call in ("beam", "sample"):
            cap.generate_from_memory(mem, method=call)
        elif call == "service":
            CaptionService(cap, num_slots=2)
        elif call == "int8":
            Captioner(cap.params, cap.mcfg, Ids(), encoder_quant="int8")
        else:
            from mit_tpu_torch.train.steps import make_optimizer, \
                make_train_step
            from mit_tpu_torch.config import Config

            make_train_step(cap.mcfg, make_optimizer(Config()), 0)


def test_the_config_field_selects_the_family():
    from mit_tpu_torch.config import Config

    mcfg = ModelConfig.build(Config(
        ENCODER_MODEL_NAME="openai/clip-vit-large-patch14",
        LANGUAGE_MODEL="kimi_vl"))
    assert mcfg.language_model == "kimi_vl" and mcfg.memory_mode == "full"
    assert mcfg.decoder == kv.KIMI_VL_A3B
    assert ModelConfig.build(Config()).language_model == "decoder"
    with pytest.raises(ValueError):
        ModelConfig.build(Config(LANGUAGE_MODEL="llama"))


def test_published_shape():
    c = kv.KIMI_VL_A3B
    shapes = kv.param_shapes(c)
    n = {k: math.prod(s) for k, s in shapes.items()}
    moe_layer = sum(v for k, v in n.items() if k.startswith("lm/moe/")) \
        / c.n_moe_layers
    assert round(moe_layer / 1e6, 1) == 571.1
    total = sum(v for k, v in n.items() if k.startswith("lm/"))
    assert round(total / 1e9, 2) == 15.96
    assert c.latent_width == 576 and c.q_head_dim == 192
    hf = {"q_lora_rank": None, "n_group": 1, "hidden_size": 2048}
    assert kv.KimiVLConfig.from_hf(hf) == c
    with pytest.raises(NotImplementedError):
        kv.KimiVLConfig.from_hf({"q_lora_rank": 1536})
