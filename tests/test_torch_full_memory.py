"""Port parity: decoding over full-sequence or padded memory
(``memory_mode="full"``), and the per-row decode step, of mit_tpu_torch
against mit_tpu on the CPU.

The same numpy-made weights, memory and tokens go through both packages.
The full-memory cache (projected memory keys and values, the additive
padding mask) and every step's logits are held to the JAX package's; greedy,
beam K = 3 and sampling at temperature 0 give the JAX batch loops' tokens.
The fused decode layer takes the CLS constant only, so ``fused=True`` over
full memory runs the unfused layers, as the JAX package's step does, and
the route counter shows it. The per-row step (the service's: each row at its
own position, inactive rows and key pads) is held to the JAX service's
``_one_token_logits`` in both memory modes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import beam as jbeam
from mit_tpu.decode import greedy as jgreedy
from mit_tpu.decode import sampling as jsampling
from mit_tpu.decode import service as jservice
from mit_tpu.decode import step as jstep
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu_torch.decode import beam as tbeam
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import sampling as tsampling
from mit_tpu_torch.decode import service as tservice
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig

V, D, H, L, F, MAXLEN, S_MEM, B = 60, 32, 4, 2, 64, 20, 5, 4
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)
JCFG, TCFG = JDecoderConfig(**KW), DecoderConfig(**KW)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the projected memory: the same products summed in another order (f32), so
# at most one rounding apart in the compute dtype (bf16)
PROJ_TOL = {"float32": 1e-6, "bfloat16": 2 ** -8}
# bf16 logits: each package rounds the same operands at the same points,
# but sums f32 products in another order, and one last-bit difference of a
# bf16 activation moves a logit by up to about 2e-2 here
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        init_decoder_params(jax.random.PRNGKey(3), JCFG))


def _memory(n=B, s=S_MEM, seed=5):
    return np.random.default_rng(seed).normal(size=(n, s, D)).astype(np.float32)


def _mask(case, n=B, s=S_MEM):
    """None, a ragged padding mask, or one with a row of all PAD."""
    if case == "none":
        return None
    m = np.zeros((n, s), bool)
    m[1, 3:] = True
    m[2, 1:] = True
    if case == "all_pad_row":
        m[0, :] = True
    return m


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _routes():
    return dict(tstep.decoder_step.routes)


# ----------------------------------------------------------------------
# init_cache and the step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mask_case", ["none", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_full_memory_matches_jax(params, dtype, mask_case):
    """Memory keys and values (L, B, H, S, hd) in the compute dtype within
    PROJ_TOL of the JAX package's, and the (B, 1, S) additive mask bit for
    bit; no CLS constant. A (B, 1, D) memory with a mask takes the full
    branch too."""
    jd, td = DTYPES[dtype]
    for s in (S_MEM, 1):
        mem, mask = _memory(s=s), _mask(mask_case, s=s)
        if s == 1 and mask is None:
            continue
        jc = jstep.init_cache(params, JCFG, jnp.asarray(mem),
                              None if mask is None else jnp.asarray(mask),
                              max_len=8, compute_dtype=jd)
        tc = tstep.init_cache(params_from_jax(params), TCFG, _t(mem), _t(mask),
                              max_len=8, compute_dtype=td)
        assert tc.cross_const is None
        for mine, theirs in ((tc.cross_k, jc.cross_k), (tc.cross_v, jc.cross_v)):
            assert mine.dtype == td and mine.shape == (L, B, H, s, D // H)
            np.testing.assert_allclose(mine.float().numpy(), _f32(theirs),
                                       rtol=PROJ_TOL[dtype],
                                       atol=PROJ_TOL[dtype])
        if mask is None:
            assert tc.cross_mask is None and jc.cross_mask is None
        else:
            np.testing.assert_array_equal(tc.cross_mask.numpy(),
                                          np.asarray(jc.cross_mask))
        for a in tc.k + tc.v:
            assert a.shape == (B, 8, D) and a.dtype == td and not a.any()


@pytest.mark.parametrize("mask_case", ["none", "padded", "all_pad_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_memory_step_logits_match_jax(params, dtype, mask_case):
    """Teacher-forced tokens (a generated PAD among them), every position:
    the logits within LOGIT_TOL of the JAX step's and finite, also for a
    memory row that is all PAD (a uniform softmax over -1e9)."""
    jd, td = DTYPES[dtype]
    mem, mask = _memory(seed=11), _mask(mask_case)
    toks = np.random.default_rng(2).integers(4, V, size=(B, 10))
    toks[:, 0] = START
    toks[3, 4] = PAD
    jp = jstep.prepare_decode_params(params, jd)
    tp = tstep.prepare_decode_params(params_from_jax(params), td)
    jc = jstep.init_cache(params, JCFG, jnp.asarray(mem),
                          None if mask is None else jnp.asarray(mask),
                          max_len=16, compute_dtype=jd)
    tc = tstep.init_cache(params_from_jax(params), TCFG, _t(mem), _t(mask),
                          max_len=16, compute_dtype=td)
    worst = 0.0
    for t in range(toks.shape[1]):
        key_pad = np.zeros((B, 16), bool)
        key_pad[:, : t + 1] = toks[:, : t + 1] == PAD
        ref, jc = jstep.decoder_step(
            jp, JCFG, jnp.asarray(toks[:, t], jnp.int32),
            jnp.asarray(t, jnp.int32), jc, jd, jnp.asarray(key_pad))
        out, tc = tstep.decoder_step(tp, TCFG, _t(toks[:, t]), t, tc, td,
                                     key_pad=_t(key_pad))
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        worst = max(worst, float(np.abs(out.numpy() - np.asarray(ref)).max()))
    assert worst <= LOGIT_TOL[dtype], worst


def test_full_memory_cache_reindex_and_growth(params):
    """reindex_cache gathers the memory keys, values (axis 1) and mask (axis
    0) as the JAX function does; grow_cache leaves them as they are."""
    mem, mask = _memory(), _mask("padded")
    jc = jstep.init_cache(params, JCFG, jnp.asarray(mem), jnp.asarray(mask),
                          max_len=8)
    tc = tstep.init_cache(params_from_jax(params), TCFG, _t(mem), _t(mask),
                          max_len=8)
    idx = np.array([2, 2, 0, 3], np.int64)
    ref = jstep.reindex_cache(jc, jnp.asarray(idx))
    out = tstep.reindex_cache(tc, _t(idx))
    for name, axis in (("cross_k", 1), ("cross_v", 1), ("cross_mask", 0)):
        mine = getattr(out, name)
        torch.testing.assert_close(
            mine, getattr(tc, name).index_select(axis, _t(idx)), rtol=0, atol=0)
        np.testing.assert_allclose(mine.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=PROJ_TOL["float32"],
                                   atol=PROJ_TOL["float32"])
    assert out.cross_const is None
    grown = tstep.grow_cache(tc, 16)
    assert grown.k[0].shape == (B, 16, D)
    for name in ("cross_k", "cross_v", "cross_mask"):
        assert getattr(grown, name) is getattr(tc, name)


# ----------------------------------------------------------------------
# the loops
# ----------------------------------------------------------------------
def _rigged(params, token, bias):
    p = dict(params)
    b = np.zeros((V,), np.float32)
    b[token] = bias
    p["fc_out_b"] = b
    return p


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mask_case", ["none", "padded"])
def test_full_memory_greedy_and_sampling_match_jax(params, mask_case, fused):
    """f32 greedy tokens equal the JAX loop's (across a bucket crossing, with
    captions that END); sampling at temperature 0 gives them too. Asked to
    fuse, every step runs unfused: the fused layer takes the CLS constant
    only."""
    p = _rigged(params, END, 0.8)
    mem, mask = _memory(seed=17), _mask(mask_case)
    ref, ref_len = jgreedy.greedy_generate(
        p, JCFG, jnp.asarray(mem), START, END, PAD, MAXLEN,
        None if mask is None else jnp.asarray(mask))
    tp = params_from_jax(p)
    before = _routes()
    out, out_len = tgreedy.greedy_generate(tp, TCFG, _t(mem), START, END, PAD,
                                           MAXLEN, _t(mask), fused=fused)
    cold, cold_len = tsampling.sample_generate(
        tp, TCFG, _t(mem), torch.Generator().manual_seed(0), START, END, PAD,
        MAXLEN, temperature=0.0, memory_padding_mask=_t(mask), fused=fused)
    after = _routes()
    assert after["fused"] == before["fused"]
    assert after["unfused"] > before["unfused"]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(cold.numpy(), np.asarray(ref))
    lengths = out_len.numpy()
    assert lengths.max() > 16 and lengths.min() < MAXLEN   # bucket, END
    jcold, _ = jsampling.sample_generate(
        p, JCFG, jnp.asarray(mem), jax.random.PRNGKey(0), START, END, PAD,
        MAXLEN, temperature=0.0,
        memory_padding_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(jcold), np.asarray(ref))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mask_case", ["none", "padded"])
def test_full_memory_beam_matches_jax(params, mask_case, fused):
    """Beam K = 3 over full memory (the memory and its mask repeated K times,
    the cache reindexed every step): the JAX package's tokens and scores."""
    p = _rigged(params, END, 1.0)
    mem, mask = _memory(seed=17), _mask(mask_case)
    ref, ref_scores = jbeam.beam_generate(
        p, JCFG, jnp.asarray(mem), START, END, PAD, MAXLEN, 3,
        None if mask is None else jnp.asarray(mask))
    before = _routes()
    out, scores = tbeam.beam_generate(params_from_jax(p), TCFG, _t(mem), START,
                                      END, PAD, MAXLEN, 3, _t(mask),
                                      fused=fused)
    assert _routes()["fused"] == before["fused"]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=1e-5, atol=1e-5)


def test_fused_route_over_full_memory_is_unfused_on_the_card_too(
        params, monkeypatch):
    """step_route gives "unfused" for full memory whatever the device and
    geometry, and never raises; a step asked to fuse over full memory counts
    as unfused and gives the unfused step's logits exactly."""
    for device in ("cpu", "cuda"):
        for fused in (False, True):
            assert tstep.step_route(fused, device, TCFG, False) == "unfused"
    assert tstep.step_route(True, "cpu", TCFG, True) == "fused"
    mem = _memory(seed=19)
    tp = tstep.prepare_decode_params(params_from_jax(params), fused=True)
    toks = _t(np.full((B,), START))
    outs = []
    for fused in (False, True):
        cache = tstep.init_cache(params_from_jax(params), TCFG, _t(mem),
                                 max_len=8)
        before = _routes()
        logits, _ = tstep.decoder_step(tp, TCFG, toks, 0, cache, fused=fused)
        assert _routes() == {"fused": before["fused"],
                             "unfused": before["unfused"] + 1}
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("method", ["greedy", "beam", "sample"])
def test_captioner_full_memory_mode(params, method):
    """Captioner in memory_mode="full" captions (B, S, D) memory under every
    method: greedy and beam give the JAX Captioner's tokens, sampling at
    temperature 0 gives greedy's, and a seeded draw repeats."""
    from mit_tpu.decode.api import Captioner as JCaptioner
    from mit_tpu.models.model import ModelConfig as JModelConfig
    from mit_tpu.models.vision import PRESETS as JPRESETS
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import PRESETS

    class Ids:
        pad_id, start_id, end_id, unk_id = PAD, START, END, 1

    p = _rigged(params, END, 1.5)
    name = "mit/tiny-vit-debug"
    cap = Captioner({"decoder": params_from_jax(p), "encoder": {}},
                    ModelConfig(name, PRESETS[name], TCFG, "full"), Ids(),
                    beam_size=3)
    jcap = JCaptioner({"decoder": p, "encoder": {}},
                      JModelConfig(name, JPRESETS[name], JCFG, "full"), Ids())
    mem = _memory(seed=23)
    got = cap.generate_from_memory(_t(mem), max_len=MAXLEN, method=method)
    assert len(got) == B and all(row[0] == START for row in got)
    if method == "sample":
        greedy = cap.generate_from_memory(_t(mem), max_len=MAXLEN)
        assert cap.generate_from_memory(_t(mem), max_len=MAXLEN,
                                        method="sample",
                                        temperature=0.0) == greedy
        assert got == cap.generate_from_memory(_t(mem), max_len=MAXLEN,
                                               method="sample")
        return
    want = jcap.generate_from_memory(jnp.asarray(mem), max_len=MAXLEN,
                                     method=method, beam_size=3)
    assert got == want


# ----------------------------------------------------------------------
# the per-row step: the service's
# ----------------------------------------------------------------------
def _ragged_state(rng, rows, t_max):
    """Per-row positions, key pads and a cache of stale rows past them."""
    pos = np.array([0, 3, 7, 2, 11, 5][:rows], np.int32)
    key_pad = rng.random((rows, t_max)) < 0.2
    key_pad[np.arange(rows), pos] = False
    k = [rng.normal(size=(rows, t_max, D)).astype(np.float32) for _ in range(L)]
    v = [rng.normal(size=(rows, t_max, D)).astype(np.float32) for _ in range(L)]
    return pos, key_pad, k, v


@pytest.mark.parametrize("mode", ["cls", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_step_matches_jax_service_step(params, mode, dtype):
    """The port's per-row step (``decoder_step`` with a (R,) position tensor,
    the one the service runs) against the JAX service's
    ``_one_token_logits`` at ragged positions, over caches whose rows past
    each position are stale, with key pads: logits within 1e-5 in f32
    (LOGIT_TOL in bf16), the fresh rows written at (row, pos[row]) and
    nothing else of the cache changed (the fresh rows within PROJ_TOL of
    the JAX step's, the rest as they were). An inactive row is one more row at
    its own position: the window freezes it outside the step."""
    jd, td = DTYPES[dtype]
    rows, t_max = 6, 16
    rng = np.random.default_rng(29)
    pos, key_pad, k, v = _ragged_state(rng, rows, t_max)
    tokens = rng.integers(4, V, size=rows)
    tokens[4] = PAD
    if mode == "cls":
        mem = rng.normal(size=(rows, 1, D)).astype(np.float32)
        jcross = {"const": jservice._cross_const_for(
            {n: jnp.asarray(params["layers"]["cross"][n])
             for n in ("wv", "bv", "wo", "bo")}, jnp.asarray(mem))}
        tcross = {"const": torch.from_numpy(np.array(jcross["const"]))}
    else:
        mem = rng.normal(size=(rows, 3, D)).astype(np.float32)
        jcross = jservice._cross_kv_for(
            {n: jnp.asarray(params["layers"]["cross"][n])
             for n in ("wk", "bk", "wv", "bv")}, jnp.asarray(mem), H, jd)
        ck, cv = tstep.cross_kv(params_from_jax(params)["layers"]["cross"],
                                _t(mem), H, td)
        for mine, theirs in ((ck, jcross["k"]), (cv, jcross["v"])):
            np.testing.assert_allclose(mine.float().numpy(), _f32(theirs),
                                       rtol=PROJ_TOL[dtype],
                                       atol=PROJ_TOL[dtype])
        tcross = {"k": ck, "v": cv}
    jp = jstep.prepare_decode_params(params, jd)
    tp = tstep.prepare_decode_params(params_from_jax(params), td)
    ref, jk, jv = jservice._one_token_logits(
        jp, JCFG, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos),
        jnp.asarray(key_pad), tuple(jnp.asarray(a, jd) for a in k),
        tuple(jnp.asarray(a, jd) for a in v), jcross, jd)
    tk = [torch.from_numpy(a).to(td) for a in k]
    tv = [torch.from_numpy(a).to(td) for a in v]
    before = [a.clone() for a in tk]
    out = tservice._one_token_logits(tp, TCFG, _t(tokens), _t(pos),
                                     _t(key_pad), tk, tv, tcross, td)
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err <= LOGIT_TOL[dtype], err
    tol = PROJ_TOL[dtype]               # the fresh rows are one product
    for mine, theirs, old in zip(tk, jk, before):
        np.testing.assert_allclose(mine.float().numpy(), _f32(theirs),
                                   rtol=tol, atol=tol)
        changed = (mine != old).any(-1)
        others = np.ones((rows, t_max), bool)
        others[np.arange(rows), pos] = False
        assert not changed.numpy()[others].any()


def test_per_row_positions_equal_a_scalar_on_the_unfused_route(params):
    """A (B,) position tensor equal to a scalar gives the scalar's logits and
    cache, bit for bit, over CLS and full memory."""
    for s in (1, S_MEM):
        mem = _memory(s=s, seed=31)
        tp = tstep.prepare_decode_params(params_from_jax(params))
        toks = _t(np.arange(B) % 7 + 4)
        outs, caches = [], []
        for pos in (3, torch.full((B,), 3, dtype=torch.int32)):
            cache = tstep.init_cache(params_from_jax(params), TCFG, _t(mem),
                                     max_len=8)
            for a in cache.k + cache.v:
                a.copy_(torch.from_numpy(np.random.default_rng(1).normal(
                    size=a.shape).astype(np.float32)))
            out, cache = tstep.decoder_step(tp, TCFG, toks, pos, cache)
            outs.append(out)
            caches.append(cache)
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        for a, b in zip(caches[0].k + caches[0].v, caches[1].k + caches[1].v):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
