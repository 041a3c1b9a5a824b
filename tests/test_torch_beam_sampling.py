"""Port parity: beam search, sampling and cache reordering of mit_tpu_torch
against mit_tpu on the CPU.

The same numpy-made weights and memory go through both packages. Beam
search is held to the JAX package's tokens and scores, to greedy at
``beam_size=1`` and to the brute-force optimum of tests/test_beam_optimality.py;
``filter_logits`` is held to the JAX function exactly. JAX's PRNG cannot be
reproduced in torch, so sampling is held to greedy at temperature 0, to its
own seed, to its filter's support and to the distribution it draws from.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import beam as jbeam
from mit_tpu.decode import sampling as jsampling
from mit_tpu.decode import step as jstep
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu_torch.decode import beam as tbeam
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import sampling as tsampling
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig, decoder_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, L, F, MAXLEN = 60, 32, 4, 2, 64, 24
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)
JCFG, TCFG = JDecoderConfig(**KW), DecoderConfig(**KW)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        init_decoder_params(jax.random.PRNGKey(1), JCFG))


@pytest.fixture(scope="module")
def memory():
    return np.random.default_rng(7).normal(size=(4, 1, D)).astype(np.float32)


class _Routes:
    """Holds a block's decode steps to the route its ``fused`` flag asks
    for: with it every step runs the fused layers (their plain version on
    these CPU tensors), without it none does."""

    def __init__(self, fused):
        self.fused = fused

    def __enter__(self):
        self.before = dict(tstep.decoder_step.routes)

    def __exit__(self, *exc):
        after = tstep.decoder_step.routes
        ran, idle = ("fused", "unfused") if self.fused else ("unfused", "fused")
        if exc[0] is None:
            assert after[ran] > self.before[ran]
            assert after[idle] == self.before[idle]


def _rigged(params, token, bias):
    p = dict(params)
    b = np.zeros((V,), np.float32)
    b[token] = bias
    p["fc_out_b"] = b
    return p


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case,k", [("plain", 3), ("plain", 5), ("end", 3),
                                    ("forced_pad", 3)])
def test_beam_matches_jax(params, memory, case, k, fused):
    """Tokens and scores equal the JAX package's: free running (across a
    bucket crossing), with beams that END at different steps, and with
    generated PADs, which must stay masked as keys."""
    p = {"plain": params, "end": _rigged(params, END, 2.5),
         "forced_pad": _rigged(params, PAD, 4.0)}[case]
    ref, ref_scores = jbeam.beam_generate(
        p, JCFG, jnp.asarray(memory), START, END, PAD, MAXLEN, beam_size=k)
    with _Routes(fused):
        out, scores = tbeam.beam_generate(
            params_from_jax(p), TCFG, torch.from_numpy(memory), START, END,
            PAD, MAXLEN, beam_size=k, fused=fused)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=1e-5, atol=1e-5)
    if case == "plain":
        assert (out[:, 17:] != PAD).any()         # ran past the first bucket
    elif case == "end":
        ends = [(row == END).nonzero().flatten().tolist() for row in out]
        assert all(len(e) <= 1 for e in ends) and any(ends)
    else:
        assert any((row[1:-1] == PAD).any() for row in out)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_beam_size_one_is_greedy(params, memory, fused):
    tp, mem = params_from_jax(params), torch.from_numpy(memory)
    with _Routes(fused):
        greedy, _ = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD,
                                            MAXLEN, fused=fused)
        beam, _ = tbeam.beam_generate(tp, TCFG, mem, START, END, PAD, MAXLEN,
                                      beam_size=1, fused=fused)
    torch.testing.assert_close(beam, greedy)


def test_top_k_lowest_first_breaks_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0],
                  [-1e30, -1e30, 2.0, -1e30, 2.0, -1e30]], np.float32)
    for k in (1, 2, 4, 6):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = tbeam.top_k_lowest_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


BV, BD, BMAX = 6, 16, 4
BCFG = DecoderConfig(vocab_size=BV, embed_dim=BD, num_heads=2, num_layers=1,
                     ff_dim=24, max_seq_len=BMAX, dropout=0.0, pad_idx=0)
BJCFG = JDecoderConfig(vocab_size=BV, embed_dim=BD, num_heads=2, num_layers=1,
                       ff_dim=24, max_seq_len=BMAX, dropout=0.0, pad_idx=0)


def _brute_force_best(tparams, memory, end):
    """Every sequence beam search could return (END-terminated of any length,
    or unfinished of max_len - 1 tokens; PAD may appear anywhere), scored by
    the port's full teacher-forced decoder."""
    best, best_score = None, -np.inf
    for length in range(1, BMAX):
        cands = [c for c in itertools.product(range(BV), repeat=length)
                 if not any(x == end for x in c[:-1])
                 and (c[-1] == end or length == BMAX - 1)]
        toks = np.zeros((len(cands), length + 1), np.int64)
        toks[:, 0] = 1
        toks[:, 1:] = np.asarray(cands)
        mem = torch.from_numpy(memory).expand(len(cands), 1, BD)
        logits = decoder_forward(tparams, BCFG, torch.from_numpy(toks), mem)
        logp = torch.log_softmax(logits.float(), -1).numpy()
        rows = np.arange(len(cands))[:, None]
        scores = logp[rows, np.arange(length)[None, :], np.asarray(cands)].sum(1)
        i = int(np.argmax(scores))
        if scores[i] > best_score:
            best_score, best = float(scores[i]), cands[i]
    return best, best_score


@pytest.mark.parametrize("seed", [0, 3])
def test_wide_beam_finds_global_optimum(seed):
    """With a beam as wide as the whole frontier (V² = 36 < 40), beam search
    is exhaustive: it must return the brute-force optimum."""
    pad, start, end = 0, 1, 2
    tparams = params_from_jax(jax.tree.map(
        np.asarray, init_decoder_params(jax.random.PRNGKey(seed), BJCFG)))
    memory = np.random.default_rng(seed).normal(size=(1, 1, BD)).astype(
        np.float32)
    tokens, score = tbeam.beam_generate(
        tparams, BCFG, torch.from_numpy(memory), start, end, pad, BMAX,
        beam_size=40)
    seq = [int(t) for t in tokens[0, 1:]]
    if end in seq:
        seq = seq[: seq.index(end) + 1]
    best, best_score = _brute_force_best(tparams, memory, end)
    assert abs(float(score[0]) - best_score) < 1e-3, (seq, best)
    assert tuple(seq) == best


def test_reindex_cache_matches_jax(params, memory):
    jcache = jstep.init_cache(params, JCFG, jnp.asarray(memory), max_len=8)
    tcache = tstep.init_cache(params_from_jax(params), TCFG,
                              torch.from_numpy(memory), max_len=8)
    r = np.random.default_rng(2)
    fill = [r.normal(size=(4, 8, D)).astype(np.float32) for _ in range(2 * L)]
    jcache = jcache._replace(k=tuple(jnp.asarray(a) for a in fill[:L]),
                             v=tuple(jnp.asarray(a) for a in fill[L:]))
    tcache = tcache._replace(k=[torch.from_numpy(a) for a in fill[:L]],
                             v=[torch.from_numpy(a) for a in fill[L:]])
    idx = np.array([2, 2, 0, 3], np.int64)
    ref = jstep.reindex_cache(jcache, jnp.asarray(idx))
    out = tstep.reindex_cache(tcache, torch.from_numpy(idx))
    for a, b in zip(out.k + out.v, ref.k + ref.v):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(out.cross_const.numpy(),
                               np.asarray(ref.cross_const), atol=1e-6)
    assert out.cross_const.shape == (L, 4, D)


# ----------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------
def _logit_rows():
    r = np.random.default_rng(4)
    x = (r.normal(size=(5, 40)) * 3).astype(np.float32)
    x[1, 7] = x[1, 3] = x[1].max() + 1.0        # a tie at the top
    x[2, 10:20] = x[2, 10]                      # a run of equal values
    x[3] = 0.0                                  # a flat row
    x[4, 5] = 50.0                              # one token holds all the mass
    return x


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 1, 1.0), (1.0, 5, 1.0),
    (1.3, 12, 1.0), (1.0, 0, 0.9), (1.0, 0, 0.5), (0.8, 0, 0.05),
    (0.5, 10, 0.8), (1e-8, 3, 0.95), (2.0, 40, 0.999),
])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    x = _logit_rows()
    ref = np.asarray(jsampling.filter_logits(jnp.asarray(x), temperature,
                                             top_k, top_p))
    out = tsampling.filter_logits(torch.from_numpy(x), temperature, top_k,
                                  top_p).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out > -1e29).any(axis=1).all()       # never an empty support


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_temperature_zero_is_greedy(params, memory, fused):
    tp, mem = params_from_jax(params), torch.from_numpy(memory)
    greedy, lengths = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD,
                                              MAXLEN, fused=fused)
    with _Routes(fused):
        cold, cold_len = tsampling.sample_generate(
            tp, TCFG, mem, torch.Generator().manual_seed(0), START, END, PAD,
            MAXLEN, temperature=0.0, fused=fused)
    torch.testing.assert_close(cold, greedy)
    torch.testing.assert_close(cold_len, lengths)


def test_sampling_repeats_per_seed_and_respects_its_filter(params, memory):
    tp, mem = params_from_jax(params), torch.from_numpy(memory)
    draw = lambda seed, **kw: tsampling.sample_generate(
        tp, TCFG, mem, torch.Generator().manual_seed(seed), START, END, PAD,
        MAXLEN, **kw)[0]
    a, b, c = draw(5, top_k=20, top_p=0.9), draw(5, top_k=20, top_p=0.9), \
        draw(6, top_k=20, top_p=0.9)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    # top-k 1 leaves one token in the support: greedy, whatever the seed
    greedy, _ = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD, MAXLEN)
    torch.testing.assert_close(draw(9, top_k=1), greedy)
    # the ladder changes nothing: the same seed, the same tokens
    single = tsampling.sample_generate(
        tp, TCFG, mem, torch.Generator().manual_seed(5), START, END, PAD,
        MAXLEN, top_k=20, top_p=0.9, bucket_sizes=(MAXLEN,))[0]
    torch.testing.assert_close(single, a)


def test_sampled_first_tokens_follow_the_filtered_distribution(params):
    """The first drawn token over many rows of one memory: its frequencies
    follow softmax(filter_logits(logits)), the distribution the JAX package
    draws from (4,000 draws, each frequency within 5 standard errors)."""
    n = 4000
    tp = params_from_jax(params)
    mem = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 1, D))
                           .astype(np.float32)).expand(n, 1, D)
    kw = dict(temperature=1.5, top_k=8, top_p=0.95)
    tokens, _ = tsampling.sample_generate(
        tp, TCFG, mem, torch.Generator().manual_seed(3), START, END, PAD, 3,
        **kw)
    cache = tstep.init_cache(tp, TCFG, mem[:1], max_len=3)
    logits, _ = tstep.decoder_step(tp, TCFG, torch.tensor([START]), 0, cache)
    ref = np.asarray(jax.nn.softmax(jsampling.filter_logits(
        jnp.asarray(logits.numpy()), **kw), axis=-1))[0]
    freq = np.bincount(tokens[:, 1].numpy(), minlength=V) / n
    assert (freq[ref == 0] == 0).all() and 2 <= (ref > 0).sum() <= 8
    se = np.sqrt(ref * (1 - ref) / n)
    assert (np.abs(freq - ref) <= 5 * se + 1e-12).all(), (freq, ref)


# ----------------------------------------------------------------------
# Captioner and the CLI
# ----------------------------------------------------------------------
class _Ids:
    pad_id, start_id, end_id, unk_id = PAD, START, END, 1
    unk_token = "<UNK>"

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(map(str, ids))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_captioner_methods(params, memory, fused):
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import PRESETS

    mcfg = ModelConfig("mit/tiny-vit-debug", PRESETS["mit/tiny-vit-debug"],
                       TCFG, "cls")
    cap = Captioner({"decoder": params_from_jax(params), "encoder": {}}, mcfg,
                    _Ids(), fused_decode=fused, beam_size=2)
    mem = torch.from_numpy(memory)
    tp = params_from_jax(params)
    rows = lambda toks: [t[t != PAD].tolist() for t in toks]
    with _Routes(fused):
        greedy = cap.generate_from_memory(mem, max_len=MAXLEN)
        cap.generate_from_memory(mem, max_len=MAXLEN, method="beam")
        cap.generate_from_memory(mem, max_len=MAXLEN, method="sample", top_k=10)
    assert greedy == rows(tgreedy.greedy_generate(
        tp, TCFG, mem, START, END, PAD, MAXLEN, fused=fused)[0])
    for k in (None, 3):
        beam = cap.generate_from_memory(mem, max_len=MAXLEN, method="beam",
                                        beam_size=k)
        assert beam == rows(tbeam.beam_generate(
            tp, TCFG, mem, START, END, PAD, MAXLEN, beam_size=k or 2,
            fused=fused)[0])
    gen = lambda: torch.Generator().manual_seed(11)
    s1 = cap.generate_from_memory(mem, max_len=MAXLEN, method="sample",
                                  top_k=10, generator=gen())
    s2 = cap.generate_from_memory(mem, max_len=MAXLEN, method="sample",
                                  top_k=10, generator=gen())
    assert s1 == s2 and s1 != greedy
    # no generator: seeded with 0, so repeatable
    assert (cap.generate_from_memory(mem, method="sample")
            == cap.generate_from_memory(mem, method="sample"))
    assert cap.generate_from_memory(mem, method="sample",
                                    temperature=0.0) == greedy
    with pytest.raises(ValueError, match="nucleus"):
        cap.generate_from_memory(mem, method="nucleus")
    assert all(isinstance(cap.postprocess(ids), str) for ids in greedy)


def test_cli_flags():
    """--method and --beam_size parse as in the JAX CLI; a bad method is
    refused before anything runs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "mit_tpu_torch.decode.cli", *a], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    helped = run("--help")
    assert helped.returncode == 0
    assert "--method" in helped.stdout and "--beam_size" in helped.stdout
    assert "{greedy,beam}" in helped.stdout
    bad = run("--image_path", "x.jpg", "--method", "nucleus")
    assert bad.returncode == 2 and "invalid choice" in bad.stderr
    if not torch.cuda.is_available():
        ok = run("--image_path", "x.jpg", "--method", "beam", "--beam_size", "4")
        assert ok.returncode != 0 and "CUDA is not available" in ok.stderr
