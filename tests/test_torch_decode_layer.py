"""Port parity: the fused decode layer and the fused decode step of
mit_tpu_torch against mit_tpu on the CPU.

The JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas_decode.py does (``interpret=True``, or the step under
``MIT_FUSED_DECODE=1`` set and cleared around the call); the port's wrapper
runs its plain PyTorch version for CPU tensors. Inputs come from a numpy
seed and go through both frameworks as numpy arrays. Head width 64 as on
the card, everything else small.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import greedy as jgreedy
from mit_tpu.decode import step as jstep
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu.ops.pallas_decode_layer import fused_decode_layer as jax_fused_layer
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.ops.decode_layer import (
    PackedDecodeLayers,
    fused_decode_layer,
    fused_decode_layer_plain,
    pack_decode_layers,
)
from mit_tpu_torch.ops.masks import NEG_INF

V, D, H, L, F, T, B, MAXLEN = 90, 128, 2, 3, 256, 16, 3, 24
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)
JCFG, TCFG = JDecoderConfig(**KW), DecoderConfig(**KW)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# x' / fresh rows: the JAX package's own bounds between its kernel and its step
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (0.05, 0.05)}


@pytest.fixture(scope="module")
def params():
    p = init_decoder_params(jax.random.PRNGKey(5), JCFG)
    r = np.random.default_rng(11)
    p = jax.tree.map(np.asarray, p)
    # biases and LayerNorm parameters off their init values (0 and 1)
    for name in ("ln1", "ln2", "ln3"):
        p["layers"][name] = {
            "scale": (1 + 0.1 * r.normal(size=(L, D))).astype(np.float32),
            "bias": (0.1 * r.normal(size=(L, D))).astype(np.float32)}
    for grp, keys in (("self", ("bq", "bk", "bv", "bo")), ("ffn", ("b1", "b2"))):
        for k in keys:
            shape = p["layers"][grp][k].shape
            p["layers"][grp][k] = (0.1 * r.normal(size=shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def memory():
    return (np.random.default_rng(7).normal(size=(B, 1, D)) * 0.5).astype(
        np.float32)


def _layer_inputs(dtype, per_row):
    """x, pos, madd, caches and cross for one layer call: positions up to
    pos visible, two PAD keys masked, batch row 1 fully masked."""
    r = np.random.default_rng(3)
    x = r.normal(size=(B, D)).astype(np.float32)
    kc, vc = (r.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
    cross = r.normal(size=(B, D)).astype(np.float32)
    pos = np.array([5, 9, 2], np.int32) if per_row else np.int32(6)
    visible = np.arange(T)[None, :] <= np.broadcast_to(pos, (B,))[:, None]
    visible[0, 1] = False
    visible[2, 0] = False
    madd = np.where(visible, 0.0, NEG_INF).astype(np.float32)
    madd[1] = NEG_INF
    return x, pos, madd, kc, vc, cross


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "row_pos"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_plain_matches_jax_kernel(params, dtype, per_row):
    x, pos, madd, kc, vc, cross = _layer_inputs(dtype, per_row)
    jlay = jstep.prepare_decode_params(params, JDT[dtype])["layers"]
    tlay = tstep.prepare_decode_params(params_from_jax(params),
                                       TDT[dtype])["layers"]
    xtol, rtol = TOL[dtype]
    for l in range(L):
        ref = jax_fused_layer(
            jnp.asarray(x, JDT[dtype]), jnp.asarray(pos), jnp.asarray(madd),
            jnp.asarray(kc, JDT[dtype]), jnp.asarray(vc, JDT[dtype]),
            jnp.asarray(cross), jlay, l, H, interpret=True)
        tpos = torch.from_numpy(pos) if per_row else int(pos)
        cast = lambda a: torch.from_numpy(a).to(TDT[dtype])
        out = fused_decode_layer(cast(x), tpos, torch.from_numpy(madd),
                                 cast(kc), cast(vc), torch.from_numpy(cross),
                                 tlay, l, H)
        for name, o, r, tol in zip(("x", "k_new", "v_new"), out, ref,
                                   (xtol, rtol, rtol)):
            assert o.dtype == TDT[dtype] and o.shape == (B, D)
            got = o.float().numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(
                got, np.asarray(r.astype(jnp.float32)), rtol=tol, atol=tol,
                err_msg=f"layer {l} {name}")


def test_fused_layer_wrapper_and_write_cache(params):
    """CPU tensors take the plain version (no launch counted); a packed and
    a stacked `lay` agree; write_cache puts the fresh rows at pos and
    nowhere else, and skips a position outside the cache."""
    x, _, madd, kc, vc, cross = _layer_inputs("float32", True)
    pos = torch.tensor([5, 9, T + 3], dtype=torch.int32)
    lay = tstep.prepare_decode_params(params_from_jax(params))["layers"]
    packed = pack_decode_layers(lay)
    assert isinstance(packed, PackedDecodeLayers) and packed.ff_dim == F
    assert all(w["bqkv"].dtype == torch.float32 for w in packed.layers)
    args = [torch.from_numpy(a) for a in (x,)] + [pos] + [
        torch.from_numpy(a) for a in (madd, kc, vc, cross)]
    before = fused_decode_layer.launches
    plain = fused_decode_layer_plain(*args, lay, 1, H)
    out = fused_decode_layer(*args, packed, 1, H)
    assert fused_decode_layer.launches == before
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    k2, v2 = args[3].clone(), args[4].clone()
    wrote = fused_decode_layer(args[0], pos, args[2], k2, v2, args[5], packed,
                               1, H, write_cache=True)
    for a, b in zip(wrote, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for cache, old, new in ((k2, args[3], plain[1]), (v2, args[4], plain[2])):
        for b in range(B):
            changed = (cache[b] != old[b]).any(-1).nonzero().flatten().tolist()
            assert changed == ([int(pos[b])] if pos[b] < T else [])
            if pos[b] < T:
                torch.testing.assert_close(cache[b, pos[b]], new[b])
    bad = dict(lay, wo=lay["wo"][:, :, :-1])
    with pytest.raises(ValueError, match="wo"):
        pack_decode_layers(bad)


def _prefilled(params, memory, dtype, steps=3):
    """Both packages' caches after `steps` unfused steps on the same tokens."""
    jp = jstep.prepare_decode_params(params, JDT[dtype])
    tp = tstep.prepare_decode_params(params_from_jax(params), TDT[dtype],
                                     fused=True)
    jcache = jstep.init_cache(params, JCFG, jnp.asarray(memory), max_len=T,
                              compute_dtype=JDT[dtype])
    tcache = tstep.init_cache(params_from_jax(params), TCFG,
                              torch.from_numpy(memory), max_len=T,
                              compute_dtype=TDT[dtype])
    for p in range(steps):
        seed = (np.arange(B) % 5 + 4 + p).astype(np.int64)
        _, jcache = jstep.decoder_step(jp, JCFG, jnp.asarray(seed, jnp.int32),
                                       jnp.asarray(p, jnp.int32), jcache,
                                       JDT[dtype])
        _, tcache = tstep.decoder_step(tp, TCFG, torch.from_numpy(seed), p,
                                       tcache, TDT[dtype])
    return jp, tp, jcache, tcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_matches_jax_fused_step(params, memory, dtype):
    steps = 3
    jp, tp, jcache, tcache = _prefilled(params, memory, dtype, steps)
    tokens = (np.arange(B) % 7 + 4).astype(np.int64)
    key_pad = np.zeros((B, T), bool)
    key_pad[0, 1] = key_pad[2, 0] = True
    os.environ["MIT_FUSED_DECODE"] = "1"
    try:
        ref, jcache = jstep.decoder_step(
            jp, JCFG, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(steps, jnp.int32), jcache, JDT[dtype],
            key_pad=jnp.asarray(key_pad))
    finally:
        os.environ.pop("MIT_FUSED_DECODE", None)
    unfused, _ = tstep.decoder_step(
        tp, TCFG, torch.from_numpy(tokens), steps,
        tcache._replace(k=[a.clone() for a in tcache.k],
                        v=[a.clone() for a in tcache.v]),
        TDT[dtype], key_pad=torch.from_numpy(key_pad))
    out, tcache = tstep.decoder_step(
        tp, TCFG, torch.from_numpy(tokens), steps, tcache, TDT[dtype],
        key_pad=torch.from_numpy(key_pad), fused=True)
    tol = 1e-5 if dtype == "float32" else 0.05
    assert out.dtype == torch.float32 and out.shape == (B, V)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), unfused.numpy(), rtol=tol,
                               atol=tol)
    row_tol = TOL[dtype][1]
    for mine, theirs in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                rtol=row_tol, atol=row_tol)


def test_fused_step_takes_per_row_positions(params, memory):
    """A (B,) position tensor equal to a scalar gives the scalar's logits;
    the unfused route refuses per-row positions."""
    _, tp, _, tcache = _prefilled(params, memory, "float32")
    tokens = torch.from_numpy((np.arange(B) % 7 + 4).astype(np.int64))
    copy = lambda c: c._replace(k=[a.clone() for a in c.k],
                                v=[a.clone() for a in c.v])
    scalar, c1 = tstep.decoder_step(tp, TCFG, tokens, 3, copy(tcache),
                                    fused=True)
    rows, c2 = tstep.decoder_step(
        tp, TCFG, tokens, torch.full((B,), 3, dtype=torch.int32),
        copy(tcache), fused=True)
    torch.testing.assert_close(rows, scalar, rtol=0, atol=0)
    for a, b in zip(c1.k + c1.v, c2.k + c2.v):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(TypeError, match="fused"):
        tstep.decoder_step(tp, TCFG, tokens,
                           torch.full((B,), 3, dtype=torch.int32), tcache)


def _rigged(params, token, bias):
    p = dict(params)
    b = np.zeros((V,), np.float32)
    b[token] = bias
    p["fc_out_b"] = b
    return p


@pytest.mark.parametrize("case", ["ladder", "forced_pad"])
def test_fused_greedy_tokens_identical(params, memory, case):
    """f32 greedy tokens: the port's fused route, its unfused route and the
    JAX package's agree, across a bucket crossing and generated PADs."""
    p = params if case == "ladder" else _rigged(params, PAD, 0.6)
    ref, ref_len = jgreedy.greedy_generate(p, JCFG, jnp.asarray(memory), START,
                                           END, PAD, MAXLEN)
    tp, mem = params_from_jax(p), torch.from_numpy(memory)
    unfused, _ = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD, MAXLEN)
    fused, fused_len = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD,
                                               MAXLEN, fused=True)
    np.testing.assert_array_equal(fused.numpy(), unfused.numpy())
    np.testing.assert_array_equal(fused.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(fused_len.numpy(), np.asarray(ref_len))
    assert (fused[:, 17:] != PAD).any()          # ran past the first bucket
    if case == "forced_pad":                     # a PAD, then more tokens
        assert any((row[1:9] == PAD).any() and (row[9:] != PAD).any()
                   for row in fused)
