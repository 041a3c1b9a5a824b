"""Port parity: the routes and kernels mit_tpu_torch picks by shape, against
mit_tpu on the CPU.

``decoder_step(fused=True)`` on the card runs the fused layers where
``decode_layer_supported`` says the CUDA kernel takes the decoder's geometry
and the unfused layers elsewhere, as the JAX package does on a TPU; on CPU
tensors the fused layers' plain version runs at any geometry, as the JAX
package's kernel does in interpret mode (``step_route``). It counts the
route it took. The tests below put CPU tensors under the card's rule. ``multihead_attention`` never picks a route by shape: with
``use_kernel`` every shape goes to a kernel wrapper, and the wrapper picks
the tiled kernels or the any-shape kernels (``attention_kernel_for``,
``dropout_kernel_for``), which between them take what the TPU kernels take.
Here those functions are held to the wrappers' checks over a grid of
geometries, and the port to ``mit_tpu`` at geometries the tiled kernels do
not take. The JAX side runs its Pallas kernels in interpret mode; inputs
come from a numpy seed.
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
from mit_tpu.ops import attention as jattn
from mit_tpu.ops.pallas_dropout_attention import (
    dump_dropout_mask as jax_dump_mask,
    flash_attention_dropout as jax_flash_dropout,
)
from mit_tpu_torch.decode import beam as tbeam
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.ops import attention as tattn
from mit_tpu_torch.ops import decode_layer as tlayer
from mit_tpu_torch.ops import dropout_attention as tdrop
from mit_tpu_torch.ops import flash_attention as tflash
from mit_tpu_torch.ops.masks import NEG_INF

PAD, START, END = 0, 2, 3


def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except (ValueError, TypeError):
        return True
    return False


# ----------------------------------------------------------------------
# the kernel a shape gets, and the wrappers' checks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hd", [0, 8, 32, 64, 72, 80, 96, 100, 112, 120,
                                128, 136, 200, 256, 257])
def test_attention_kernel_choice_is_the_wrappers_check(hd):
    """Head width 64 and 72 to 128 in multiples of 8 get the tiled kernels,
    every other width up to 256 the any-shape kernel, and every entry
    refuses exactly the widths that get none (CPU tensors: the checks read
    shapes only). The fused layer's numerics follow the same rule: both
    kernels have them."""
    takes = tflash.attention_kernel_supported(hd)
    assert takes == (1 <= hd <= 256)
    if takes:
        tiled = hd == 64 or (64 < hd <= 128 and hd % 8 == 0)
        assert tflash.attention_kernel_for(hd) == (
            "tiled" if tiled else "any_shape")
    assert _raises(tflash.attention_kernel_for, hd) != takes
    assert _raises(tflash.attention_kernel_for, hd, True) != takes
    if takes:
        assert tflash.attention_kernel_for(hd, True) == \
            tflash.attention_kernel_for(hd)
    w = max(hd, 1)
    q = torch.zeros(2, 5, 2 * w)
    assert _raises(tflash._check_cuda_inputs, q, q, q, None, hd) != takes
    qkv = torch.zeros(2, 5, 6 * w, dtype=torch.bfloat16)
    assert _raises(tflash._check_fusedqkv, qkv, hd, False) != takes
    assert _raises(tflash._check_fusedqkv, qkv, hd, True) != takes
    if hd:
        q4 = torch.zeros(2, 2, 5, hd)
        assert _raises(tflash._check_bhtd, q4, q4, q4, None) != takes


@pytest.mark.parametrize("t,s", [(1, 1), (99, 99), (128, 128), (129, 64),
                                 (64, 129), (160, 160)])
@pytest.mark.parametrize("hd", [32, 64, 128, 300])
def test_dropout_kernel_choice_is_the_wrappers_check(hd, t, s):
    """The tiled kernels at head width 64 with at most 128 queries and keys,
    the any-shape kernels elsewhere up to width 256, and the wrappers'
    check (forward and backward) refuses exactly what gets neither."""
    takes = tdrop.dropout_kernel_supported(hd, t, s)
    assert takes == (hd <= 256)
    if takes:
        assert tdrop.dropout_kernel_for(hd, t, s) == (
            "tiled" if hd == 64 and t <= 128 and s <= 128 else "any_shape")
    assert _raises(tdrop.dropout_kernel_for, hd, t, s) != takes
    q, k = torch.zeros(1, 2, t, hd), torch.zeros(1, 2, s, hd)
    pad = torch.zeros(1, s)
    assert _raises(tdrop._check_cuda_inputs, q, k, k, pad) != takes
    assert _raises(tdrop._check_cuda_inputs, q, k, k, pad, q) != takes


@pytest.mark.parametrize("t,s", [(1, 1), (99, 99), (128, 128), (129, 64)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dropout_backward_kernel_follows_the_shape_and_dtype(dtype, hd, t, s):
    """At the tiled shapes a bf16 backward runs the tensor-core kernel and
    an f32 one the CUDA-core kernel; elsewhere both run the any-shape
    kernels."""
    want = ("any_shape" if tdrop.dropout_kernel_for(hd, t, s) == "any_shape"
            else "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    assert tdrop.dropout_bwd_kernel_for(dtype, hd, t, s) == want
    assert set(tdrop.flash_attention_dropout_bwd.kernels) == {
        "tensor_cores", "cuda_cores", "any_shape"}


@pytest.mark.parametrize("d,heads,f", [(512, 8, 2048), (512, 8, 256),
                                       (512, 8, 100), (512, 4, 2048),
                                       (256, 4, 1024), (128, 2, 256),
                                       (1024, 16, 4096)])
def test_decode_layer_predicate_is_the_wrappers_check(d, heads, f):
    takes = tlayer.decode_layer_supported(d, heads, f)
    assert takes == (d == 512 and heads == 8 and f % 8 == 0)
    b, t = 2, 4
    z = torch.zeros
    lay = {"wqkv": z(1, d, 3 * d), "bqkv": z(1, 3 * d), "wo": z(1, d, d),
           "bo": z(1, d), "w1": z(1, d, f), "b1": z(1, f), "w2": z(1, f, d),
           "b2": z(1, d)}
    lay.update({f"ln{i}": {"scale": z(1, d), "bias": z(1, d)}
                for i in (1, 2, 3)})
    packed = tlayer.pack_decode_layers(lay)
    args = (z(b, d), z(b, dtype=torch.int32), z(b, t), z(b, t, d), z(b, t, d),
            z(b, d), packed, heads)
    assert _raises(tlayer._check_cuda_inputs, *args) != takes


# ----------------------------------------------------------------------
# decoder_step(fused=True)
# ----------------------------------------------------------------------
def _decoder(d, heads, layers=2, f=96, v=70, maxlen=24, seed=5):
    kw = dict(vocab_size=v, embed_dim=d, num_heads=heads, num_layers=layers,
              ff_dim=f, max_seq_len=maxlen, dropout=0.0, pad_idx=PAD)
    jcfg, tcfg = JDecoderConfig(**kw), DecoderConfig(**kw)
    params = jax.tree.map(np.asarray,
                          init_decoder_params(jax.random.PRNGKey(seed), jcfg))
    mem = (np.random.default_rng(7).normal(size=(3, 1, d)) * 0.5).astype(
        np.float32)
    return jcfg, tcfg, params, mem


def _routes():
    return dict(tstep.decoder_step.routes)


@pytest.fixture
def card_rule(monkeypatch):
    """``decoder_step`` picks its route as it does for CUDA tensors."""
    rule = tstep.step_route
    monkeypatch.setattr(
        tstep, "step_route",
        lambda fused, device_type, cfg, cls_memory=True:
            rule(fused, "cuda", cfg, cls_memory))


@pytest.mark.parametrize("d,heads,f", [(512, 8, 2048), (512, 8, 100),
                                       (512, 4, 2048), (256, 4, 1024),
                                       (128, 2, 256)])
def test_step_route_is_the_jax_rule(d, heads, f):
    """Asked to fuse: on the card by what the kernel takes, off it always;
    not asked: never."""
    cfg = DecoderConfig(vocab_size=50, embed_dim=d, num_heads=heads,
                        num_layers=1, ff_dim=f, max_seq_len=8)
    takes = tlayer.decode_layer_supported(d, heads, f)
    assert tstep.step_route(True, "cuda", cfg) == (
        "fused" if takes else "unfused")
    assert tstep.step_route(True, "cpu", cfg) == "fused"
    assert tstep.step_route(False, "cuda", cfg) == "unfused"
    assert tstep.step_route(False, "cpu", cfg) == "unfused"


@pytest.mark.parametrize("d,heads,route", [(256, 4, "unfused"),
                                           (512, 8, "fused"),
                                           (512, 4, "unfused")])
def test_fused_step_takes_the_route_its_geometry_allows(card_rule, d, heads,
                                                        route):
    """One step after a three-token prefix, f32, under the card's rule:
    ``fused=True`` gives the logits of the port's unfused step and of the
    JAX package's fused step (within 1e-5: the same f32 operations summed in
    another order), on the fused route at 512 wide in 8 heads and on the
    unfused one elsewhere."""
    jcfg, tcfg, params, mem = _decoder(d, heads)
    jp = jstep.prepare_decode_params(params, jnp.float32)
    tp = tstep.prepare_decode_params(params_from_jax(params), fused=True)
    jcache = jstep.init_cache(params, jcfg, jnp.asarray(mem), max_len=16)
    tcache = tstep.init_cache(params_from_jax(params), tcfg,
                              torch.from_numpy(mem), max_len=16)
    for p in range(3):
        tok = (np.arange(3) % 5 + 4 + p).astype(np.int64)
        _, jcache = jstep.decoder_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                       jnp.asarray(p, jnp.int32), jcache)
        _, tcache = tstep.decoder_step(tp, tcfg, torch.from_numpy(tok), p,
                                       tcache)
    tok = (np.arange(3) % 7 + 4).astype(np.int64)
    os.environ["MIT_FUSED_DECODE"] = "1"
    try:
        ref, _ = jstep.decoder_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(3, jnp.int32), jcache)
    finally:
        os.environ.pop("MIT_FUSED_DECODE", None)
    copy = lambda c: c._replace(k=[a.clone() for a in c.k],
                                v=[a.clone() for a in c.v])
    unfused, _ = tstep.decoder_step(tp, tcfg, torch.from_numpy(tok), 3,
                                    copy(tcache))
    before = _routes()
    out, _ = tstep.decoder_step(tp, tcfg, torch.from_numpy(tok), 3,
                                copy(tcache), fused=True)
    after = _routes()
    other = "fused" if route == "unfused" else "unfused"
    assert after[route] == before[route] + 1 and after[other] == before[other]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5)
    if route == "unfused":
        # the very same computation, with per-row positions too
        torch.testing.assert_close(out, unfused, rtol=0, atol=0)
        rows, _ = tstep.decoder_step(tp, tcfg, torch.from_numpy(tok),
                                     torch.full((3,), 3, dtype=torch.int32),
                                     copy(tcache), fused=True)
        torch.testing.assert_close(rows, unfused, rtol=0, atol=0)


@pytest.mark.parametrize("d,heads,route", [(256, 4, "unfused"),
                                           (512, 8, "fused")])
def test_fused_generation_tokens_at_both_geometries(card_rule, d, heads, route):
    """Greedy and beam K = 2 with ``fused=True``, f32, under the card's
    rule: the tokens of the
    unfused route and, for greedy, of the JAX package; every step counted on
    the route the geometry allows."""
    jcfg, tcfg, params, mem = _decoder(d, heads, layers=1, maxlen=12)
    ref, _ = jgreedy.greedy_generate(params, jcfg, jnp.asarray(mem), START,
                                     END, PAD, 12)
    tp, tmem = params_from_jax(params), torch.from_numpy(mem)
    unfused, _ = tgreedy.greedy_generate(tp, tcfg, tmem, START, END, PAD, 12)
    before = _routes()
    fused, _ = tgreedy.greedy_generate(tp, tcfg, tmem, START, END, PAD, 12,
                                       fused=True)
    after = _routes()
    other = "fused" if route == "unfused" else "unfused"
    assert after[route] > before[route] and after[other] == before[other]
    np.testing.assert_array_equal(fused.numpy(), unfused.numpy())
    np.testing.assert_array_equal(fused.numpy(), np.asarray(ref))
    beam_u, score_u = tbeam.beam_generate(tp, tcfg, tmem, START, END, PAD, 12,
                                          beam_size=2)
    before = _routes()
    beam_f, score_f = tbeam.beam_generate(tp, tcfg, tmem, START, END, PAD, 12,
                                          beam_size=2, fused=True)
    after = _routes()
    assert after[route] > before[route] and after[other] == before[other]
    np.testing.assert_array_equal(beam_f.numpy(), beam_u.numpy())
    np.testing.assert_allclose(score_f.numpy(), score_u.numpy(), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# multihead_attention
# ----------------------------------------------------------------------
def _attn_params(r, d):
    keys = ("wq", "wk", "wv", "wo")
    p = {w: r.normal(size=(d, d)).astype(np.float32) * 0.1 for w in keys}
    p.update({"b" + w[1]: r.normal(size=(d,)).astype(np.float32) * 0.1
              for w in keys})
    return p


def _attn_routes():
    return dict(tattn.multihead_attention.routes)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [128, 64, 32])
def test_multihead_attention_asks_for_a_kernel_at_every_head_width(hd, causal):
    """``use_kernel=True`` goes to the kernel's wrapper at any head width
    (on CPU tensors the wrapper runs its plain version and counts no
    launch) and gives the JAX package's kernel path (f32, 1e-5); the route
    follows the arguments, never the shape."""
    heads, b, t = 2, 3, 11
    d = heads * hd
    r = np.random.default_rng(1)
    p = _attn_params(r, d)
    x = r.normal(size=(b, t, d)).astype(np.float32)
    pad = np.where(r.random((b, t)) > 0.7, NEG_INF, 0.0).astype(np.float32)
    ref = jattn.multihead_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
        jnp.asarray(x), heads, use_flash=True, causal=causal,
        pad_add=jnp.asarray(pad))
    before = _attn_routes()
    launches = tflash.flash_attention_btd.launches
    xt = torch.from_numpy(x)
    out = tattn.multihead_attention(
        params_from_jax(p), xt, xt, heads, use_kernel=True, causal=causal,
        pad_add=torch.from_numpy(pad))
    after = _attn_routes()
    assert after == {"kernel": before["kernel"] + 1, "plain": before["plain"]}
    assert tflash.flash_attention_btd.launches == launches     # CPU tensors
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # a call that asks for no kernel takes the plain path, and says so
    plain = tattn.multihead_attention(params_from_jax(p), xt, xt, heads,
                                      use_kernel=False, causal=causal,
                                      pad_add=torch.from_numpy(pad))
    assert _attn_routes() == {"kernel": after["kernel"],
                              "plain": after["plain"] + 1}
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("t,hd", [(160, 64), (99, 64), (24, 32)])
def test_fused_dropout_asks_for_a_kernel_past_the_tiled_shapes(t, hd):
    """The fused-dropout route at T = S above 128, or at another head width,
    still goes to ``flash_attention_dropout``: the hash mask is bit for bit
    the JAX kernels' (``dump_dropout_mask``), and the output the JAX
    kernel's from the same projections and seed (f32, 1e-5)."""
    heads, b, rate, seed0 = 2, 2, 0.25, 17
    d = heads * hd
    r = np.random.default_rng(2)
    p = _attn_params(r, d)
    x = r.normal(size=(b, t, d)).astype(np.float32)
    pad = np.where(r.random((b, t)) > 0.8, NEG_INF, 0.0).astype(np.float32)
    tp, xt = params_from_jax(p), torch.from_numpy(x)
    gens = tattn.DropoutGenerators.for_step(seed0, 3, "cpu")
    before = _attn_routes()
    out = tattn.multihead_attention(
        tp, xt, xt, heads, use_kernel=True, causal=True,
        pad_add=torch.from_numpy(pad), dropout_rate=rate, generator=gens,
        deterministic=False, fused_dropout=True)
    assert _attn_routes() == {"kernel": before["kernel"] + 1,
                              "plain": before["plain"]}

    # the seed the call drew, and the JAX kernel on the same projections
    seed = int(torch.randint(
        0, 2**31 - 1, (),
        generator=tattn.DropoutGenerators.for_step(seed0, 3, "cpu").host))
    mask = tdrop.dump_dropout_mask(b, heads, t, t, seed, rate)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_dump_mask(b, heads, t, t, seed=seed,
                                               rate=rate)))
    split = lambda a: jnp.asarray(a).reshape(b, t, heads, hd).transpose(
        0, 2, 1, 3)
    q, k, v = (x @ p[w] + p["b" + w[1]] for w in ("wq", "wk", "wv"))
    ctx = jax_flash_dropout(split(q), split(k), split(v), jnp.asarray(pad),
                            jnp.int32(seed), True, rate)
    ref = np.asarray(ctx).transpose(0, 2, 1, 3).reshape(b, t, d) @ p["wo"] \
        + p["bo"]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
