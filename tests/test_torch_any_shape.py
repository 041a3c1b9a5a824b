"""The any-shape attention kernels' walks, replayed on the CPU.

``csrc/attention_any_shape.cu`` cannot run here, but its control flow can be
mirrored: the keys walked in tiles of 32, a lane to a key, each lane an
online (max, sum) that is merged across the warp, a second walk for the
probabilities; and a backward in two kernels, the first leaving each row's
max, sum and delta for the second, which reduces dk and dv over the rows 32
at a time. The replay below does those steps in PyTorch in the kernel's order
and is held to the port's plain versions and to the JAX kernels (interpret
mode) at head widths other than 64 and, with dropout, past 128 tokens: the
shapes ``attention_kernel_for`` and ``dropout_kernel_for`` send there.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.ops.pallas_attention import flash_attention as jax_flash
from mit_tpu.ops.pallas_attention import flash_attention_btd as jax_flash_btd
from mit_tpu.ops.pallas_dropout_attention import (
    flash_attention_dropout as jax_flash_dropout,
)
from mit_tpu_torch.ops import dropout_attention as tdrop
from mit_tpu_torch.ops import flash_attention as tflash
from mit_tpu_torch.ops.masks import NEG_INF

LANES = 32
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(b, h, t, s, hd, dtype, seed=0):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    q, do = to(r.normal(size=(b, h, t, hd))), to(r.normal(size=(b, h, t, hd)))
    k = to(r.normal(size=(b, h, s, hd)))
    v = to(r.uniform(-1, 1, size=(b, h, s, hd)))
    pad = np.where(r.random((b, s)) > 0.8, NEG_INF, 0.0).astype(np.float32)
    pad[0] = NEG_INF                 # batch row 0: every key padded
    pad[1, 0] = NEG_INF              # row 0 of batch row 1 sees a pad only
    return q, k, v, torch.from_numpy(pad), do


def _scores(q, k, pad, causal, cols):
    """masked_score of every query row against the keys `cols`, in the
    kernel's order: product, scale, causal, pad."""
    t, hd = q.shape[2], q.shape[3]
    x = torch.einsum("bhtd,bhsd->bhts", q.float(), k[:, :, cols].float())
    x = x * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    if causal:
        rows = torch.arange(t)[:, None]
        x = x + torch.where(cols[None, :] <= rows, 0.0, NEG_INF)
    if pad is not None:
        x = x + pad[:, None, None, cols]
    return x


def _row_max_sum(q, k, pad, causal):
    """walk_max_sum: lane j owns keys j, j + 32, ...; an online max and sum a
    lane, merged over the 32 lanes."""
    b, h, t, _ = q.shape
    s = k.shape[2]
    m = torch.full((b, h, t, LANES), -math.inf)
    l = torch.zeros(b, h, t, LANES)
    for c0 in range(0, s, LANES):
        cols = torch.arange(c0, min(c0 + LANES, s))
        n = len(cols)
        x = _scores(q, k, pad, causal, cols)
        mn = torch.maximum(m[..., :n], x)
        l[..., :n] = l[..., :n] * torch.exp(m[..., :n] - mn) + torch.exp(x - mn)
        m[..., :n] = mn
    big = m.amax(-1, keepdim=True)
    share = torch.where(m == -math.inf, torch.zeros(()), l * torch.exp(m - big))
    return big, share.sum(-1, keepdim=True)


def replay_forward(q, k, v, pad, causal, mode, seed=0, rate=0.0):
    """attention_rows_kernel. mode: "divide_after" (the (B, T, D) entries),
    "norm_first" ((B, H, T, hd)) or "dropout"."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    big, total = _row_max_sum(q, k, pad, causal)
    keep = tdrop._cells_mask(b, h, t, s, seed, rate, "cpu")
    o = torch.zeros(b, h, t, hd)
    for c0 in range(0, s, LANES):
        cols = torch.arange(c0, min(c0 + LANES, s))
        p = torch.exp(_scores(q, k, pad, causal, cols) - big)
        if mode != "divide_after":
            p = p / total
        if mode == "dropout":
            p = torch.where(keep[..., cols],
                            p / torch.tensor(1.0 - rate, dtype=torch.float32),
                            0.0)
        o = o + torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(),
                             v[:, :, cols].float())
    if mode == "divide_after":
        o = o / total
    return o.to(q.dtype)


def replay_backward(q, k, v, pad, do, causal, seed, rate):
    """dropout_bwd_rows_kernel, then dropout_bwd_keys_kernel from its
    (max, sum, delta) workspace."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    keep = tdrop._cells_mask(b, h, t, s, seed, rate, "cpu")
    big, total = _row_max_sum(q, k, pad, causal)

    def p_dp(rows, cols):
        x = _scores(q[:, :, rows], k, pad, False, cols)
        if causal:
            x = _scores(q, k, pad, True, cols)[:, :, rows]
        p = torch.exp(x - big[:, :, rows]) / total[:, :, rows]
        dpd = torch.einsum("bhtd,bhsd->bhts", do[:, :, rows].float(),
                           v[:, :, cols].float())
        kept = keep[:, :, rows][..., cols]
        return p, torch.where(kept, dpd * inv, 0.0), kept

    every_row, every_col = torch.arange(t), torch.arange(s)
    delta = torch.zeros(b, h, t, 1)
    for c0 in range(0, s, LANES):
        p, dp, _ = p_dp(every_row, every_col[c0:c0 + LANES])
        delta = delta + (dp * p).sum(-1, keepdim=True)
    dq = torch.zeros(b, h, t, hd)
    for c0 in range(0, s, LANES):
        cols = every_col[c0:c0 + LANES]
        p, dp, _ = p_dp(every_row, cols)
        dq = dq + torch.einsum("bhts,bhsd->bhtd", p * (dp - delta),
                               k[:, :, cols].float())
    dk, dv = torch.zeros(b, h, s, hd), torch.zeros(b, h, s, hd)
    for r0 in range(0, t, LANES):
        rows = every_row[r0:r0 + LANES]
        p, dp, kept = p_dp(rows, every_col)
        ds = p * (dp - delta[:, :, rows])
        pd = torch.where(kept, p * inv, 0.0)
        dv = dv + torch.einsum("bhts,bhtd->bhsd", pd, do[:, :, rows].float())
        dk = dk + torch.einsum("bhts,bhtd->bhsd", ds, q[:, :, rows].float())
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


SHAPES = [(3, 2, 40, 70, 32), (3, 2, 33, 31, 136), (2, 3, 5, 5, 16),
          (2, 1, 9, 130, 100), (2, 2, 17, 23, 200)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,hd", SHAPES)
def test_any_shape_walk_matches_plain_and_jax(b, h, t, s, hd, dtype, causal):
    """Both numerics of the walk without dropout, at head widths that get
    the any-shape kernel: against the port's plain versions and the JAX
    kernels, a fully padded batch row finite and uniform."""
    assert tflash.attention_kernel_for(hd) == "any_shape"
    q, k, v, pad, _ = _inputs(b, h, t, s, hd, dtype)
    tol = TOL[dtype]
    out = replay_forward(q, k, v, pad, causal, "norm_first")
    ref = tflash.flash_attention_reference(q, k, v, pad, causal)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    jx = lambda a: jnp.asarray(a.float().numpy(), JDT[dtype])
    theirs = jax_flash(jx(q), jx(k), jx(v), jnp.asarray(pad.numpy()), causal)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)),
                               rtol=0, atol=tol)
    want = torch.stack([v[0, :, :min(i + 1, s) if causal else s].float().mean(1)
                        for i in range(t)], 1)
    assert (out[0].float() - want).abs().max().item() <= tol

    merge = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], h * hd)
    out = merge(replay_forward(q, k, v, pad, causal, "divide_after"))
    ref = tflash.flash_attention_btd_reference(merge(q), merge(k), merge(v),
                                               pad, causal, hd)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    theirs = jax_flash_btd(jx(merge(q)), jx(merge(k)), jx(merge(v)),
                           jnp.asarray(pad.numpy()), causal, hd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)),
                               rtol=0, atol=tol)


DROPOUT_SHAPES = [(2, 2, 160, 160, 64), (2, 2, 129, 40, 64),
                  (3, 2, 40, 70, 128), (2, 3, 33, 31, 32)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,t,s,hd", DROPOUT_SHAPES)
def test_any_shape_dropout_walks_match_plain_and_jax(b, h, t, s, hd, causal):
    """The dropout forward and the two-kernel backward, f32, past the tiled
    kernels' shapes: against the port's plain versions and against the JAX
    kernels' output and gradients (1e-5; gradients over their largest
    value)."""
    assert tdrop.dropout_kernel_for(hd, t, s) == "any_shape"
    q, k, v, pad, do = _inputs(b, h, t, s, hd, torch.float32, seed=4)
    seed, rate = 4321, 0.2
    out = replay_forward(q, k, v, pad, causal, "dropout", seed, rate)
    ref = tdrop.flash_attention_dropout_reference(q, k, v, pad, seed, causal,
                                                  rate)
    assert (out - ref).abs().max().item() <= 1e-5
    grads = replay_backward(q, k, v, pad, do, causal, seed, rate)
    want = tdrop.flash_attention_dropout_reference_backward(
        q, k, v, pad, do, seed, causal, rate)
    jx = lambda a: jnp.asarray(a.numpy())
    theirs, vjp = jax.vjp(
        lambda a, b_, c: jax_flash_dropout(a, b_, c, jx(pad), jnp.int32(seed),
                                           causal, rate), jx(q), jx(k), jx(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-5)
    for g, w, j in zip(grads, want, vjp(jx(do))):
        scale = max(w.abs().max().item(), 1e-30)
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() / scale <= 1e-5
        assert np.abs(g.numpy() - np.asarray(j)).max() / scale <= 1e-5


def test_any_shape_dropout_walk_bf16_matches_plain():
    """bf16 inputs: the forward within one rounding of the output (2e-2),
    the gradients within 1e-2 of their largest value."""
    q, k, v, pad, do = _inputs(2, 2, 150, 150, 64, torch.bfloat16, seed=6)
    out = replay_forward(q, k, v, pad, True, "dropout", 7, 0.1)
    ref = tdrop.flash_attention_dropout_reference(q, k, v, pad, 7, True, 0.1)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    grads = replay_backward(q, k, v, pad, do, True, 7, 0.1)
    want = tdrop.flash_attention_dropout_reference_backward(
        q, k, v, pad, do, 7, True, 0.1)
    for g, w in zip(grads, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err / w.float().abs().max().item() <= 1e-2


# ----------------------------------------------------------------------
# the fused int8 layer's numerics (fused qkv, bf16 in, f32 out)
# ----------------------------------------------------------------------
def replay_layer(qkv, hd):
    """attention_rows_kernel in the layer mode over a fused (B, T, 3D) bf16
    qkv: scores scaled by log2(e)/sqrt(hd), a first walk for the exact max
    alone, then p = exp2(s - max) a tile of 32 keys at a time, each lane's
    sum of p in f32 (merged over the warp at the end), p rounded to bf16 for
    P.V, and out = o * (1 / rowsum)."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    h = d // hd
    split = lambda x: x.reshape(b, t, h, hd).transpose(1, 2).float()
    q, k, v = (split(x) for x in qkv.split(d, dim=-1))
    scale = torch.tensor(tflash.LOG2E / math.sqrt(hd), dtype=torch.float32)
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    big = s.amax(-1, keepdim=True)
    lanes = torch.zeros(b, h, t, LANES)
    o = torch.zeros(b, h, t, hd)
    for c0 in range(0, t, LANES):
        cols = slice(c0, min(c0 + LANES, t))
        p = torch.exp2(s[..., cols] - big)
        lanes[..., :p.shape[-1]] += p
        o = o + torch.einsum("bhts,bhsd->bhtd",
                             p.to(torch.bfloat16).float(), v[:, :, cols])
    o = o * (1.0 / lanes.sum(-1, keepdim=True))
    return o.transpose(1, 2).reshape(b, t, d)


@pytest.mark.parametrize("b,t,hd", [(2, 40, 32), (3, 33, 136), (2, 70, 100),
                                    (1, 5, 256)])
def test_any_shape_layer_walk_matches_plain(b, t, hd):
    """The layer mode runs on the any-shape kernel at every head width but
    64: the walk against the port's plain version, f32 out."""
    assert tflash.attention_kernel_for(hd, layer_numerics=True) == "any_shape"
    qkv = torch.from_numpy(np.random.default_rng(hd).normal(
        size=(b, t, 3 * 2 * hd)).astype(np.float32)).to(torch.bfloat16)
    out = replay_layer(qkv, hd)
    ref = tflash.flash_attention_btd_fusedqkv_reference(qkv, hd, True)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.fixture(scope="module")
def int8_layer128():
    """One quantized ViT layer at d = 128, F = 256, in both packages (the
    weights do not depend on the number of heads)."""
    from mit_tpu.models import vision as jvis
    from mit_tpu_torch.models.convert import layer_params, params_from_jax

    jcfg = jvis.VisionConfig(
        family="vit", image_size=32, patch_size=8, hidden_size=128,
        num_layers=1, num_heads=2, intermediate_size=256, hidden_act="gelu",
        layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
    params = jax.tree.map(
        np.asarray, jvis.init_vision_params(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + r.normal(size=a.shape).astype(np.float32) * 0.05, params)
    q8 = jax.tree.map(np.asarray, jvis.quantize_vision_params(params, jcfg))
    jl = jax.tree.map(lambda a: a[0], q8["layers"])
    tl = layer_params(params_from_jax(q8)["layers"], 0)
    pick = lambda lay: (lay["ln1"], lay["attn"]["qkv"], lay["attn"]["o"],
                        lay["ln2"], lay["fc1"], lay["fc2"])
    return pick(jl), pick(tl)


@pytest.mark.parametrize("heads", [4, 1], ids=["hd32", "hd128"])
def test_fused_int8_vit_layer_any_head_width_matches_jax(int8_layer128, heads):
    """The fused int8 layer at head widths 32 and 128 (on the card the
    any-shape kernel runs the attention at 32, the tiled kernel at 128): the
    port's layer, and the same layer
    with the kernel's walk replayed for its attention, against the JAX
    layer kernel (interpret mode), within the JAX package's own bound
    between its layer kernel and its composition."""
    from mit_tpu.ops import pallas_int8_layer as jlayer
    from mit_tpu_torch.ops import int8_layer as tlayer
    from mit_tpu_torch.ops import int8_mlp as tmlp

    jargs, targs = int8_layer128
    x = np.random.default_rng(heads).normal(size=(2, 17, 128)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jlayer.fused_int8_vit_layer(
        jnp.asarray(x, jnp.bfloat16), *jargs, num_heads=heads, eps=1e-12,
        act="gelu"), np.float32)
    out = tlayer.fused_int8_vit_layer(xt, *targs, heads, 1e-12)
    walk = tlayer._layer(
        xt, *targs, heads, 1e-12, "gelu", False, tmlp.quantize_rows_reference,
        tmlp.int8_gemm_reference,
        lambda qkv, hd, layer_numerics: replay_layer(qkv, hd))
    rel = lambda a: float(np.linalg.norm(a.float().numpy() - ref)
                          / np.linalg.norm(ref))
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert rel(out) < 5e-3 and rel(walk) < 5e-3
