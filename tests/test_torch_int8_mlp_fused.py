"""The fused int8 MLP kernel (``csrc/int8_mlp_fused.cu``) replayed on the
CPU, against the port's plain version and the JAX package.

The kernel cannot run here, so :func:`replay_mlp` walks the same partition
in PyTorch: a cluster of ``cluster`` blocks a tile of ``rows`` rows (the
last tile ragged); each block's warps normalize and quantize ``rows /
cluster`` rows with the sums in the kernel's lane order (:func:`lane_sum`);
block r's two warpgroups own F / cluster hidden columns in chunks of
``chunk``, and their row maxima meet in a cluster-wide max; block r's two
warpgroups own D / cluster output columns, and fc2's k-step k takes its A
tile from the block that holds those hidden columns. The elementwise steps
are the plain version's (``int8_gemm_reference``, ``dynamic_quantize``),
which the card tests hold the kernel to. Every hidden column, output column
and k-step is counted, so a gap or an overlap in the partition fails.

Tolerances, and why:
- :func:`lane_sum` against quantize_rows.cu's block reduction
  (:func:`block_sum`): bitwise, it is the same sequence of f32 additions;
- without the LayerNorm, the codes and scales of both quantizers and the
  output: bitwise against the plain version (the max is exact, the
  accumulators are exact, the elementwise steps are the same);
- with the LayerNorm: the replay's codes within one step of the plain
  version's and of the JAX package's (their sums run in other orders, as
  ``test_quantize_rows_with_layernorm_matches_jax`` states), and from those
  codes on, the hidden's codes and scales and the output bitwise;
- against the JAX package's kernels in interpret mode: ``fused_int8_mlp``
  within relative L2 1e-3 (``tests/test_torch_int8.py``'s bound: f32 sums
  in another order, now and then a code flipped); the layers within 5e-3,
  the JAX package's own bound between its layer kernel and its
  composition: at d = 384 the port's plain layer is itself 2.3e-3 from
  JAX's f32 layer kernel (the attention's codes flip more often there),
  so the tight check is the replayed layer against the port's plain one,
  within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.models import vision as jvis
from mit_tpu.ops import pallas_int8_layer as jlayer
from mit_tpu.ops import pallas_int8_mlp as jmlp
from mit_tpu_torch import kernels
from mit_tpu_torch.models.convert import layer_params, params_from_jax
from mit_tpu_torch.ops import int8_layer as tlayer
from mit_tpu_torch.ops import int8_mlp as tmlp
from mit_tpu_torch.ops.flash_attention import (
    flash_attention_btd_fusedqkv_reference,
)
from mit_tpu_torch.ops.quant import (
    QuantizedLinear,
    _divide,
    int8_accumulate,
    quantize_weight,
)

F32 = np.float32
THREADS = 256                 # quantize_rows.cu's block


# ----------------------------------------------------------------------
# the LayerNorm's sums: quantize_rows.cu's order and the kernel's lanes
# ----------------------------------------------------------------------
def _tree(v, lanes, xors):
    """The xor tree ``v + v[lane ^ off]`` over axis ``lanes`` of v."""
    idx = np.arange(v.shape[lanes])
    for off in xors:
        v = (v + np.take(v, idx ^ off, axis=lanes)).astype(F32)
    return v


def block_sum(x):
    """quantize_rows.cu's row sum of x (R, K) f32: thread t of 256 adds
    elements t, t + 256, ... from 0; a warp's xor tree; warps in order."""
    r, k = x.shape
    s = np.zeros((r, THREADS), F32)
    for j in range(0, k, THREADS):
        n = min(THREADS, k - j)
        s[:, :n] = (s[:, :n] + x[:, j:j + n]).astype(F32)
    w = _tree(s.reshape(r, 8, 32), 2, (16, 8, 4, 2, 1))[:, :, 0]
    total = w[:, 0]
    for i in range(1, 8):
        total = (total + w[:, i]).astype(F32)
    return total


def lane_sum(x):
    """The kernel's row_sum of x (R, K) f32, K a multiple of 128: lane l
    holds elements 128 i + 4 l + e; s[l, i & 1, e] adds them in i's order;
    shuffles to lanes l ^ 4, ^ 2, ^ 1; then e ^ 2 and e ^ 1 in the lane;
    then warp W's sum from lane 8 (W % 4), half W / 4, in W's order."""
    r, k = x.shape
    v = x.reshape(r, k // 128, 32, 4)
    s = np.zeros((r, 32, 2, 4), F32)
    for i in range(k // 128):
        s[:, :, i & 1] = (s[:, :, i & 1] + v[:, i]).astype(F32)
    s = _tree(s, 1, (4, 2, 1))
    u0 = (s[..., 0] + s[..., 2]).astype(F32)
    u1 = (s[..., 1] + s[..., 3]).astype(F32)
    w = (u0 + u1).astype(F32)                     # (R, 32, 2)
    total = w[:, 0, 0]
    for big in range(1, 8):
        total = (total + w[:, 8 * (big % 4), big // 4]).astype(F32)
    return total


def prologue(x, ln, eps):
    """The kernel's prologue on x (R, D) f32: the LayerNorm with
    :func:`lane_sum`'s sums (quantize_rows.cu's step order), then the row
    quantizer. Returns (codes (R, D) int8, scales (R,) f32)."""
    x = x.astype(F32)
    d = F32(x.shape[1])
    if ln is not None:
        mean = (lane_sum(x) / d).astype(F32)[:, None]
        c = (x - mean).astype(F32)
        var = (lane_sum((c * c).astype(F32)) / d).astype(F32)
        r = (F32(1) / np.sqrt((var + F32(eps)).astype(F32))).astype(F32)
        scale = ln["scale"].numpy()[None]
        bias = ln["bias"].numpy()[None]
        x = ((c * r[:, None]).astype(F32) * scale).astype(F32)
        x = (x + bias).astype(F32)
    amax = np.maximum(np.abs(x).max(1), F32(1e-8)).astype(F32)
    inv = (F32(127) / amax).astype(F32)
    q = np.clip(np.rint((x * inv[:, None]).astype(F32)), -127, 127)
    return (torch.from_numpy(q.astype(np.int8)),
            torch.from_numpy((amax * F32(1 / 127)).astype(F32)))


# ----------------------------------------------------------------------
# the walk
# ----------------------------------------------------------------------
def replay_mlp(x, q1, q2, act="gelu", ln=None, eps=0.0, residual=False,
               out_dtype=torch.float32, cluster=tmlp.MLP_CLUSTER,
               rows=tmlp.MLP_ROWS, chunk=tmlp.MLP_CHUNK):
    """The kernel's walk over x (M, D); returns (y, steps) where steps
    holds each tile's h8, sh, m8 and sm (rows past M dropped)."""
    m, d = x.shape
    f = q1.w8.shape[1]
    fb, db = f // cluster, d // cluster            # a block's columns
    fw, dw = fb // 2, db // 2                      # a warpgroup's
    tiles_h = fb // 128                            # HID's tiles a block
    assert d % 128 == 0 and fw % chunk == 0 and fb % 128 == 0 and dw % 8 == 0
    rpb = rows // cluster
    w1, w2 = q1.w8, q2.w8
    y = torch.empty(m, d, dtype=out_dtype)
    steps = {"h8": [], "sh": [], "m8": [], "sm": []}
    hid_cols = np.zeros(f, int)
    out_cols = np.zeros(d, int)
    for m0 in range(0, m, rows):
        live = min(rows, m - m0)
        # prologue: block r's warp w normalizes row r * rpb + w
        row_of = np.full(rows, -1)
        for r in range(cluster):
            for w in range(rpb):
                row_of[r * rpb + w] = r * rpb + w
        assert sorted(row_of) == list(range(rows))
        xs = torch.zeros(rows, d)
        xs[:live] = x[m0:m0 + live].float()
        h8, sh = prologue(xs.numpy(), ln, eps)
        h8[live:], sh[live:] = 0, 0.0
        # fc1 by block, warpgroup and chunk; each warpgroup's row maxima
        mid = torch.empty(rows, f)
        part = torch.zeros(cluster, 2, rows)
        for r in range(cluster):
            for c in range(2):
                for j in range(fw // chunk):
                    n0 = r * fb + c * fw + j * chunk
                    cols = slice(n0, n0 + chunk)
                    qj = QuantizedLinear(w1[:, cols], q1.scale[cols],
                                         None if q1.bias is None
                                         else q1.bias[cols])
                    v = tmlp.int8_gemm_reference(h8, sh, qj, act)
                    mid[:, cols] = v
                    part[r, c] = torch.maximum(part[r, c], v.abs().amax(1))
                    if m0 == 0:
                        hid_cols[n0:n0 + chunk] += 1
        # the cluster's row max, then every block quantizes its columns
        amax = part.amax(dim=(0, 1)).clamp(min=1e-8)[:, None]
        inv = _divide(amax, 127.0, divisor=False)
        m8 = torch.clamp(torch.round(mid * inv), -127, 127).to(torch.int8)
        sm = (amax * (1.0 / 127.0))[:, 0]
        # fc2 by block and warpgroup, its A tiles from the blocks that hold
        # them
        for r in range(cluster):
            for c in range(2):
                o0 = r * db + c * dw
                ocols = slice(o0, o0 + dw)
                acc = torch.zeros(rows, dw, dtype=torch.int32)
                for kt in range(f // 128):
                    owner, tile = kt // tiles_h, kt % tiles_h
                    k0 = owner * fb + tile * 128
                    assert k0 == kt * 128         # the owner holds step kt
                    acc += int8_accumulate(m8[:, k0:k0 + 128],
                                           w2[k0:k0 + 128, ocols])
                v = acc.float() * (sm[:, None] * q2.scale[None, ocols])
                if q2.bias is not None:
                    v = v + q2.bias[None, ocols]
                if residual:
                    v = x[m0:m0 + live, ocols].float() + v[:live]
                y[m0:m0 + live, ocols] = v[:live].to(out_dtype)
                if m0 == 0:
                    out_cols[ocols] += 1
        for name, t in (("h8", h8), ("sh", sh), ("m8", m8), ("sm", sm)):
            steps[name].append(t[:live])
    assert (hid_cols == 1).all() and (out_cols == 1).all()
    return y, {k: torch.cat(v) for k, v in steps.items()}


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
# the kernel's three geometries (ViT-B, CLIP-L, ViT-H) and narrow widths
# of the same 1:4 ratio whose k-step counts (1, 2, 3) are odd and even, as
# the kernel's (6, 8, 10) are not
WIDE = [(768, 3072), (1024, 4096), (1280, 5120)]
NARROW = [(128, 512), (256, 1024), (384, 1536)]
# (x dtype, LayerNorm and residual, out dtype): the layer with an f32
# stream, the split layer's bf16 stream, fused_int8_mlp
FORMS = {"layer": (torch.float32, True, torch.float32),
         "split": (torch.bfloat16, True, torch.bfloat16),
         "mlp": (torch.bfloat16, False, torch.bfloat16)}


def _qlinear(k, n, seed):
    r = np.random.default_rng(seed)
    return quantize_weight(
        torch.from_numpy((r.normal(size=(k, n)) * 0.02).astype(F32)),
        torch.from_numpy((r.normal(size=n) * 0.02).astype(F32)))


def _ln(d, seed):
    r = np.random.default_rng(seed)
    return {"scale": torch.from_numpy((1 + 0.1 * r.normal(size=d)).astype(F32)),
            "bias": torch.from_numpy((0.1 * r.normal(size=d)).astype(F32))}


def _x(m, d, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(F32) * 2 + 0.3
    x[1:2] = 0.0                                 # the 1e-8 amax floor
    return torch.from_numpy(x).to(dtype)


def _narrow_cluster(d, f):
    """The replay's cluster at a narrow width: the kernel's 8 blocks where
    the widths allow it, else 2."""
    return 8 if d % (8 * 16) == 0 and f % (8 * 128) == 0 else 2


# ----------------------------------------------------------------------
# the sums and the prologue
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [128, 384, 640, 768, 1024, 1280])
def test_lane_sum_is_quantize_rows_order(k):
    r = np.random.default_rng(k)
    x = (r.normal(size=(24, k)) * r.uniform(0.1, 1e3, size=(24, 1))
         + r.normal(size=(24, 1)) * 50).astype(F32)
    np.testing.assert_array_equal(lane_sum(x), block_sum(x))
    # and the order shows: a plain sum differs somewhere
    assert not np.array_equal(block_sum(x), x.sum(1, dtype=F32))


@pytest.mark.parametrize("with_ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("d", [384, 768, 1280])
def test_prologue_matches_quantize_rows(d, with_ln):
    x = _x(70, d, torch.float32, seed=d)
    ln = _ln(d, d + 1) if with_ln else None
    q8, qs = prologue(x.numpy(), ln, 1e-6)
    r8, rs = tmlp.quantize_rows_reference(x, ln, 1e-6)
    assert not q8[1].any() and not r8[1].any() or with_ln
    if not with_ln:
        assert torch.equal(q8, r8) and torch.equal(qs, rs)
        return
    diff = (q8.int() - r8.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    torch.testing.assert_close(qs, rs, rtol=1e-6, atol=0)
    # and the JAX package's LayerNorm + quantizer, one step likewise
    h = jlayer._ln(jnp.asarray(x.numpy()), jnp.asarray(ln["scale"].numpy()),
                   jnp.asarray(ln["bias"].numpy()), 1e-6)
    j8, js = jmlp._quantize_rows(h)
    jdiff = np.abs(q8.numpy().astype(int) - np.asarray(j8, int))
    assert jdiff.max() <= 1 and (jdiff > 0).mean() <= 1e-3
    np.testing.assert_allclose(qs.numpy(), np.asarray(js)[:, 0], rtol=1e-6)


# ----------------------------------------------------------------------
# the walk against the plain version
# ----------------------------------------------------------------------
def _hold_to_plain(x, q1, q2, act, ln, residual, out_dtype, **plan):
    y, st = replay_mlp(x, q1, q2, act, ln, 1e-6, residual, out_dtype, **plan)
    r8, rs = tmlp.quantize_rows_reference(x, ln, 1e-6)
    if ln is None:
        assert torch.equal(st["h8"], r8) and torch.equal(st["sh"], rs)
    else:
        diff = (st["h8"].int() - r8.int()).abs()
        assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    # from the replay's codes on, the plain version's steps, bit for bit
    mid = tmlp.int8_gemm_reference(st["h8"], st["sh"], q1, act)
    m8, sm = tmlp.quantize_rows_reference(mid)
    assert torch.equal(st["m8"], m8) and torch.equal(st["sm"], sm)
    ref = tmlp.int8_gemm_reference(m8, sm, q2, residual=x if residual
                                   else None, out_dtype=out_dtype)
    assert y.dtype == out_dtype and torch.equal(y, ref)
    if ln is None:                 # the whole plain version, bit for bit
        assert torch.equal(y, tmlp.int8_mlp_fused_reference(
            x, q1, q2, act, None, 0.0, residual, out_dtype))
    return y


@pytest.fixture
def one_thread():
    """One intra-op thread: the replay's ~1,300 small float64 products each
    open a parallel region, which under other test workers' load costs
    seconds a case. The products of int8 values are exact either way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("d,f", WIDE, ids=["vit-b", "clip-l", "vit-h"])
def test_replay_at_the_kernels_widths_matches_plain(d, f, act, form,
                                                    one_thread):
    """The kernel's own constants (8 blocks, 64 rows, chunks of 64) at its
    three geometries; 130 rows: two tiles and a ragged third."""
    dtype, with_ln, out_dtype = FORMS[form]
    x = _x(130, d, dtype, seed=d + f)
    _hold_to_plain(x, _qlinear(d, f, 1), _qlinear(f, d, 2), act,
                   _ln(d, 3) if with_ln else None, with_ln, out_dtype)


@pytest.mark.parametrize("m", [1, 63, 64, 65])
def test_replay_ragged_rows(m, one_thread):
    """Tiles of one row, one short of a tile, a whole tile, one past."""
    x = _x(m, 768, torch.float32, seed=m)
    y = _hold_to_plain(x, _qlinear(768, 3072, 4), _qlinear(3072, 768, 5),
                       "gelu", _ln(768, 6), True, torch.float32)
    assert y.shape == (m, 768) and bool(torch.isfinite(y).all())


def test_replay_refuses_chunks_that_do_not_tile_a_warpgroup():
    """The replay takes only plans whose chunks tile a warpgroup's columns
    (inside it, a skipped or repeated column or a k-step in the wrong block
    fails its counts)."""
    with pytest.raises(AssertionError):
        replay_mlp(_x(8, 128, torch.float32, 0), _qlinear(128, 512, 0),
                   _qlinear(512, 128, 1), cluster=2, chunk=96)


# ----------------------------------------------------------------------
# against the JAX package (interpret mode), at narrow widths
# ----------------------------------------------------------------------
def _vision_layer(d, act):
    """One quantized layer at width d (heads of 64, F = 4 d) in both
    packages, as tests/test_torch_int8.py builds its layers."""
    kw = dict(family="vit", image_size=32, patch_size=8, hidden_size=d,
              num_layers=1, num_heads=d // 64, intermediate_size=4 * d,
              hidden_act=act, layer_norm_eps=1e-12, patch_bias=True,
              ln_pre=False, ln_post=True)
    jcfg = jvis.VisionConfig(**kw)
    params = jax.tree.map(np.asarray, jvis.init_vision_params(
        jax.random.PRNGKey(d), jcfg))
    r = np.random.default_rng(d)
    params = jax.tree.map(
        lambda a: a + r.normal(size=a.shape).astype(F32) * 0.05, params)
    q8 = jax.tree.map(np.asarray, jvis.quantize_vision_params(params, jcfg))
    return (jax.tree.map(lambda a: a[0], q8["layers"]),
            layer_params(params_from_jax(q8)["layers"], 0))


def _args(lay):
    return (lay["ln1"], lay["attn"]["qkv"], lay["attn"]["o"], lay["ln2"],
            lay["fc1"], lay["fc2"])


def _rel(out, ref):
    out, ref = np.asarray(out, F32), np.asarray(ref, F32)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("d,f", NARROW, ids=["d128", "d256", "d384"])
def test_replay_matches_jax_fused_int8_mlp(d, f, act):
    jl, tl = _vision_layer(d, act)
    x = np.random.default_rng(d).normal(size=(70, d)).astype(F32)
    ref = jmlp.fused_int8_mlp(jnp.asarray(x), jl["fc1"], jl["fc2"], act,
                              jnp.float32)
    y = _hold_to_plain(torch.from_numpy(x), tl["fc1"], tl["fc2"], act, None,
                       False, torch.float32, cluster=_narrow_cluster(d, f))
    assert _rel(y, ref) < 1e-3


def _replay_layer(x, args, heads, act, split, cluster):
    """The port's layer with the replayed walk as its MLP half."""
    mlp = lambda *a, **kw: replay_mlp(*a, **kw, cluster=cluster)[0]
    return tlayer._layer(x, *args, heads, 1e-12, act, split,
                         tmlp.quantize_rows_reference,
                         tmlp.int8_gemm_reference,
                         flash_attention_btd_fusedqkv_reference, mlp)


@pytest.mark.parametrize("form", ["f32", "bf16", "split"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("d,f", NARROW, ids=["d128", "d256", "d384"])
def test_replayed_layer_matches_jax(d, f, act, form):
    """fused_int8_vit_layer (f32 and bf16 x) and its split form (bf16 x:
    the stream between the halves in bf16) with the replayed MLP half."""
    jl, tl = _vision_layer(d, act)
    x = np.random.default_rng(d + 1).normal(size=(2, 35, d)).astype(F32)
    dtype = jnp.float32 if form == "f32" else jnp.bfloat16
    jfn = (jlayer.fused_int8_vit_layer_split if form == "split"
           else jlayer.fused_int8_vit_layer)
    ref = jfn(jnp.asarray(x, dtype), *_args(jl), num_heads=d // 64,
              eps=1e-12, act=act)
    xt = torch.from_numpy(x).to(torch.float32 if form == "f32"
                                else torch.bfloat16)
    out = _replay_layer(xt, _args(tl), d // 64, act, form == "split",
                        _narrow_cluster(d, f))
    assert out.shape == x.shape and out.dtype == xt.dtype
    assert _rel(out.float(), ref) < 5e-3
    # and it is the port's plain layer up to the LayerNorm's code flips
    plain = (tlayer.fused_int8_vit_layer_split_reference if form == "split"
             else tlayer.fused_int8_vit_layer_reference)
    assert _rel(out.float(), plain(xt, *_args(tl), d // 64, 1e-12,
                                   act).float()) < 1e-3


# ----------------------------------------------------------------------
# the routes and the wrapper's checks (no card needed)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d,f,act,rows,route", [
    (768, 3072, "gelu", 64, "fused"), (768, 3072, "gelu", 16 * 197, "fused"),
    (768, 3072, "gelu", 16 * 197 + 1, "composition"),
    (1024, 4096, "quick_gelu", 4 * 257, "fused"),
    (1024, 4096, "quick_gelu", 64 * 257, "composition"),
    (1280, 5120, "gelu", 2 * 257, "fused"),
    (1280, 5120, "gelu", 64 * 257, "composition"),
    (768, 3072, "none", 64, "composition"),
    (128, 512, "gelu", 64, "composition"),
    (768, 4096, "gelu", 64, "composition"),
])
def test_mlp_kernel_for(d, f, act, rows, route):
    """The rule by (D, F), rows and activation: the fused kernel up to the
    rows at which it beat the composition, the composition past them."""
    assert tmlp.mlp_kernel_for(d, f, act, rows) == route


def test_the_route_takes_only_what_the_kernel_is_built_for():
    assert set(tmlp.MLP_KERNEL_MAX_ROWS) <= set(tmlp.FUSED_MLP_SHAPES)
    # the last layer's CLS rows of a batch of 64 always take the kernel
    assert all(rows >= 64 for rows in tmlp.MLP_KERNEL_MAX_ROWS.values())


def test_mlp_phases_needs_a_card(capsys):
    from mit_tpu_torch.tools import mlp_phases

    assert mlp_phases.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_cpu_tensors_take_the_plain_mlp():
    x = _x(5, 768, torch.bfloat16, 7)
    q1, q2 = _qlinear(768, 3072, 8), _qlinear(3072, 768, 9)
    before = tmlp.int8_mlp_fused.launches, dict(tmlp.fused_int8_mlp.kernels)
    out = tmlp.int8_mlp_fused(x, q1, q2, "gelu")
    assert torch.equal(out, tmlp.int8_mlp_fused_reference(x, q1, q2, "gelu"))
    assert torch.equal(tmlp.fused_int8_mlp(x, q1, q2, "gelu"), out)
    after = tmlp.int8_mlp_fused.launches, dict(tmlp.fused_int8_mlp.kernels)
    assert after == before                   # nothing launched, nothing routed


def _checked(change):
    d, f = change.get("d", 768), change.get("f", 3072)
    x = torch.zeros(4, d, dtype=change.get("x_dtype", torch.bfloat16))
    q1, q2 = _qlinear(d, f, 0), _qlinear(f, change.get("d2", d), 1)
    if change.get("layout") == "row":
        q1 = q1._replace(w8=q1.w8.contiguous())
    if change.get("scale_len"):
        q2 = q2._replace(scale=q2.scale[:change["scale_len"]])
    ln = _ln(change.get("ln_d", d), 2) if "ln_d" in change else None
    tmlp._check_mlp_fused(x, q1, q2, change.get("act", "gelu"), ln,
                          change.get("out_dtype", torch.bfloat16))


@pytest.mark.parametrize("change,error", [
    (dict(d=128, f=512), ValueError),          # no kernel at that (D, F)
    (dict(d=768, f=4096), ValueError),
    (dict(d2=1024), ValueError),               # fc2 not (F, D)
    (dict(layout="row"), ValueError),          # w8 not K-contiguous
    (dict(x_dtype=torch.float16), TypeError),
    (dict(out_dtype=torch.float16), TypeError),
    (dict(act="none"), ValueError),            # the composition's
    (dict(scale_len=700), ValueError),
    (dict(ln_d=640), ValueError),
])
def test_int8_mlp_fused_input_checks(change, error):
    with pytest.raises(error):
        _checked(change)


def test_int8_mlp_fused_takes_the_presets():
    for d, f in tmlp.FUSED_MLP_SHAPES:
        _checked(dict(d=d, f=f, ln_d=d))


# ----------------------------------------------------------------------
# the library's C entry points (the card loads them by name with ctypes)
# ----------------------------------------------------------------------
def _c_entries():
    """name -> parameter count of every ``extern "C" int`` in csrc/*.cu
    compiled by default (outside ``#ifdef`` blocks)."""
    import re

    out = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = re.sub(r"#ifdef.*?#endif", "", src.read_text(), flags=re.S)
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = len([p for p in m.group(2).split(",")
                                   if p.strip()])
    return out


@pytest.mark.parametrize("name", sorted(kernels.ENTRY_POINTS))
def test_every_entry_point_is_defined_with_its_arguments(name):
    entries = _c_entries()
    assert name in entries, f"{name} is not defined in csrc/*.cu"
    assert entries[name] == len(kernels.ENTRY_POINTS[name])


# a diagnostic of the fused MLP kernel's occupancy, which no path of the port
# calls: the smoke prints it
UNCALLED_ENTRIES = {"mit_int8_mlp_fused_info"}


@pytest.mark.parametrize("name", sorted(kernels.ENTRY_POINTS))
def test_every_entry_point_is_named_by_the_port(name):
    """Each C entry is named, as a string, by a module of the port other than
    the table of entries: the library exports nothing that only a
    measurement reaches."""
    root = kernels.CSRC.parent
    named = [path for path in root.rglob("*.py")
             if path != root / "kernels" / "__init__.py"
             and f'"{name}"' in path.read_text()]
    assert bool(named) != (name in UNCALLED_ENTRIES), named
