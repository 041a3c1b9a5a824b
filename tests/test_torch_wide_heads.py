"""Heads of 72 to 128 columns on the tiled attention kernels, on the CPU.

``csrc/flash_attention_btd.cu`` runs such heads as templates on the width
padded to a multiple of 16 (HDP): a Q, K or V tile is two 64-column panels
in the 128-byte swizzle, the columns from hd to HDP zero-filled by the loads
and the columns past HDP never written; Q.K^T takes HDP / 16 k-steps across
the panels and P.V one product a panel, 64 columns wide on the first and
HDP - 64 on the second. The replays below walk those tiles in PyTorch, in
the kernel's three softmax modes (ONLINE, LAYER, NORM), and are held to the
port's plain versions and to the JAX kernels (interpret mode). The columns
the kernel never writes hold NaN here, so a walk that read one would fail.
The index maps of the loads and stores are checked to cover every element
once. Last, a ViT-H/14-width tower, cut to two layers, written as
``config.json`` plus safetensors, loaded by both packages.
"""

import math
import os

# transformers writes the checkpoint; its TensorFlow backend is not needed
os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_tpu.ops.pallas_attention import flash_attention as jax_flash
from mit_tpu.ops.pallas_attention import flash_attention_btd as jax_flash_btd
from mit_tpu_torch.ops import flash_attention as tflash
from mit_tpu_torch.ops.flash_attention import BF16_WARPS, bf16_tiling

BN, NEG, ROW_MASKED = 64, -1e9, -5e8
WIDE = [72, 80, 120, 128]           # 80 and 128 fill their panels; 72, 120 not


def padded(hd):
    """The kernel's HDP: hd rounded up to a multiple of 16."""
    return -(-hd // 16) * 16


def panels(x, hdp):
    """(rows, hd) → the kernel's tile of it: 64-column panels, columns hd to
    hdp zero (cp.async with src-size 0), columns past hdp never written."""
    rows, hd = x.shape
    n = -(-hdp // 64)
    tile = torch.full((rows, 64 * n), float("nan"))
    tile[:, :hdp] = 0.0
    tile[:, :hd] = x
    return [tile[:, 64 * i:64 * (i + 1)] for i in range(n)]


def tile_scores(qp, kp, hdp):
    """Q.K^T as the kernel issues it: HDP / 16 k-steps of 16 columns, four
    a panel, each a product of a (rows, 16) and a (keys, 16) slice."""
    s = torch.zeros(qp[0].shape[0], kp[0].shape[0])
    for j in range(hdp // 16):
        p, c = divmod(j, 4)
        cols = slice(16 * c, 16 * c + 16)
        s = s + qp[p][:, cols] @ kp[p][:, cols].T
    return s


def tile_pv(pb, vp, hdp, steps):
    """P.V as the kernel issues it: for each 16-key step in use, one
    product a panel, 64 columns on a full one and hdp - 64 on the last."""
    o = torch.zeros(pb.shape[0], hdp)
    for kk in range(steps):
        keys = slice(16 * kk, 16 * kk + 16)
        for p, panel in enumerate(vp):
            n = min(64, hdp - 64 * p)
            o[:, 64 * p:64 * p + n] += pb[:, keys] @ panel[keys, :n]
    return o


def replay(q, k, v, pad, causal, rows, mode):
    """flash_attention_btd_tc_kernel<NW, MODE, HDP> for one head, q (t, hd),
    k and v (s, hd), f32 holding bf16 values: blocks of ``rows`` query rows,
    64-key tiles whose V rows are zero to the end of the last 16-key step in
    use, the causal walk ending at the block's diagonal unless a row has
    seen only masked keys. mode "online": one walk, p rounded to bf16
    against the running max, out = o / l; "layer": a first walk for the
    exact max of the raw scores, p = exp2(s scale2 - max scale2), out = o *
    (1 / l) in f32 (never causal or padded); "norm": a first walk for the
    max and the sum, p = exp(x - max) * (1 / sum) rounded, out = o.
    Returns the (t, hdp) output before the store, which keeps columns < hd."""
    t, hd = q.shape
    s_len = k.shape[0]
    hdp = padded(hd)
    if mode == "layer":
        scale = torch.tensor(tflash.LOG2E / math.sqrt(hd), dtype=torch.float32)
    else:
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    kp, nkt = panels(k, hdp), -(-s_len // BN)
    out = torch.zeros(t, hdp)

    def tile(rws, qp, kt):
        k0 = kt * BN
        valid = min(BN, s_len - k0)
        steps = -(-valid // 16)
        ktile = [p[k0:k0 + valid] for p in kp]
        vtile = panels(torch.cat([v[k0:k0 + valid],
                                  torch.zeros(16 * steps - valid, hd)]), hdp)
        raw = tile_scores(qp, ktile, hdp)
        cols = torch.arange(k0, k0 + valid)
        x = raw * scale
        if causal:
            x = x + torch.where(cols[None] <= rws[:, None], 0.0, NEG)
        if pad is not None:
            x = x + pad[cols][None]
        return raw, x, vtile, steps

    for q0 in range(0, t, rows):
        rws = torch.arange(q0, min(q0 + rows, t))
        qp = panels(q[rws], hdp)
        n = len(rws)
        kt_end = min(nkt, int(rws[-1]) // BN + 1) if causal else nkt
        m, l, o = torch.full((n,), -torch.inf), torch.zeros(n), torch.zeros(n, hdp)
        if mode == "online":
            kt = 0
            while kt < kt_end:
                _, x, vt, steps = tile(rws, qp, kt)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l = l * alpha + p.sum(-1)
                pb = torch.cat([p, torch.zeros(n, 16 * steps - p.shape[1])], 1)
                o = o * alpha[:, None] + tile_pv(
                    pb.to(torch.bfloat16).float(), vt, hdp, steps)
                m = m_new
                if kt + 1 == kt_end and bool((m <= ROW_MASKED).any()):
                    kt_end = nkt
                kt += 1
            out[rws] = o * (1.0 / l)[:, None]
            continue
        kt = 0
        while kt < kt_end:          # first walk: K tiles alone
            raw, x, _, _ = tile(rws, qp, kt)
            if mode == "layer":
                m = torch.maximum(m, raw.amax(-1))
            else:
                m_new = torch.maximum(m, x.amax(-1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    x - m_new[:, None]).sum(-1)
                m = m_new
                if kt + 1 == kt_end and bool((m <= ROW_MASKED).any()):
                    kt_end = nkt
            kt += 1
        if mode == "layer":
            m = m * scale
        for kt in range(kt_end):    # second walk: p and P.V
            _, x, vt, steps = tile(rws, qp, kt)
            if mode == "layer":
                p = torch.exp2(x - m[:, None])
                l = l + p.sum(-1)
            else:
                p = torch.exp(x - m[:, None]) * (1.0 / l)[:, None]
            pb = torch.cat([p, torch.zeros(n, 16 * steps - p.shape[1])], 1)
            o = o + tile_pv(pb.to(torch.bfloat16).float(), vt, hdp, steps)
        out[rws] = o * (1.0 / l)[:, None] if mode == "layer" else o
    return out


def head_inputs(t, s, hd, seed, padded_keys=True):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float()
    q, k = to(r.normal(size=(t, hd))), to(r.normal(size=(s, hd)))
    v = to(r.uniform(-1, 1, size=(s, hd)))
    pad = None
    if padded_keys:
        pad = torch.from_numpy(
            np.where(r.random(s) < 0.3, NEG, 0.0).astype(np.float32))
        pad[0] = NEG        # query row 0 of a causal call sees a pad only
    return q, k, v, pad


def stored(out, hd):
    """The kernel stores columns below hd; those from hd to HDP must be 0."""
    assert torch.isfinite(out).all()
    assert not out[:, hd:].any()
    return out[:, :hd]


@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("t,s,causal", [(100, 100, True), (33, 130, True),
                                        (150, 70, True), (257, 257, False),
                                        (17, 16, False)])
@pytest.mark.parametrize("hd", WIDE)
def test_online_walk_matches_plain(hd, t, s, causal, warps):
    q, k, v, pad = head_inputs(t, s, hd, seed=hd + t + s)
    out = stored(replay(q, k, v, pad, causal, bf16_tiling(t, warps)[1],
                        "online"), hd)
    ref = tflash.flash_attention_btd_reference(
        q[None].bfloat16(), k[None].bfloat16(), v[None].bfloat16(),
        pad[None], causal, hd)[0].float()
    # p rounded to bf16 against a running max, the plain version's output
    # itself rounded to bf16
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("t,s,causal", [(100, 100, True), (33, 130, True),
                                        (150, 70, True), (257, 257, False),
                                        (17, 16, False)])
@pytest.mark.parametrize("hd", WIDE)
def test_norm_walk_matches_plain(hd, t, s, causal, warps):
    q, k, v, pad = head_inputs(t, s, hd, seed=hd + t + s + 1)
    out = stored(replay(q, k, v, pad, causal, bf16_tiling(t, warps)[1],
                        "norm"), hd)
    four = lambda x: x[None, None].bfloat16()
    ref = tflash.flash_attention_reference(
        four(q), four(k), four(v), pad[None], causal)[0, 0].float()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("hd", WIDE)
def test_layer_walk_matches_plain(hd):
    """The int8 layer's numerics over fused qkv (two heads), f32 out. The
    scores are summed in the kernel's k-step order, not the plain version's,
    so a p may round to bf16 on the other side of a tie: one bf16 rounding
    of a p (2^-9 relative) times |v| of a few units bounds an element's
    move, 2e-3 with room (2.3e-4 at hd 72)."""
    b, t, h = 2, 70, 2
    qkv = torch.from_numpy(np.random.default_rng(hd).normal(
        size=(b, t, 3 * h * hd)).astype(np.float32)).to(torch.bfloat16)
    ref = tflash.flash_attention_btd_fusedqkv_reference(qkv, hd, True)
    out = replay_layer(qkv, hd)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 2e-3


def replay_layer(qkv, hd, rows=128):
    """The LAYER walk over every (batch, head) of a fused (B, T, 3D) qkv."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    out = torch.zeros(b, t, d)
    x = qkv.float()
    for bi in range(b):
        for hi in range(d // hd):
            cols = lambda j: slice(j * d + hi * hd, j * d + (hi + 1) * hd)
            o = replay(x[bi, :, cols(0)], x[bi, :, cols(1)], x[bi, :, cols(2)],
                       None, False, rows, "layer")
            out[bi, :, hi * hd:(hi + 1) * hd] = stored(o, hd)
    return out


@pytest.mark.parametrize("hd", [80, 128, 72])
def test_walks_match_jax_kernels(hd):
    """The ONLINE walk against the JAX (B, T, D) kernel and the NORM walk
    against its (B, H, T, hd) kernel, both in interpret mode."""
    t = s = 100
    q, k, v, pad = head_inputs(t, s, hd, seed=hd)
    rows = bf16_tiling(t)[1]
    j3 = lambda x: jnp.asarray(x[None].numpy(), jnp.bfloat16)
    j4 = lambda x: jnp.asarray(x[None, None].numpy(), jnp.bfloat16)
    jpad = jnp.asarray(pad[None].numpy())
    online = stored(replay(q, k, v, pad, True, rows, "online"), hd)
    want = jax_flash_btd(j3(q), j3(k), j3(v), jpad, True, hd)
    np.testing.assert_allclose(online.numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=0, atol=1e-2)
    norm = stored(replay(q, k, v, pad, True, rows, "norm"), hd)
    want = jax_flash(j4(q), j4(k), j4(v), jpad, True)
    np.testing.assert_allclose(norm.numpy(),
                               np.asarray(want[0, 0].astype(jnp.float32)),
                               rtol=0, atol=1e-2)


@pytest.mark.parametrize("t,s", [(100, 100), (40, 200), (130, 130)])
def test_walks_keep_fully_masked_rows_uniform(t, s):
    """Every key padded: row i is uniform over keys 0..i in both causal
    modes, never NaN, at a width with zero columns."""
    hd = 120
    q, k, v, _ = head_inputs(t, s, hd, seed=5, padded_keys=False)
    pad = torch.full((s,), NEG)
    want = torch.stack([v[:min(i + 1, s)].mean(0) for i in range(t)])
    for mode, tol in (("online", 1e-5), ("norm", 4e-3)):
        out = stored(replay(q, k, v, pad, True, bf16_tiling(t)[1], mode), hd)
        torch.testing.assert_close(out, want, rtol=0, atol=tol)


def test_layer_walk_in_the_int8_layer_matches_jax():
    """The fused int8 layer at head width 80 (two heads, d 160), its
    attention replaced by the LAYER walk, against the JAX layer kernel in
    interpret mode, within the JAX package's own bound between its layer
    kernel and its composition."""
    from mit_tpu.models import vision as jvis
    from mit_tpu.ops import pallas_int8_layer as jlayer
    from mit_tpu_torch.models.convert import layer_params, params_from_jax
    from mit_tpu_torch.ops import int8_layer as tlayer
    from mit_tpu_torch.ops import int8_mlp as tmlp

    d, heads = 160, 2
    jcfg = jvis.VisionConfig(
        family="vit", image_size=32, patch_size=8, hidden_size=d,
        num_layers=1, num_heads=heads, intermediate_size=256,
        hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
        ln_pre=False, ln_post=True)
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
    x = np.random.default_rng(2).normal(size=(2, 17, d)).astype(np.float32)
    want = np.asarray(jlayer.fused_int8_vit_layer(
        jnp.asarray(x, jnp.bfloat16), *pick(jl), num_heads=heads, eps=1e-12,
        act="gelu"), np.float32)
    walk = tlayer._layer(
        torch.from_numpy(x).to(torch.bfloat16), *pick(tl), heads, 1e-12,
        "gelu", False, tmlp.quantize_rows_reference, tmlp.int8_gemm_reference,
        lambda qkv, hd, layer_numerics: replay_layer(qkv, hd))
    rel = float(np.linalg.norm(walk.float().numpy() - want)
                / np.linalg.norm(want))
    assert rel < 5e-3


# ----------------------------------------------------------------------
# the index maps of the wide tiles: loads, the bf16 store, the f32 store
# ----------------------------------------------------------------------
TILE = 64 * 64


def tile_at(r, c):
    return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("hdp", [80, 96, 112, 128])
def test_wide_load_map_puts_each_chunk_in_its_own_place(hdp, rows):
    """load_wide_rows_async: chunk (r, c) of a row-major (rows, hdp) tile to
    (r >> 6) * 2 TILE + (c >> 6) * TILE + tile_at(r & 63, c & 63): distinct
    16-byte slots, inside the wide tiles, in the panel and row the
    descriptors name."""
    wt = 2 * TILE
    seen = {}
    for i in range(rows * hdp // 8):
        r, c = divmod(i, hdp // 8)
        c *= 8
        at = (r >> 6) * wt + (c >> 6) * TILE + tile_at(r & 63, c & 63)
        assert at % 8 == 0 and 0 <= at < (rows // 64) * wt
        # the panel's row r & 63 is 64 elements at (r & 63) * 64
        assert (at % TILE) // 64 == r & 63 and (at % wt) // TILE == c >> 6
        seen[at] = (r, c)
    assert len(seen) == rows * hdp // 8


@pytest.mark.parametrize("hdp", [80, 96, 112, 128])
def test_wide_bf16_store_covers_each_chunk_once(hdp):
    """The bf16 epilogue: HDP / 16 stores of 32 lanes cover a warp's 16 rows
    of HDP / 8 chunks once each."""
    ch = hdp // 8
    got = [divmod(it * 32 + lane, ch) for it in range(hdp // 16)
           for lane in range(32)]
    assert sorted(got) == [(r, c) for r in range(16) for c in range(ch)]


@pytest.mark.parametrize("hd", [72, 80, 96, 104, 112, 120, 128])
def test_wide_f32_store_covers_the_columns_below_hd_once(hd):
    """The f32 kernel's output groups: lane tx of a row owns the 4-column
    groups tx + 8 c, c < ceil(HDP / 32); it stores a group when its first
    column is below hd, which covers columns 0 .. hd - 1 once."""
    hdp = padded(hd)
    cols = [4 * tx + 32 * c + e for tx in range(8)
            for c in range(-(-hdp // 32)) if 4 * tx + 32 * c < hd
            for e in range(4)]
    assert sorted(cols) == list(range(hd))


# ----------------------------------------------------------------------
# a ViT-H/14-width tower from local HF files, in both packages
# ----------------------------------------------------------------------
def test_vit_h_width_tower_loads_and_runs_as_in_jax(tmp_path):
    """google/vit-huge-patch14-224-in21k's widths (1280 in 16 heads of 80,
    MLP 5120, patch 14 at 224: 257 tokens), cut to 2 layers, written by
    transformers as config.json plus model.safetensors: the same
    VisionConfig in both packages, bit-equal weights (models/convert.py
    carries them), and vision_forward within 2e-5 of JAX's with its Pallas
    attention in interpret mode, f32."""
    import transformers as tf

    from mit_tpu.models import pretrained as jpre
    from mit_tpu.models import vision as jvis
    from mit_tpu_torch.models import pretrained as tpre
    from mit_tpu_torch.models import vision as tvis
    from mit_tpu_torch.models.convert import params_to_jax

    torch.manual_seed(14)
    cfg = tf.ViTConfig(hidden_size=1280, num_hidden_layers=2,
                       num_attention_heads=16, intermediate_size=5120,
                       image_size=224, patch_size=14, hidden_act="gelu",
                       layer_norm_eps=1e-12)
    tf.ViTModel(cfg, add_pooling_layer=False).eval().save_pretrained(tmp_path)
    tcfg, tparams = tpre.load_pretrained_encoder(str(tmp_path))
    jcfg, jparams = jpre.load_pretrained_encoder(str(tmp_path))
    assert tcfg._asdict() == jcfg._asdict()
    assert (tcfg.hidden_size // tcfg.num_heads, tcfg.seq_len) == (80, 257)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(tparams),
                 jax.tree.map(np.asarray, jparams))
    px = np.random.default_rng(0).normal(size=(1, 3, 224, 224)).astype(
        np.float32)
    ours = tvis.vision_forward(tparams, tcfg, torch.from_numpy(px)).numpy()
    want = np.asarray(jvis.vision_forward(jparams, jcfg, jnp.asarray(px),
                                          use_pallas=True))
    np.testing.assert_allclose(ours, want, rtol=0, atol=2e-5)
