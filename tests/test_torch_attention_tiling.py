"""What surrounds the bf16 (tensor-core) attention kernel of mit_tpu_torch,
on the CPU: the tiling rule, the dispatch to the C entry points, and the
kernel's walk over the key tiles (online softmax, causal tile skipping),
replayed in plain PyTorch against the plain version and the JAX kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_tpu.ops.pallas_attention import flash_attention as jax_flash
from mit_tpu.ops.pallas_attention import flash_attention_btd as jax_flash_btd
from mit_tpu_torch import kernels
from mit_tpu_torch.ops.flash_attention import (
    BF16_GROUP_ROWS,
    BF16_WARPS,
    bf16_tiling,
    btd_entry,
    flash_attention_btd_reference,
    flash_attention_reference,
)

LENGTHS = [1, 15, 16, 17, 63, 64, 65, 99, 100, 128, 129, 197, 208, 256, 257,
           577, 1025]


@pytest.mark.parametrize("t", LENGTHS)
def test_tiling_covers_the_rows_evenly(t):
    for warps in (None, *BF16_WARPS):
        w, rows = bf16_tiling(t, warps)
        assert w in BF16_WARPS and (warps is None or w == warps)
        held = BF16_GROUP_ROWS * w // 4             # rows a block holds
        assert rows % BF16_GROUP_ROWS == 0 and BF16_GROUP_ROWS <= rows <= held
        blocks = -(-t // rows)
        # the fewest blocks of w warps that hold t, none of them empty ...
        assert blocks == -(-t // held)
        assert (blocks - 1) * rows < t
        # ... and split evenly: a smaller block would not hold the rows
        padded = -(-t // BF16_GROUP_ROWS) * BF16_GROUP_ROWS
        assert blocks * (rows - BF16_GROUP_ROWS) < padded


@pytest.mark.parametrize("t,want", [
    (1, (4, 64)), (64, (4, 64)), (65, (8, 128)), (100, (8, 128)),
    (197, (8, 128)), (257, (8, 128)), (320, (8, 128)), (577, (8, 128)),
])
def test_tiling_rule(t, want):
    """One warpgroup a block up to 64 rows, two above."""
    assert bf16_tiling(t) == want


@pytest.mark.parametrize("t,warps,want", [
    (197, 4, (4, 64)), (197, 8, (8, 128)), (40, 8, (8, 64)),
    (300, 8, (8, 128)), (129, 8, (8, 128)), (1025, 4, (4, 64)),
])
def test_tiling_of_a_named_design(t, warps, want):
    assert bf16_tiling(t, warps) == want


def test_tiling_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        bf16_tiling(0)
    with pytest.raises(ValueError):
        bf16_tiling(64, 2)
    with pytest.raises(ValueError):
        bf16_tiling(64, 16)


def test_dtype_dispatch_to_the_entry_points():
    assert btd_entry(torch.bfloat16) == "mit_flash_attention_btd_bf16"
    assert btd_entry(torch.float32) == "mit_flash_attention_btd_f32"
    with pytest.raises(TypeError):
        btd_entry(torch.float16)
    # the bf16 entries take the tiling's integers, the f32 entry does not
    n = lambda name: len(kernels.ENTRY_POINTS[name])
    assert n(btd_entry(torch.bfloat16)) == n(btd_entry(torch.float32)) + len(
        bf16_tiling(1))
    assert "mit_flash_attention_btd_bf16_cudacore" in kernels.ENTRY_POINTS


def test_ops_do_not_reach_the_cudacore_bf16_entry():
    """The entries of the first CUDA-core kernel are for measurements: no
    module of the port calls them (every path runs the f32 kernel or the
    tensor-core kernel)."""
    root = kernels.CSRC.parent
    assert "mit_flash_attention_v1" in kernels.ENTRY_POINTS
    for path in root.rglob("*.py"):
        if path == root / "kernels" / "__init__.py":
            continue
        text = path.read_text()
        assert "bf16_cudacore" not in text, path
        assert "mit_flash_attention_v1" not in text, path


# ----------------------------------------------------------------------
# the kernel's walk over the key tiles, replayed in plain PyTorch
# ----------------------------------------------------------------------
BN, NEG, ROW_MASKED = 64, -1e9, -5e8


def _replay(q, k, v, pad, causal, rows):
    """flash_attention_btd_tc_kernel's schedule for one head in f32 tensors:
    blocks of ``rows`` query rows, 64-key tiles, the online softmax with p
    rounded to bf16, the end of a causal walk at the block's diagonal and
    the block's vote there. Returns the output and the tiles walked."""
    t, s = q.shape[0], k.shape[0]
    out = torch.zeros(t, 64)
    walked = 0
    nkt = -(-s // BN)
    for q0 in range(0, t, rows):
        rws = torch.arange(q0, min(q0 + rows, t))
        m = torch.full((len(rws),), -torch.inf)
        l, o = torch.zeros(len(rws)), torch.zeros(len(rws), 64)
        kt_end = min(nkt, int(rws[-1]) // BN + 1) if causal else nkt
        kt = 0
        while kt < kt_end:
            cols = torch.arange(kt * BN, min((kt + 1) * BN, s))
            walked += 1
            x = q[rws] @ k[cols].T * 0.125
            if causal:
                x = x + torch.where(cols[None] <= rws[:, None], 0.0, NEG)
            if pad is not None:
                x = x + pad[cols][None]
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[:, None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ v[cols]
            m = m_new
            if kt + 1 == kt_end and bool((m <= ROW_MASKED).any()):
                kt_end = nkt
            kt += 1
        out[rws] = o / l[:, None]
    return out, walked


def _head_inputs(t, s, seed, pad_share=0.3):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float()
    q, k = to(r.normal(size=(t, 64))), to(r.normal(size=(s, 64)))
    v = to(r.uniform(-1, 1, size=(s, 64)))
    pad = torch.from_numpy(
        np.where(r.random(s) < pad_share, NEG, 0.0).astype(np.float32))
    return q, k, v, pad


@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("t,s,causal,padded", [
    (197, 197, False, False), (100, 100, True, True), (33, 130, True, True),
    (150, 70, True, True), (17, 16, False, True), (1, 1, True, True),
    (260, 257, True, False),
])
def test_tile_walk_matches_plain(warps, t, s, causal, padded):
    q, k, v, pad = _head_inputs(t, s, seed=t + s)
    if padded:
        pad[0] = NEG         # query row 0 of a causal call sees a pad only
    else:
        pad = None
    rows = bf16_tiling(t, warps)[1]
    out, walked = _replay(q, k, v, pad, causal, rows)
    ref = flash_attention_btd_reference(
        q[None].bfloat16(), k[None].bfloat16(), v[None].bfloat16(),
        None if pad is None else pad[None], causal, 64)[0].float()
    assert torch.isfinite(out).all()
    # p is rounded to bf16 against a running max: one bf16 rounding apart,
    # and the plain version's output is itself rounded to bf16
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    if causal and pad is None:
        # a causal walk ends at the diagonal: fewer tiles than all of them
        assert walked < -(-t // rows) * -(-s // BN) or s <= BN or t <= rows


@pytest.mark.parametrize("t,s", [(100, 100), (40, 200), (130, 130)])
def test_tile_walk_keeps_fully_masked_rows_uniform(t, s):
    """Every key padded: row i is uniform over keys 0..i, the keys that
    share its maximum (-1e9 against the causal -2e9), and never NaN."""
    q, k, v, _ = _head_inputs(t, s, seed=7)
    pad = torch.full((s,), NEG)
    out, _ = _replay(q, k, v, pad, True, bf16_tiling(t)[1])
    want = torch.stack([v[:min(i + 1, s)].mean(0) for i in range(t)])
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def test_tile_walk_matches_jax_kernel():
    """The walk against the JAX package's kernel in interpret mode."""
    t = s = 100
    q, k, v, pad = _head_inputs(t, s, seed=11)
    out, _ = _replay(q, k, v, pad, True, bf16_tiling(t)[1])
    j = lambda x: jnp.asarray(x[None].numpy(), jnp.bfloat16)
    ref = jax_flash_btd(j(q), j(k), j(v), jnp.asarray(pad[None].numpy()),
                        True, 64)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref[0].astype(jnp.float32)),
                               rtol=0, atol=1e-2)


# ----------------------------------------------------------------------
# flash_attention (B, H, T, hd) in bf16: the kernel's two walks
# ----------------------------------------------------------------------
def _replay_two_walks(q, k, v, pad, causal, rows):
    """The tensor-core kernel's NORM mode for one head in f32 tensors: a
    first walk over the key tiles for the row max and the row sum (online:
    the sum is rescaled when the max grows), the block's vote at the end of
    it, which lengthens both walks past the diagonal, then a second walk
    with p = exp(x - max) * (1 / sum) rounded to bf16 and multiplied; nothing
    is divided at the end. Returns the output and the tiles of one walk."""
    t, s = q.shape[0], k.shape[0]
    out = torch.zeros(t, 64)
    walked = 0
    nkt = -(-s // BN)

    def scores(rws, kt):
        cols = torch.arange(kt * BN, min((kt + 1) * BN, s))
        x = q[rws] @ k[cols].T * 0.125
        if causal:
            x = x + torch.where(cols[None] <= rws[:, None], 0.0, NEG)
        if pad is not None:
            x = x + pad[cols][None]
        return cols, x

    for q0 in range(0, t, rows):
        rws = torch.arange(q0, min(q0 + rows, t))
        m = torch.full((len(rws),), -torch.inf)
        l = torch.zeros(len(rws))
        kt_end = min(nkt, int(rws[-1]) // BN + 1) if causal else nkt
        kt = 0
        while kt < kt_end:
            _, x = scores(rws, kt)
            m_new = torch.maximum(m, x.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(x - m_new[:, None]).sum(-1)
            m = m_new
            if kt + 1 == kt_end and bool((m <= ROW_MASKED).any()):
                kt_end = nkt
            kt += 1
        walked += kt_end
        inv = 1.0 / l
        o = torch.zeros(len(rws), 64)
        for kt in range(kt_end):
            cols, x = scores(rws, kt)
            p = torch.exp(x - m[:, None]) * inv[:, None]
            o = o + p.to(torch.bfloat16).float() @ v[cols]
        out[rws] = o
    return out, walked


@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("t,s,causal,padded", [
    (577, 577, False, False), (100, 100, True, True), (33, 130, True, True),
    (150, 70, True, True), (17, 16, False, True), (1, 1, True, True),
    (260, 257, True, False), (197, 197, True, True),
])
def test_two_walks_match_plain(warps, t, s, causal, padded):
    q, k, v, pad = _head_inputs(t, s, seed=t + s + 1)
    if padded:
        pad[0] = NEG         # query row 0 of a causal call sees a pad only
    else:
        pad = None
    rows = bf16_tiling(t, warps)[1]
    out, walked = _replay_two_walks(q, k, v, pad, causal, rows)
    four = lambda x: x[None, None].bfloat16()
    ref = flash_attention_reference(
        four(q), four(k), four(v), None if pad is None else pad[None],
        causal)[0, 0].float()
    assert torch.isfinite(out).all()
    # p is the reference's number before it is rounded, up to f32 rounding
    # of the sum: an element apart by one bf16 rounding of p at most, and
    # the plain version's output is itself rounded to bf16
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    if causal and pad is None:
        assert walked < -(-t // rows) * -(-s // BN) or s <= BN or t <= rows


@pytest.mark.parametrize("t,s", [(100, 100), (40, 200), (130, 130)])
def test_two_walks_keep_fully_masked_rows_uniform(t, s):
    q, k, v, _ = _head_inputs(t, s, seed=9)
    pad = torch.full((s,), NEG)
    out, _ = _replay_two_walks(q, k, v, pad, True, bf16_tiling(t)[1])
    want = torch.stack([v[:min(i + 1, s)].mean(0) for i in range(t)])
    # 1 / count rounded to bf16 before the product
    torch.testing.assert_close(out, want, rtol=0, atol=4e-3)


def test_two_walks_match_jax_kernel():
    """The two walks against the JAX package's (B, H, T, hd) kernel in
    interpret mode."""
    t = s = 100
    q, k, v, pad = _head_inputs(t, s, seed=12)
    out, _ = _replay_two_walks(q, k, v, pad, True, bf16_tiling(t)[1])
    j = lambda x: jnp.asarray(x[None, None].numpy(), jnp.bfloat16)
    ref = jax_flash(j(q), j(k), j(v), jnp.asarray(pad[None].numpy()), True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref[0, 0].astype(jnp.float32)),
                               rtol=0, atol=1e-2)


# ----------------------------------------------------------------------
# the f32 kernel's walk: one pass, online softmax, 128-row blocks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,s,causal,padded", [
    (577, 577, False, False), (197, 197, False, False), (100, 100, True, True),
    (33, 130, True, True), (130, 5, True, True),
])
def test_f32_walk_matches_plain(t, s, causal, padded):
    """(sum p v) / l with p against a running max, nothing rounded: the
    (B, H, T, hd) reference (normalized first) and the (B, T, D) reference
    (divided last) both, to f32 rounding."""
    r = np.random.default_rng(t + s)
    to = lambda a: torch.from_numpy(a.astype(np.float32))
    q, k = to(r.normal(size=(t, 64))), to(r.normal(size=(s, 64)))
    v = to(r.uniform(-1, 1, size=(s, 64)))
    pad = None
    if padded:
        pad = to(np.where(r.random(s) < 0.3, NEG, 0.0))
        pad[0] = NEG
    out = torch.zeros(t, 64)
    for q0 in range(0, t, 128):
        rws = torch.arange(q0, min(q0 + 128, t))
        m = torch.full((len(rws),), -torch.inf)
        l, o = torch.zeros(len(rws)), torch.zeros(len(rws), 64)
        for k0 in range(0, s, BN):
            cols = torch.arange(k0, min(k0 + BN, s))
            x = q[rws] @ k[cols].T * 0.125
            if causal:
                x = x + torch.where(cols[None] <= rws[:, None], 0.0, NEG)
            if pad is not None:
                x = x + pad[cols][None]
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[:, None])
            l, o, m = l * alpha + p.sum(-1), o * alpha[:, None] + p @ v[cols], m_new
        out[rws] = o / l[:, None]
    padb = None if pad is None else pad[None]
    ref4 = flash_attention_reference(q[None, None], k[None, None],
                                     v[None, None], padb, causal)[0, 0]
    ref3 = flash_attention_btd_reference(q[None], k[None], v[None], padb,
                                         causal, 64)[0]
    torch.testing.assert_close(out, ref4, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, ref3, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# the dropout forward: which (row, key) an accumulator element stands for
# ----------------------------------------------------------------------
def _fragment_map(t, s, warps):
    """(row, key) of every accumulator element the bf16 dropout forward
    draws a keep bit for, as dropout_fwd_tc_kernel computes them: blocks of
    16 * warps query rows, a warpgroup of 4 warps to 64 rows, two key tiles
    of 64; in a warp, lane (g, t4) = (lane // 4, lane % 4) holds of each
    8-key tile nt the elements e = 0..3 at row g + 8 (e // 2), key
    8 nt + 2 t4 + e % 2 (frag_row and frag_col of csrc/wgmma.cuh)."""
    pairs = []
    for q0 in range(0, t, 16 * warps):
        for warp in range(warps):
            grow = q0 + (warp // 4) * 64
            if grow >= t:
                continue
            for lane in range(32):
                for kt in range(2):
                    for nt in range(8):
                        for e in range(4):
                            row = grow + (warp % 4) * 16 + lane // 4 + 8 * (e // 2)
                            col = kt * 64 + nt * 8 + 2 * (lane % 4) + e % 2
                            pairs.append((row, col))
    return pairs


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("t,s", [(99, 99), (128, 128), (7, 9), (65, 64)])
def test_dropout_forward_fragments_cover_every_element_once(t, s, warps):
    pairs = _fragment_map(t, s, warps)
    assert len(pairs) == len(set(pairs))            # nothing drawn twice
    inside = {(r, c) for r, c in pairs if r < t and c < s}
    assert inside == {(r, c) for r in range(t) for c in range(s)}
