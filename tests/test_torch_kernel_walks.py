"""The walks of three CUDA kernels, replayed on the CPU.

``csrc/int8_gemm.cu``, ``csrc/decode_layer.cu`` and the bf16 backward of
``csrc/flash_attention_dropout.cu`` cannot run here, but how they cut their
work can be mirrored step by step in PyTorch:

- ``int8_gemm``: a persistent grid of blocks walks 128 x 128 output tiles
  (tile ``blockIdx + i * grid``) as one flat sequence of 128-byte k-steps
  through a ring of STAGES shared-memory stages that one producer fills;
  two consumer warpgroups take the tiles in turn, four k32 products of two
  64-row halves a step. The replay checks that every step finds its slot
  filled under the phase it waits for and no slot is refilled before its
  step was released, that every output element is written exactly once,
  and that the int32 accumulators equal ``int8_accumulate``, over ragged
  M, N and K.
- ``fused_decode_layer``: a grid of blocks walks the layer in seven phases.
  A product is cut into items of 16 bytes of output columns by a slice of
  K; an item stages 64 rows by 128 k at a time, each of 8 warps owns 16 k
  of a tile and sums them in order (fused multiply-adds), the warps' sums
  are added in warp order and the slices' partial sums in slice order; the
  attention's P.V sums 16 interleaved groups of keys, then the groups. The
  replay checks that the items cover every output once and holds its result
  to ``fused_decode_layer_plain`` and to the JAX kernel (interpret mode).
- ``dropout_bwd_tc_kernel``: one block a (batch, head) cell, two
  warpgroups. In phase A warpgroup w owns query rows 64w .. 64w + 63 and
  computes p, pd, dp, the row's delta and ds for every key; a warp of 16 rows
  skips an 8-key tile that is exactly 0 (past S, rows past T, or above the
  diagonal of all its rows while each has seen an unmasked key) and stores
  zeros there; pd and ds enter the products as bf16 pairs hi + lo. dQ sums
  16 keys a step; in phase B warpgroup w owns keys 64w .. 64w + 63 and sums
  dV and dK 16 query rows a step. The replay checks that every skipped tile
  is 0 in the exact computation, that the pairs hold each value to 2^-16 of
  itself, that the row and key ownership covers the cell once, and holds
  the gradients to ``flash_attention_dropout_reference_backward`` and to
  the JAX kernel's VJP (interpret mode).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import step as jstep
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu.ops.pallas_decode_layer import fused_decode_layer as jax_fused_layer
from mit_tpu.ops.pallas_dropout_attention import (
    flash_attention_dropout as jax_flash_dropout,
)
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.ops import decode_layer as tlayer
from mit_tpu_torch.ops import dropout_attention as tdrop
from mit_tpu_torch.ops import int8_mlp
from mit_tpu_torch.ops.masks import NEG_INF
from mit_tpu_torch.ops.quant import int8_accumulate, kernel_layout

# ----------------------------------------------------------------------
# int8_gemm
# ----------------------------------------------------------------------
BM, BN, BK, STAGES, K32 = 128, 128, 128, 5, 32


class _Barrier:
    """An mbarrier's phases: a wait on parity p passes while the current
    (incomplete) phase's parity is not p, as on the card; so a fresh barrier
    passes a wait on parity 1."""

    def __init__(self, count):
        self.count, self.arrived, self.done = count, 0, 0

    def passes(self, parity):
        return (self.done & 1) != parity

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.done = 0, self.done + 1


def _ring_schedule(mine, kt_n, rounds=None):
    """Runs one block's ring to its end, with the kernel's barriers and
    waits: the producer waits on empty[s] with parity ((j / S) & 1) ^ 1 and
    fills slot s = j % S with step j (k-step j % KT of the block's tile
    j // KT), which completes full[s]'s phase; consumer c takes tiles c,
    c + 2, ..., waits on order[c] before each but the block's first, on
    full[s] with parity (j / S) & 1 for each step, releases the step before
    (the wait for all but the newest group of products), arrives on
    order[1 - c] after its last step and then releases that step. Every
    step a consumer's wait lets through must be in its slot; the run must
    not deadlock. ``rounds`` orders the three actors' turns."""
    total = mine * kt_n
    full = [_Barrier(1) for _ in range(STAGES)]
    empty = [_Barrier(1) for _ in range(STAGES)]
    order = [_Barrier(1), _Barrier(1)]
    slot = {}
    nxt, released = 0, set()
    tiles = [list(range(c, mine, 2)) for c in (0, 1)]
    state = [{"t": 0, "kt": 0, "waited": False} for _ in (0, 1)]

    def producer():
        nonlocal nxt
        if nxt == total:
            return False
        s = nxt % STAGES
        if not empty[s].passes(((nxt // STAGES) & 1) ^ 1):
            return False
        assert slot.get(s) is None or slot[s] in released
        slot[s] = nxt
        full[s].arrive()
        nxt += 1
        return True

    def consumer(c):
        st = state[c]
        if st["t"] == len(tiles[c]):
            return False
        i = tiles[c][st["t"]]
        if st["kt"] == 0 and not st["waited"] and i > 0:
            n = st["t"]
            if not order[c].passes((n - 1 if c == 0 else n) & 1):
                return False
            st["waited"] = True
            return True
        j = i * kt_n + st["kt"]
        s = j % STAGES
        if not full[s].passes((j // STAGES) & 1):
            return False
        assert slot.get(s) == j, f"step {j} found slot {s} holding {slot.get(s)}"
        if st["kt"]:
            released.add(j - 1)
            empty[(j - 1) % STAGES].arrive()
        st["kt"] += 1
        if st["kt"] == kt_n:
            if i + 1 < mine:
                order[1 - c].arrive()
            released.add(j)
            empty[s].arrive()
            st.update(t=st["t"] + 1, kt=0, waited=False)
        return True

    actors = [producer, lambda: consumer(0), lambda: consumer(1)]
    turn = 0
    while nxt < total or any(st["t"] < len(t) for st, t in zip(state, tiles)):
        moved = False
        for k in (rounds or (0, 1, 2)):
            moved |= actors[(k + turn) % 3]()
        turn += 1
        assert moved, "the ring deadlocks"
    assert released == set(range(total))


def replay_int8_gemm(a8, w8, sms):
    """The accumulators of the kernel's walk on a card with ``sms`` SMs,
    and how often each output element was written. A block's producer
    fills ring slot j % STAGES with step j (k-step j % KT of the block's
    tile j // KT) once the slot's previous step was released; consumer
    warpgroup c takes the block's tiles c, c + 2, ... and releases a step's
    slot once its products are done."""
    m, k = a8.shape
    n = w8.shape[1]
    tiles_n = -(-n // BN)
    tiles = -(-m // BM) * tiles_n
    kt_n = -(-k // BK)
    grid = min(tiles, sms)
    # TMA's zero fill past M, N and K
    a = torch.zeros(-(-m // BM) * BM, kt_n * BK, dtype=torch.int64)
    a[:m, :k] = a8.long()
    bt = torch.zeros(tiles_n * BN, kt_n * BK, dtype=torch.int64)
    bt[:n, :k] = w8.t().long()
    out = torch.zeros(m, n, dtype=torch.int64)
    writes = torch.zeros(m, n, dtype=torch.int64)
    for blk in range(grid):
        mine = (tiles - 1 - blk) // grid + 1
        _ring_schedule(mine, kt_n)
        for c in (0, 1):                   # the two consumer warpgroups
            for i in range(c, mine, 2):
                tile = blk + i * grid
                m0, n0 = tile // tiles_n * BM, tile % tiles_n * BN
                acc = torch.zeros(2, 64, BN, dtype=torch.int64)
                for kt in range(kt_n):
                    for kk in range(BK // K32):
                        ks = slice(kt * BK + kk * K32, kt * BK + (kk + 1) * K32)
                        for h in range(2):
                            rows = a[m0 + 64 * h:m0 + 64 * h + 64, ks]
                            prod = rows @ bt[n0:n0 + BN, ks].t()
                            acc[h] = prod if kt == 0 and kk == 0 else \
                                acc[h] + prod
                # the epilogue: a warp's 8 rows at a time, rows past M and
                # columns past N not stored
                for h in range(2):
                    for r0 in range(m0 + 64 * h, m0 + 64 * h + 64, 8):
                        r1, c1 = min(m, r0 + 8), min(n, n0 + BN)
                        if r0 < r1:
                            out[r0:r1, n0:c1] = acc[h, r0 - m0 - 64 * h:
                                                    r1 - m0 - 64 * h, :c1 - n0]
                            writes[r0:r1, n0:c1] += 1
    return out, writes


@pytest.mark.parametrize("m,k,n,sms", [
    (64, 592, 1024, 132),       # the last layer's CLS rows; CLIP's patch K
    (197, 768, 768, 3),         # ViT-B's out-projection, three SMs
    (300, 144, 776, 5),         # ragged M and N, K past one k-step
    (7, 48, 40, 132),           # less than one tile and one k-step
    (129, 256, 384, 2),         # a second row tile of one row
    (130, 3072, 200, 4),        # fc2's K, ragged N
])
def test_int8_gemm_walk_covers_once_and_is_exact(m, k, n, sms):
    r = np.random.default_rng(m + k + n)
    a8 = torch.from_numpy(r.integers(-127, 128, (m, k)).astype(np.int8))
    w8 = kernel_layout(torch.from_numpy(
        r.integers(-127, 128, (k, n)).astype(np.int8)))
    a8[0] = 127                                 # 127² · K: past f32's 2²⁴
    out, writes = replay_int8_gemm(a8, w8, sms)
    assert bool((writes == 1).all())
    assert torch.equal(out.to(torch.int32), int8_accumulate(a8, w8))
    q = int8_mlp.QuantizedLinear(w8, torch.ones(n))
    assert torch.equal(out.to(torch.int32), int8_mlp.int8_gemm(
        a8, torch.ones(m), q, out_dtype=torch.int32))


@pytest.mark.parametrize("rounds", [(0, 1, 2), (1, 2, 0), (2, 1, 0)],
                         ids=["producer-first", "consumers-first", "c1-first"])
@pytest.mark.parametrize("mine,kt_n", [(1, 1), (2, 1), (5, 24), (9, 6),
                                       (3, 2), (4, 5), (14, 6)])
def test_int8_gemm_ring_neither_deadlocks_nor_overwrites(mine, kt_n, rounds):
    """The ring's protocol alone, at tile and k-step counts of the path's
    shapes (fc2: 24 k-steps; ViT-B's qkv at 132 SMs: 14 tiles a block), in
    three orders of the actors' turns."""
    _ring_schedule(mine, kt_n, rounds)


# ----------------------------------------------------------------------
# fused_decode_layer
# ----------------------------------------------------------------------
RC, KTILE, NW, KW = 64, 128, 8, 16
D, H, HD, F_SMALL = 512, 8, 64, 256


def _fma(a, b, c):
    """a * b + c rounded once to f32 (through f64; a double rounding is
    rarer than the tolerances care about)."""
    return (a.double() * b.double() + c.double()).float()


def replay_product(inp, w, ks, grid, itemsize):
    """(ks, B, N) partial sums of inp (B, K) . w (K, N), in the kernel's
    order; the items' assignment to blocks checked to cover each once."""
    b, k = inp.shape
    n = w.shape[1]
    v = 16 // itemsize
    groups = n // v
    assert groups * v == n
    items = Counter(it for blk in range(grid)
                    for it in range(blk, groups * ks, grid))
    assert sorted(items) == list(range(groups * ks))
    assert set(items.values()) == {1}
    kchunk = -(-(-(-k // ks)) // 16) * 16
    spans = [(s * kchunk, min(k, s * kchunk + kchunk)) for s in range(ks)]
    assert sum(max(0, kb - ka) for ka, kb in spans) == k
    part = torch.zeros(ks, b, n)
    for s, (ka, kb) in enumerate(spans):
        for r0 in range(0, b, RC):
            rows = slice(r0, min(b, r0 + RC))
            acc = torch.zeros(NW, rows.stop - r0, n)
            for kt in range(ka, kb, KTILE):
                for j in range(KW):
                    for wp in range(NW):
                        kk = kt + wp * KW + j
                        if kk < min(kb, kt + KTILE):
                            acc[wp] = _fma(inp[rows, kk, None], w[kk],
                                           acc[wp])
            total = acc[0]
            for wp in range(1, NW):
                total = total + acc[wp]
            part[s, rows] = total
    return part


def replay_decode_layer(x, pos, madd, k_cache, v_cache, cross, lay, eps,
                        grid, ks):
    """The kernel's seven phases over one layer (packed operands)."""
    w = lay.layers[0]
    cd = x.dtype
    rnd = lambda a: a.to(cd).float()
    size = torch.finfo(cd).bits // 8
    b, t, _ = k_cache.shape
    f32 = lambda name: w[name].float()
    # 1. qkv (f32)
    qkv = replay_product(x.float(), f32("wqkv"), 1, grid, size)[0] + w["bqkv"]
    q, kn, vn = qkv.split(D, dim=-1)
    # 2. attention: a quad of warps (two a block) to a (row, head)
    pairs = Counter(it for blk in range(grid)
                    for quad in range(2)
                    for it in range(blk * 2 + quad, b * H, grid * 2))
    assert sorted(pairs) == list(range(b * H)) and set(pairs.values()) == {1}
    heads = lambda a: a.reshape(b, -1, H, HD) if a.dim() == 3 else \
        a.reshape(b, H, HD)
    kc, vc = heads(k_cache.float()), heads(v_cache.float())
    qh, knh, vnh = heads(q), heads(kn), heads(vn)
    at_pos = torch.arange(t)[None, :] == pos[:, None]             # (B, T)
    s = torch.zeros(b, H, t)
    for e in range(HD):
        key = torch.where(at_pos[:, :, None], knh[:, None, :, e],
                          kc[:, :, :, e]).transpose(1, 2)          # (B, H, T)
        s = _fma(qh[:, :, e, None], key, s)
    s = s * 0.125 + madd[:, None, :]
    e_ = torch.exp(s - s.amax(-1, keepdim=True))
    den = e_.sum(-1, keepdim=True)
    ppos = torch.where(at_pos[:, None, :], e_, 0.0).sum(-1, keepdim=True)
    p = torch.where(at_pos[:, None, :], 0.0, e_)
    # P.V: 16 groups of keys (t = g, g + 16, ...), each summed in order,
    # then the groups in order
    acc = torch.zeros(16, b, H, HD)
    for g in range(16):
        for tt in range(g, t, 16):
            acc[g] = _fma(p[:, :, tt, None], vc[:, tt], acc[g])
    total = acc[0]
    for g in range(1, 16):
        total = total + acc[g]
    ctx = rnd((_fma(ppos, vnh, total) / den).reshape(b, D))

    def ln(v, i):
        mean = v.mean(-1, keepdim=True)
        var = ((v - mean) ** 2).mean(-1, keepdim=True)
        return (v - mean) * torch.rsqrt(var + eps) * w[f"ln{i}s"] + \
            w[f"ln{i}b"]

    # 3.-4. out-projection in ks slices, LN1, + cross, LN2
    part = replay_product(ctx, f32("wo"), ks, grid, size)
    x2 = ln(ln(x.float() + (part.sum(0) + w["bo"]), 1) + cross, 2)
    # 5.-7. w1 + ReLU, w2 in ks slices, LN3
    mid = rnd(torch.relu(replay_product(rnd(x2), f32("w1"), 1, grid,
                                        size)[0] + w["b1"]))
    part = replay_product(mid, f32("w2"), ks, grid, size)
    x3 = ln(x2 + (part.sum(0) + w["b2"]), 3)
    return x3.to(cd), kn.to(cd), vn.to(cd)


@pytest.fixture(scope="module")
def decoder512():
    cfg = JDecoderConfig(vocab_size=90, embed_dim=D, num_heads=H,
                         num_layers=1, ff_dim=F_SMALL, max_seq_len=24,
                         dropout=0.0, pad_idx=0)
    p = jax.tree.map(np.asarray,
                     init_decoder_params(jax.random.PRNGKey(5), cfg))
    r = np.random.default_rng(11)
    for name in ("ln1", "ln2", "ln3"):
        p["layers"][name] = {
            "scale": (1 + 0.1 * r.normal(size=(1, D))).astype(np.float32),
            "bias": (0.1 * r.normal(size=(1, D))).astype(np.float32)}
    for grp, keys in (("self", ("bq", "bk", "bv", "bo")), ("ffn", ("b1", "b2"))):
        for k in keys:
            shape = p["layers"][grp][k].shape
            p["layers"][grp][k] = (0.1 * r.normal(size=shape)).astype(np.float32)
    return p


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# x' and the fresh rows (tests/test_torch_decode_layer.py), at width 512
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (0.05, 0.05)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sms", [(3, 132), (64, 132), (64, 5)])
def test_decode_layer_walk_matches_plain_and_jax(decoder512, b, sms, dtype):
    t = 7
    r = np.random.default_rng(b)
    x = r.normal(size=(b, D)).astype(np.float32)
    kc, vc = (r.normal(size=(b, t, D)).astype(np.float32) for _ in range(2))
    cross = r.normal(size=(b, D)).astype(np.float32)
    pos = r.integers(0, t, b).astype(np.int32)
    visible = np.arange(t)[None, :] <= pos[:, None]
    visible &= r.random((b, t)) > 0.2
    madd = np.where(visible, 0.0, NEG_INF).astype(np.float32)
    madd[1] = NEG_INF                            # a fully masked row
    cast = lambda a: torch.from_numpy(a).to(dtype)
    lay = tlayer.pack_decode_layers(tstep.prepare_decode_params(
        params_from_jax(decoder512), dtype)["layers"])
    grid, ks = tlayer.decode_layer_plan(dtype, sms)
    args = (cast(x), torch.from_numpy(pos), torch.from_numpy(madd), cast(kc),
            cast(vc), torch.from_numpy(cross), lay)
    out = replay_decode_layer(*args, 1e-5, grid, ks)
    plain = tlayer.fused_decode_layer_plain(*args, 0, H)
    jlay = jstep.prepare_decode_params(decoder512, JDT[dtype])["layers"]
    theirs = jax_fused_layer(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(pos), jnp.asarray(madd),
        jnp.asarray(kc, JDT[dtype]), jnp.asarray(vc, JDT[dtype]),
        jnp.asarray(cross), jlay, 0, H, interpret=True)
    xtol, rtol = TOL[dtype]
    for o, pl, j, tol in zip(out, plain, theirs, (xtol, rtol, rtol)):
        assert o.dtype == dtype and bool(torch.isfinite(o).all())
        assert (o.float() - pl.float()).abs().max().item() <= tol
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=tol, atol=tol)



# ----------------------------------------------------------------------
# the bf16 dropout-attention backward on the tensor cores
# ----------------------------------------------------------------------
ROWS = 128                   # a cell's query rows and keys, whole tiles
ROW_MASKED = -5e8            # a row whose max is below has seen no unmasked key


def _quad_sum(x):
    """Row sums (.., 128) as the kernel takes them: lane t of a quad sums
    its columns 8n + 2t, + 1 in order over n, then the quad adds lanes one
    apart, then two apart."""
    cols = torch.arange(ROWS).reshape(-1, 4, 2)            # (n, t, e)
    part = torch.zeros(x.shape[:-1] + (4,))
    for n in range(cols.shape[0]):
        for e in range(2):
            part = part + x[..., cols[n, :, e]]
    pair = part[..., [0, 0, 2, 2]] + part[..., [1, 1, 3, 3]]
    return (pair[..., 0] + pair[..., 2])[..., None]


def split_pairs(x):
    """hi = bf16(x), lo = bf16(x - hi), as f32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def replay_dropout_backward(q, k, v, pad, do, seed, causal, rate):
    """dropout_bwd_tc_kernel over (B, H, T|S, 64) bf16 tensors → (dq, dk,
    dv) in bf16, and the count of 8-key tiles that warps with a row below T
    skipped."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    assert hd == 64 and tdrop.dropout_bwd_kernel_for(q.dtype, hd, t, s) == \
        "tensor_cores"
    n = b * h
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)

    def tiles(x, valid):               # whole 128-row tiles, zero past valid
        out = torch.zeros(n, ROWS, hd)
        out[:, :valid] = x.reshape(n, valid, hd).float()
        return out

    qs, dos, ks, vs = tiles(q, t), tiles(do, t), tiles(k, s), tiles(v, s)
    padc = torch.full((n, ROWS), 0.0)
    padc[:, :s] = pad.repeat_interleave(h, 0)
    row = torch.arange(ROWS)[:, None]
    col = torch.arange(ROWS)[None, :]
    keep = torch.zeros(n, ROWS, ROWS, dtype=torch.bool)
    keep[:, :t, :s] = tdrop.keep_mask(t, s, rate, seed, torch.arange(n))

    # phase A: warpgroup w's rows; every (row, key) of the cell
    x = torch.einsum("nrd,ncd->nrc", qs, ks) * torch.tensor(0.125)
    if causal:
        x = x + torch.where(col <= row, 0.0, NEG_INF)
    x = torch.where(col < s, x + padc[:, None, :], -torch.inf)
    m = x.amax(-1, keepdim=True)
    seen = ((m > ROW_MASKED) | (row >= t)).reshape(n, ROWS // 16, 16).all(-1)
    # dead 8-key tiles of each warp's 16 rows: (n, 8 warps, 16 tiles)
    wrow = torch.arange(0, ROWS, 16)[None, :, None]
    tcol = torch.arange(0, ROWS, 8)[None, None, :]
    dead8 = (tcol >= s) | (wrow >= t) | (causal & seen[..., None]
                                         & (tcol > wrow + 15))
    dead = dead8.repeat_interleave(16, 1).repeat_interleave(8, 2)
    e = torch.where(dead, 0.0, torch.exp(x - m))
    p = e / _quad_sum(e)
    kp = keep & (row < t)
    pd = torch.where(kp & ~dead, p * inv, 0.0)
    dp = torch.where(kp & ~dead, torch.einsum("nrd,ncd->nrc", dos, vs) * inv,
                     0.0)
    delta = _quad_sum(dp * p)
    ds = torch.where(dead, 0.0, p * (dp - delta))

    # the skipped tiles are 0 in the exact computation, the plain formulas
    # on the same f32 inputs
    x_ref = torch.where(col < s, x, -torch.inf)
    p_ref = torch.softmax(x_ref, -1)
    dp_ref = torch.where(kp, torch.einsum("nrd,ncd->nrc", dos, vs) * inv, 0.0)
    ds_ref = p_ref * (dp_ref - (dp_ref * p_ref).sum(-1, keepdim=True))
    assert not (torch.where(kp, p_ref, 0.0)[dead]).any()
    assert not ds_ref[dead].any()

    pd_hi, pd_lo = split_pairs(pd)
    ds_hi, ds_lo = split_pairs(ds)
    for x_, hi, lo in ((pd, pd_hi, pd_lo), (ds, ds_hi, ds_lo)):
        assert ((x_ - (hi + lo)).abs() <= 2.0 ** -16 * x_.abs()).all()

    # dQ by the rows' owner, 16 keys a step; dV and dK by the keys' owner,
    # 16 query rows a step: each row and each key owned once
    owners = [slice(64 * w, 64 * w + 64) for w in range(ROWS // 64)]
    assert torch.cat([torch.arange(ROWS)[o] for o in owners]).tolist() == \
        list(range(ROWS))
    dq = torch.zeros(n, ROWS, hd)
    dk = torch.zeros(n, ROWS, hd)
    dv = torch.zeros(n, ROWS, hd)
    for own in owners:
        for kk in range(ROWS // 16):
            step = slice(16 * kk, 16 * kk + 16)
            for part in (ds_hi, ds_lo):
                dq[:, own] += part[:, own, step] @ ks[:, step]
            for part in (pd_hi, pd_lo):
                dv[:, own] += part[:, step, own].transpose(1, 2) @ dos[:, step]
            for part in (ds_hi, ds_lo):
                dk[:, own] += part[:, step, own].transpose(1, 2) @ qs[:, step]
    out = lambda a, m_: (a[:, :m_] * (0.125 if a is not dv else 1.0)).to(
        torch.bfloat16).reshape(b, h, m_, hd)
    # the 8-key tiles skipped below T (past T every tile is)
    skipped = int(dead8[:, :-(-t // 16)].sum())
    return (out(dq, t), out(dk, s), out(dv, s)), skipped


def _dropout_inputs(b, h, t, s, seed):
    """bf16 q, k ~ N(0, 1), v ~ U(-1, 1), do ~ N(0, 1); a fifth of the keys
    padded, every key of batch row 0."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    q, do = to(r.normal(size=(b, h, t, 64))), to(r.normal(size=(b, h, t, 64)))
    k = to(r.normal(size=(b, h, s, 64)))
    v = to(r.uniform(-1, 1, size=(b, h, s, 64)))
    pad = np.where(r.random((b, s)) > 0.8, NEG_INF, 0.0).astype(np.float32)
    pad[0] = NEG_INF
    return q, k, v, pad, do


def _norm_err(a, b):
    """Max abs difference over b's largest value (1 where b is all 0)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() if b.any() else 1.0)).item()


def _check_dropout_backward(q, k, v, pad, do, seed, causal, rate):
    (dq, dk, dv), skipped = replay_dropout_backward(
        q, k, v, torch.from_numpy(pad), do, seed, causal, rate)
    plain = tdrop.flash_attention_dropout_reference_backward(
        q, k, v, torch.from_numpy(pad), do, seed, causal, rate)
    jx = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(
        lambda a, b_, c: jax_flash_dropout(a, b_, c, jnp.asarray(pad),
                                           jnp.int32(seed), causal, rate),
        jx(q), jx(k), jx(v))
    theirs = vjp(jx(do))
    for g, pl, j in zip((dq, dk, dv), plain, theirs):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert _norm_err(g, pl) <= 1e-2
        assert _norm_err(g, torch.from_numpy(
            np.array(j.astype(jnp.float32)))) <= 1e-2
    return skipped


@pytest.mark.parametrize("b,h,t,s,causal", [
    (2, 2, 1, 1, False), (3, 2, 7, 9, False), (2, 2, 99, 99, True),
    (2, 2, 128, 128, True), (2, 1, 128, 128, False)])
def test_dropout_backward_walk_matches_plain_and_jax(b, h, t, s, causal):
    """bf16 gradients within 1e-2 of each one's largest value (the card
    test's bound); batch row 0 has every key padded."""
    q, k, v, pad, do = _dropout_inputs(b, h, t, s, seed=t + s)
    skipped = _check_dropout_backward(q, k, v, pad, do, 97, causal, 0.1)
    # past S, and above the diagonal
    assert (skipped > 0) == (s % 128 != 0 or (causal and t > 16))


def test_dropout_backward_walk_skips_nothing_a_row_without_a_key_sees():
    """Causal, batch row 1's first ten keys padded: its rows 0-9 see only
    padded keys, so their softmax spreads over every key that is not padded,
    above the diagonal too. Their warp skips no tile there, while the other
    warps still skip theirs."""
    b, h, t = 2, 2, 48
    q, k, v, pad, do = _dropout_inputs(b, h, t, t, seed=3)
    pad[1] = 0.0
    pad[1, :10] = NEG_INF
    p = tdrop._probs(q, k, torch.from_numpy(pad), True)
    assert (p[1, :, :10, 16:] > 0).all()   # above the diagonal of rows 0-15
    skipped = _check_dropout_backward(q, k, v, pad, do, 5, True, 0.25)
    assert skipped > 0
