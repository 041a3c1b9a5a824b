"""The walks of two CUDA kernels, replayed on the CPU.

``csrc/int8_gemm.cu`` and ``csrc/decode_layer.cu`` cannot run here, but how
they cut their work can be mirrored step by step in PyTorch:

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
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.ops import decode_layer as tlayer
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
