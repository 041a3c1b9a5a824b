"""The CUDA kernels of mit_tpu_torch against their plain PyTorch versions.

Torch only (no JAX), so the card's tests run without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` need an NVIDIA GPU and skip without one; they build
the kernels from ``mit_tpu_torch/csrc`` on first use. The rest check, on
the CPU, what surrounds the kernels: input validation, the launch counters
and the build's failure path.
"""

import numpy as np
import pytest
import torch

from mit_tpu_torch import kernels
from mit_tpu_torch.ops import (
    dropout_attention,
    encoder_fused,
    int8_layer,
    int8_mlp,
)
from mit_tpu_torch.ops.flash_attention import (
    BF16_WARPS,
    _check_cuda_inputs,
    _check_fusedqkv,
    bf16_tiling,
    flash_attention_btd,
    flash_attention_btd_fusedqkv,
    flash_attention_btd_fusedqkv_reference,
    flash_attention_btd_reference,
)
from mit_tpu_torch.ops.quant import QuantizedLinear, quantize_weight

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, s, d, padded, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    q, k = to(r.normal(size=(b, t, d))), to(r.normal(size=(b, s, d)))
    v = to(r.uniform(-1, 1, size=(b, s, d)))
    pad = None
    if padded:
        p = np.where(r.random((b, s)) > 0.7, -1e9, 0.0).astype(np.float32)
        p[0] = -1e9                      # batch row 0: every key masked
        pad = torch.from_numpy(p).to(device)
    return q, k, v, pad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,s,d,causal,padded", [
    (4, 197, 197, 768, False, False),    # encoder
    (4, 100, 100, 512, True, True),      # decoder self-attention
    (2, 577, 577, 768, False, False),    # BLIP-384: K/V exceed shared memory
    (3, 13, 70, 128, True, True),        # ragged tiles, T != S
    (2, 1, 1, 64, False, True),
    (2, 33, 65, 64, False, True),
    # the bf16 kernel's tiling: 16-row warps, 64-key tiles, 16-key steps
    (2, 16, 15, 64, False, False),
    (2, 17, 16, 128, False, True),
    (2, 15, 17, 64, True, False),
    (2, 64, 63, 512, False, True),
    (2, 65, 64, 128, True, True),        # causal, T > S
    (2, 63, 65, 128, True, True),        # causal, T < S
    (2, 129, 128, 64, False, False),
    (2, 197, 208, 768, False, True),
    (2, 208, 197, 128, True, True),
    (2, 256, 257, 64, True, False),
    (1, 257, 256, 1024, False, False),   # CLIP ViT-L
    (1, 300, 577, 128, True, True),      # streaming, causal with T < S
    (1, 577, 100, 64, True, True),       # causal with T > S
    (2, 5, 577, 64, False, True),
])
def test_kernel_matches_plain_on_card(cuda, dtype, b, t, s, d, causal, padded):
    q, k, v, pad = _inputs(b, t, s, d, padded, dtype, cuda)
    before = flash_attention_btd.launches
    out = flash_attention_btd(q, k, v, pad, causal, 64)
    ref = flash_attention_btd_reference(q, k, v, pad, causal, 64)
    torch.cuda.synchronize()
    assert flash_attention_btd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert not torch.isnan(out).any()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if padded:
        # batch row 0: every key padded. Query row i comes out uniform over
        # the keys that share its maximum: all of them, or keys 0..i if causal
        heads = lambda x: x.float().reshape(x.shape[0], x.shape[1], -1, 64)
        want = torch.stack([
            heads(v)[0, :min(i + 1, s) if causal else s].mean(0)
            for i in range(t)])
        assert (heads(out)[0] - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("b,t,s,d,causal,padded", [
    (2, 197, 197, 128, False, False), (3, 100, 100, 128, True, True),
    (2, 70, 300, 64, True, True), (2, 300, 65, 64, True, True),
    (1, 577, 577, 64, False, True), (2, 1, 17, 64, False, False),
])
def test_bf16_tilings_match_plain_on_card(cuda, warps, b, t, s, d, causal,
                                          padded):
    """Both tilings of the bf16 kernel (one warpgroup a block, or two), not
    only the one the wrapper's rule picks."""
    q, k, v, pad = _inputs(b, t, s, d, padded, torch.bfloat16, cuda)
    if padded and b > 1:
        pad[1, 0] = -1e9             # a causal row 0 that sees a pad only
    out = torch.empty_like(q)
    rc = kernels.lib().mit_flash_attention_btd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if pad is None else pad.data_ptr(), out.data_ptr(), b, t, s, d,
        64, int(causal), int(padded), *bf16_tiling(t, warps),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "mit_flash_attention_btd_bf16")
    ref = flash_attention_btd_reference(q, k, v, pad, causal, 64)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 32])
def test_bf16_fragments_are_not_permuted_on_card(cuda, s):
    """One-hot probabilities pick single rows of v: a permuted accumulator
    or A fragment would pick another row, at no change in norm."""
    t, d = 16, 64
    q = torch.zeros(1, t, d, device=cuda)
    k = torch.zeros(1, s, d, device=cuda)
    pick = torch.tensor([(5 * i + 3) % s for i in range(t)], device=cuda)
    q[0, torch.arange(t), torch.arange(t)] = 64.0      # score 512 at one key
    k[0, pick, torch.arange(t, device=cuda)] = 64.0
    v = torch.arange(s * d, device=cuda).reshape(1, s, d) % 251 / 16.0
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention_btd(q, k, v, None, False, 64)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], v[0, pick], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,extra", [(100, 100, 28), (197, 197, 60),
                                       (70, 130, 200), (300, 64, 513)])
def test_bf16_causal_tile_skipping_is_exact_on_card(cuda, t, s, extra):
    """A causal call equals the same call over a wider S whose extra keys
    are padded away: the key tiles above the diagonal that the kernel skips
    add nothing, also in a row whose visible keys are all padded."""
    q, k, v, pad = _inputs(3, t, s, 128, True, torch.bfloat16, cuda)
    pad[1, 0] = -1e9                 # query row 0 of batch row 1 sees a pad only
    wide = lambda x: torch.cat([x, torch.randn(
        3, extra, 128, device=cuda, generator=torch.Generator(cuda).manual_seed(
            5)).to(x.dtype)], 1)
    pad_wide = torch.cat([pad, torch.full((3, extra), -1e9, device=cuda)], 1)
    out = flash_attention_btd(q, k, v, pad, True, 64)
    out_wide = flash_attention_btd(q, wide(k), wide(v), pad_wide, True, 64)
    ref = flash_attention_btd_reference(q, k, v, pad, True, 64)
    ref_wide = flash_attention_btd_reference(q, wide(k), wide(v), pad_wide,
                                             True, 64)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (out_wide, ref_wide)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], err
    # rows whose visible keys are all padded share their maximum with the
    # extra keys (both sit at -1e9 or -2e9), in the reference as here
    visible = (torch.tril(torch.ones(t, s, device=cuda)) * (pad == 0)[:, None]
               ).sum(-1) > 0
    torch.testing.assert_close(out_wide[visible], out[visible], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, pad = _inputs(2, 8, 8, 128, True, torch.float32, cuda)
    wide = torch.zeros(2, 8, 257, device=cuda)     # one head of 257 columns
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_btd(wide, wide, wide, None, False, 257)
    with pytest.raises(TypeError):
        flash_attention_btd(q.half(), k.half(), v.half(), pad, False, 64)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_btd(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, v, pad, False, 64)
    # forward-only kernel: the gradient recomputes through the plain version
    qg = q.detach().requires_grad_()
    before = flash_attention_btd.launches
    (g,) = torch.autograd.grad(
        flash_attention_btd(qg, k, v, pad, False, 64).sum(), qg)
    (want,) = torch.autograd.grad(
        flash_attention_btd_reference(qg, k, v, pad, False, 64).sum(), qg)
    assert flash_attention_btd.launches == before + 1
    torch.testing.assert_close(g, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, pad = _inputs(2, 9, 9, 64, True, torch.float32, "cpu")
    before = flash_attention_btd.launches
    out = flash_attention_btd(q, k, v, pad, True, 64)
    assert flash_attention_btd.launches == before
    torch.testing.assert_close(
        out, flash_attention_btd_reference(q, k, v, pad, True, 64)
    )


@pytest.mark.parametrize("change,error", [
    (dict(head_dim=257, d=257), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(k_len=7), ValueError),
    (dict(pad_len=5), ValueError),
    (dict(d=96), ValueError),
])
def test_kernel_input_checks(change, error):
    d = change.get("d", 128)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(2, 9, d, dtype=dtype)
    k = torch.zeros(2, 9, d, dtype=dtype)
    v = torch.zeros(2, change.get("k_len", 9), d, dtype=dtype)
    pad = torch.zeros(2, change.get("pad_len", 9))
    with pytest.raises(error):
        _check_cuda_inputs(q, k, v, pad, change.get("head_dim", 64))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler failure is an error with its output."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert not list(tmp_path.iterdir())


# ----------------------------------------------------------------------
# the int8 encoder's kernels
# ----------------------------------------------------------------------
def _qlinear(k, n, device, seed=0, bias=True):
    r = np.random.default_rng(seed)
    w = torch.from_numpy((r.normal(size=(k, n)) * 0.05).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(n,)).astype(np.float32)) if bias else None
    q = quantize_weight(w, b)
    return QuantizedLinear(*(None if a is None else a.to(device) for a in q))


def _rows(m, k, dtype, device, seed=1):
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32) * 2
    x[0] = 0.0                                       # the 1e-8 amax floor
    return torch.from_numpy(x).to(device, dtype)


def _ln(k, device, seed=2):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return {"scale": to(1 + 0.1 * r.normal(size=k)),
            "bias": to(0.1 * r.normal(size=k))}


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k", [(197, 768), (300, 3072), (5, 16), (3, 1000)])
def test_quantize_rows_matches_plain_on_card(cuda, dtype, with_ln, m, k):
    x = _rows(m, k, dtype, cuda)
    ln = _ln(k, cuda) if with_ln else None
    before = int8_mlp.quantize_rows.launches
    x8, sx = int8_mlp.quantize_rows(x, ln, 1e-5)
    r8, rsx = int8_mlp.quantize_rows_reference(x, ln, 1e-5)
    torch.cuda.synchronize()
    assert int8_mlp.quantize_rows.launches == before + 1
    assert x8.dtype == torch.int8 and sx.shape == (m,)
    if not with_ln:      # the same f32 row: bitwise the same codes and scales
        assert torch.equal(x8, r8) and torch.equal(sx, rsx)
        assert not x8[0].any()
    else:                # the LayerNorm's sums run in another order
        diff = (x8.int() - r8.int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3
        torch.testing.assert_close(sx, rsx, rtol=1e-5, atol=0)


GEMM_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


# ViT-L's four, CLIP ViT-L/14's patch embedding (K 588 padded to 592), and
# edges of the 128 x 192 and 128 x 128 tiles and the 128-byte k-steps
GEMM_EDGE_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
                    (592, 1024), (48, 40), (144, 200), (784, 776)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [197, 1000, 7, 64, 129])
@pytest.mark.parametrize("k,n", GEMM_SHAPES + GEMM_EDGE_SHAPES)
def test_int8_gemm_accumulators_are_exact_on_card(cuda, m, k, n):
    q = _qlinear(k, n, cuda)
    a8 = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(m)).to(cuda)
    a8[0] = 127                                      # 127² · K: past 2²⁴
    sx = torch.rand(m, device=cuda)
    acc = int8_mlp.int8_gemm(a8, sx, q, out_dtype=torch.int32)
    ref = int8_mlp.int8_gemm_reference(a8, sx, q, out_dtype=torch.int32)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and torch.equal(acc, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act,res", [
    ("none", None), ("gelu", None), ("quick_gelu", None),
    ("none", torch.float32), ("none", torch.bfloat16),
])
def test_int8_gemm_epilogues_match_plain_on_card(cuda, act, res, out_dtype):
    m, k, n = 300, 768, 1024
    q = _qlinear(k, n, cuda, bias=act != "quick_gelu")
    a8, sx = int8_mlp.quantize_rows(_rows(m, k, torch.float32, cuda))
    residual = None if res is None else _rows(m, n, res, cuda, seed=3)
    before = int8_mlp.int8_gemm.launches
    out = int8_mlp.int8_gemm(a8, sx, q, act, residual, out_dtype)
    ref = int8_mlp.int8_gemm_reference(a8, sx, q, act, residual, out_dtype)
    torch.cuda.synchronize()
    assert int8_mlp.int8_gemm.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (m, n)
    # the same f32 operations in the same order; quick_gelu's expf and
    # PyTorch's sigmoid differ in the last ulp, bf16 then rounds once
    tol = ({"rtol": 2e-6, "atol": 1e-6} if out_dtype == torch.float32
           else {"rtol": 8e-3, "atol": 1e-5})
    torch.testing.assert_close(out, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "layer"])
@pytest.mark.parametrize("b,t,d", [
    (4, 197, 768), (2, 257, 1024), (3, 13, 128), (2, 1, 64), (2, 15, 64),
    (2, 16, 128), (2, 17, 64), (2, 63, 512), (2, 64, 64), (2, 65, 128),
    (2, 128, 64), (2, 208, 128), (2, 256, 64), (1, 577, 768),
])
def test_fusedqkv_matches_plain_on_card(cuda, mode, b, t, d):
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    layer = mode == "layer"
    qkv = torch.from_numpy(np.random.default_rng(4).normal(
        size=(b, t, 3 * d)).astype(np.float32)).to(cuda, dtype)
    before = flash_attention_btd_fusedqkv.launches
    out = flash_attention_btd_fusedqkv(qkv, 64, layer)
    ref = flash_attention_btd_fusedqkv_reference(qkv, 64, layer)
    torch.cuda.synchronize()
    assert flash_attention_btd_fusedqkv.launches == before + 1
    assert out.shape == (b, t, d)
    assert out.dtype == (torch.float32 if layer else dtype)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_int8_linear_and_mlp_match_plain_on_card(cuda, act):
    x = _rows(394, 768, torch.bfloat16, cuda).reshape(2, 197, 768)
    q, q1, q2 = _qlinear(768, 2304, cuda), _qlinear(768, 3072, cuda, 5), \
        _qlinear(3072, 768, cuda, 6)
    lin = int8_mlp.int8_linear(x, q, torch.bfloat16)
    mlp = int8_mlp.fused_int8_mlp(x, q1, q2, act, torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(lin, int8_mlp.int8_linear_reference(x, q),
                               rtol=8e-3, atol=1e-5)
    ref = int8_mlp.fused_int8_mlp_reference(x, q1, q2, act, torch.float32)
    assert mlp.shape == (2, 197, 768) and _rel(mlp, ref) < 1e-3


@pytest.mark.cuda
def test_int8_linear_pads_k_on_card(cuda):
    """CLIP ViT-L/14's patch embedding: K = 588 is no multiple of 16."""
    x = _rows(2 * 256, 588, torch.bfloat16, cuda).reshape(2, 256, 588)
    q = _qlinear(588, 1024, cuda)
    out = int8_mlp.int8_linear(x, q, torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, int8_mlp.int8_linear_reference(x, q, torch.float32),
        rtol=2e-6, atol=1e-6)


def _layer_weights(d, f, device):
    return (_ln(d, device, 7), _qlinear(d, 3 * d, device, 8),
            _qlinear(d, d, device, 9), _ln(d, device, 10),
            _qlinear(d, f, device, 11), _qlinear(f, d, device, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["mega", "split"])
@pytest.mark.parametrize("b,t,d,f,heads", [(2, 197, 768, 3072, 12),
                                           (2, 257, 1024, 4096, 16),
                                           (2, 197, 768, 3072, 24),
                                           (2, 197, 768, 3072, 6)],
                         ids=["vit-b", "vit-l", "hd32", "hd128"])
def test_fused_int8_vit_layer_matches_plain_on_card(cuda, b, t, d, f, heads,
                                                    split):
    x = _rows(b * t, d, torch.bfloat16, cuda).reshape(b, t, d)
    args = _layer_weights(d, f, cuda)
    fn = (int8_layer.fused_int8_vit_layer_split if split
          else int8_layer.fused_int8_vit_layer)
    ref_fn = (int8_layer.fused_int8_vit_layer_split_reference if split
              else int8_layer.fused_int8_vit_layer_reference)
    before = fn.launches
    out = fn(x, *args, heads, 1e-6)
    ref = ref_fn(x, *args, heads, 1e-6)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    # the JAX package's own bound between its layer kernel and composition
    assert _rel(out, ref) <= 5e-3


@pytest.mark.cuda
def test_int8_wrappers_reject_what_they_do_not_take(cuda):
    x = _rows(8, 64, torch.float32, cuda)
    q = _qlinear(64, 64, cuda)
    a8, sx = int8_mlp.quantize_rows(x)
    with pytest.raises(TypeError):
        int8_mlp.quantize_rows(x.half())
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_mlp.int8_gemm(a8[:, :40].contiguous(), sx, _qlinear(40, 64, cuda))
    with pytest.raises(ValueError, match="K-contiguous"):
        int8_mlp.int8_gemm(a8, sx, q._replace(w8=q.w8.contiguous()))
    with pytest.raises(TypeError):
        int8_mlp.int8_linear(x.half(), q)
    with pytest.raises(TypeError):
        int8_mlp.fused_int8_mlp(x.half(), q, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_btd_fusedqkv(
            torch.zeros(2, 5, 3 * 257, device=cuda, dtype=torch.bfloat16),
            257, layer_numerics=True)
    with pytest.raises(TypeError):
        flash_attention_btd_fusedqkv(
            torch.zeros(2, 5, 192, device=cuda), 64, layer_numerics=True)
    with pytest.raises(TypeError):
        int8_layer.fused_int8_vit_layer(
            x.half().reshape(2, 4, 64), *_layer_weights(64, 128, cuda), 1,
            1e-6)


# the (D, F) pairs of csrc/int8_mlp_fused.cu: ViT-B, CLIP-L, ViT-H
MLP_SHAPES = [(768, 3072), (1024, 4096), (1280, 5120)]


def _mlp_composition(*args):
    """The MLP half as four launches (quantize_rows, int8_gemm, twice)."""
    return int8_mlp._mlp_half(*args, int8_mlp.quantize_rows,
                              int8_mlp._gemm_any_k)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["layer", "split", "mlp"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("m", [64, 197, 1037])
@pytest.mark.parametrize("d,f", MLP_SHAPES, ids=["vit-b", "clip-l", "vit-h"])
def test_int8_mlp_fused_matches_the_composition_on_card(cuda, d, f, m, act,
                                                        form):
    """One launch, bitwise the composition's with gelu. With quick_gelu the
    two may differ by one ulp of expf, which can flip one hidden code and
    so move its row: at most one row in a thousand (and at least one may)
    differs. Within 1e-3 (the MLP) or 5e-3 (the layer's forms) relative L2
    of the plain version."""
    dtype = torch.float32 if form == "layer" else torch.bfloat16
    x = _rows(m, d, dtype, cuda)
    ln = None if form == "mlp" else _ln(d, cuda)
    out_dtype = torch.float32 if form == "layer" else torch.bfloat16
    args = (x, _qlinear(d, f, cuda, 5), _qlinear(f, d, cuda, 6), act, ln,
            1e-6, form != "mlp", out_dtype)
    before = int8_mlp.int8_mlp_fused.launches
    y = int8_mlp.int8_mlp_fused(*args)
    z = _mlp_composition(*args)
    ref = int8_mlp.int8_mlp_fused_reference(*args)
    torch.cuda.synchronize()
    assert int8_mlp.int8_mlp_fused.launches == before + 1
    assert y.shape == (m, d) and y.dtype == out_dtype
    if act == "gelu":
        assert torch.equal(y, z)
    else:
        assert (y != z).any(dim=1).sum().item() <= max(1, m // 1000)
    assert _rel(y, ref) <= (1e-3 if form == "mlp" else 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["mega", "split"])
def test_int8_layer_routes_its_mlp_half_on_card(cuda, monkeypatch, split):
    """With the route on at any rows of every geometry the fused kernel is
    built for, the layer's MLP half at such a (D, F) is one int8_mlp_fused
    launch; at another, the composition."""
    monkeypatch.setattr(int8_mlp, "MLP_KERNEL_MAX_ROWS",
                        {shape: 1 << 30 for shape in int8_mlp.FUSED_MLP_SHAPES})
    fn = (int8_layer.fused_int8_vit_layer_split if split
          else int8_layer.fused_int8_vit_layer)
    for d, f, heads, route in ((768, 3072, 12, "fused"),
                               (256, 1024, 4, "composition")):
        x = _rows(2 * 70, d, torch.bfloat16, cuda).reshape(2, 70, d)
        kernels_before = dict(fn.kernels)
        launches = int8_mlp.int8_mlp_fused.launches
        out = fn(x, *_layer_weights(d, f, cuda), heads, 1e-6)
        torch.cuda.synchronize()
        assert fn.kernels[route] == kernels_before[route] + 1
        assert (int8_mlp.int8_mlp_fused.launches - launches
                == (1 if route == "fused" else 0))
        assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_int8_mlp_fused_rejects_what_it_does_not_take_on_card(cuda):
    x = _rows(8, 768, torch.float32, cuda)
    q1, q2 = _qlinear(768, 3072, cuda), _qlinear(3072, 768, cuda, 1)
    with pytest.raises(ValueError, match="takes"):
        int8_mlp.int8_mlp_fused(x[:, :128].contiguous(), _qlinear(128, 512, cuda),
                                _qlinear(512, 128, cuda))
    with pytest.raises(ValueError, match="16-byte"):
        shifted = torch.zeros(8 * 768 + 1, device=cuda)[1:].view(8, 768)
        int8_mlp.int8_mlp_fused(shifted, q1, q2)
    with pytest.raises(TypeError):
        int8_mlp.int8_mlp_fused(x.half(), q1, q2)
    with pytest.raises(ValueError, match="act"):
        int8_mlp.int8_mlp_fused(x, q1, q2, "none")
    with pytest.raises(ValueError, match="K-contiguous"):
        int8_mlp.int8_mlp_fused(x, q1._replace(w8=q1.w8.contiguous()), q2)


@pytest.mark.parametrize("change,error", [
    (dict(k=40), ValueError),                 # K not a multiple of 16
    (dict(n=12), ValueError),                 # N not a multiple of 8
    (dict(layout="row"), ValueError),         # w8 not K-contiguous
    (dict(a_dtype=torch.int32), TypeError),
    (dict(act="relu"), ValueError),
    (dict(out_dtype=torch.float16), TypeError),
    (dict(res_dtype=torch.float16), TypeError),
    (dict(sx_len=7), ValueError),
])
def test_int8_gemm_input_checks(change, error):
    k, n = change.get("k", 64), change.get("n", 32)
    a8 = torch.zeros(8, k, dtype=change.get("a_dtype", torch.int8))
    q = quantize_weight(torch.ones(k, n), torch.zeros(n))
    if change.get("layout") == "row":
        q = q._replace(w8=q.w8.contiguous())
    res = torch.zeros(8, n, dtype=change.get("res_dtype", torch.float32))
    with pytest.raises(error):
        int8_mlp._check_gemm(a8, torch.ones(change.get("sx_len", 8)), q,
                             change.get("act", "none"), res,
                             change.get("out_dtype", torch.float32))


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(shape=(4,)), ValueError),
    (dict(shape=(2, 13000)), ValueError),
    (dict(ln_len=5), ValueError),
])
def test_quantize_rows_input_checks(change, error):
    x = torch.zeros(change.get("shape", (3, 8)),
                    dtype=change.get("dtype", torch.float32))
    n = change.get("ln_len", 8)
    with pytest.raises(error):
        int8_mlp._check_quantize_rows(x, {"scale": torch.ones(n),
                                          "bias": torch.zeros(n)})


@pytest.mark.parametrize("change,error", [
    (dict(head_dim=257, layer=True, width=3 * 257), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(layer=True, dtype=torch.float32), TypeError),
    (dict(width=3 * 96), ValueError),
])
def test_fusedqkv_input_checks(change, error):
    qkv = torch.zeros(2, 5, change.get("width", 3 * 128),
                      dtype=change.get("dtype", torch.bfloat16))
    with pytest.raises(error):
        _check_fusedqkv(qkv, change.get("head_dim", 64),
                        change.get("layer", False))


def test_int8_cpu_tensors_take_the_plain_versions():
    x = _rows(6, 64, torch.float32, "cpu").reshape(2, 3, 64)
    q = _qlinear(64, 64, "cpu")
    wrappers = [int8_mlp.quantize_rows, int8_mlp.int8_gemm,
                int8_mlp.int8_linear, int8_mlp.fused_int8_mlp,
                flash_attention_btd_fusedqkv, int8_layer.fused_int8_vit_layer]
    before = [w.launches for w in wrappers]
    torch.testing.assert_close(int8_mlp.int8_linear(x, q),
                               int8_mlp.int8_linear_reference(x, q))
    torch.testing.assert_close(int8_mlp.fused_int8_mlp(x, q, q),
                               int8_mlp.fused_int8_mlp_reference(x, q, q))
    args = _layer_weights(64, 64, "cpu")
    torch.testing.assert_close(
        int8_layer.fused_int8_vit_layer(x, *args, 1, 1e-6),
        int8_layer.fused_int8_vit_layer_reference(x, *args, 1, 1e-6))
    assert [w.launches for w in wrappers] == before


# ----------------------------------------------------------------------
# the dropout-attention kernels (training's decoder self-attention)
# ----------------------------------------------------------------------
def _heads(b, h, t, s, dtype, device, seed=7):
    """q, k ~ N(0, 1), v ~ U(-1, 1) in (B, H, T|S, 64); (B, S) pads with
    every key of batch row 0 masked."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    q = to(r.normal(size=(b, h, t, 64)))
    k = to(r.normal(size=(b, h, s, 64)))
    v = to(r.uniform(-1, 1, size=(b, h, s, 64)))
    pad = np.where(r.random((b, s)) > 0.8, -1e9, 0.0).astype(np.float32)
    pad[0] = -1e9
    return q, k, v, torch.from_numpy(pad).to(device)


def _norm_err(a, b):
    """Max abs difference over b's largest value (a gradient that is exactly
    zero, as dq and dk over a single key, counts as 1)."""
    scale = torch.clamp(b.float().abs().max(), min=1.0 if not b.any() else 0.0)
    return ((a.float() - b.float()).abs().max() / scale).item()


DROPOUT_SHAPES = [(4, 8, 99, 99, True), (3, 2, 7, 9, False),
                  (2, 2, 128, 128, True), (2, 1, 1, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,rate", [(0, 0.1), (2**31 - 2, 0.5), (5, 0.0)])
@pytest.mark.parametrize("b,h,t,s", [(2, 3, 7, 9), (32, 8, 99, 99)])
def test_dump_dropout_mask_is_bitwise_plain_on_card(cuda, b, h, t, s, seed,
                                                    rate):
    before = dropout_attention.dump_dropout_mask.launches
    got = dropout_attention.dump_dropout_mask(b, h, t, s, seed, rate, cuda)
    want = dropout_attention.keep_mask(
        t, s, rate, seed, torch.arange(b * h, device=cuda)).reshape(b, h, t, s)
    torch.cuda.synchronize()
    assert dropout_attention.dump_dropout_mask.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,causal", DROPOUT_SHAPES)
def test_dropout_attention_matches_plain_on_card(cuda, dtype, b, h, t, s,
                                                 causal):
    """Forward within 1e-5 (f32: the same operations summed in another
    order) or TOL (bf16: one rounding of the output); dq, dk, dv within
    1e-5 (f32) and 1e-2 (bf16) of their largest value."""
    q, k, v, pad = _heads(b, h, t, s, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                     ).to(cuda, dtype)
    seed, rate = 1234, 0.1
    fwd = dropout_attention.flash_attention_dropout_fwd
    bwd = dropout_attention.flash_attention_dropout_bwd
    before = (fwd.launches, bwd.launches)
    out = fwd(q, k, v, pad, seed, causal, rate)
    grads = bwd(q, k, v, pad, do, seed, causal, rate)
    ref = dropout_attention.flash_attention_dropout_reference(
        q, k, v, pad, seed, causal, rate)
    ref_grads = dropout_attention.flash_attention_dropout_reference_backward(
        q, k, v, pad, do, seed, causal, rate)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and not torch.isnan(out).any()
    fwd_limit = 1e-5 if dtype == torch.float32 else TOL[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= fwd_limit
    limit = 1e-5 if dtype == torch.float32 else 1e-2
    for g, r in zip(grads, ref_grads):
        assert g.dtype == dtype and g.shape == r.shape
        assert _norm_err(g, r) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,limit", [(torch.float32, 4, 1e-5),
                                           (torch.bfloat16, 32, 1e-2)],
                         ids=["f32", "bf16"])
def test_dropout_attention_autograd_on_card(cuda, dtype, b, limit):
    """The autograd Function launches the forward and backward kernels and
    gives the plain autograd version's gradients: f32 within 1e-5, bf16 (at
    the training shape, the backward on the tensor cores) within 1e-2 of
    their largest value. Both take the same cotangent, so a forward that
    rounds differently in bf16 does not move the backward's input."""
    q, k, v, pad = _heads(b, 8, 99, 99, dtype, cuda)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                      ).to(cuda, dtype)
    grads = []
    counts = []
    for fn in (dropout_attention.flash_attention_dropout,
               dropout_attention.flash_attention_dropout_plain):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        before = (dropout_attention.flash_attention_dropout_fwd.launches,
                  dropout_attention.flash_attention_dropout_bwd.launches)
        out = fn(*qkv, pad, 99, True, 0.1)
        grads.append(torch.autograd.grad(out, qkv, cot))
        counts.append((dropout_attention.flash_attention_dropout_fwd.launches
                       - before[0],
                       dropout_attention.flash_attention_dropout_bwd.launches
                       - before[1]))
    torch.cuda.synchronize()
    assert counts == [(1, 1), (0, 0)]
    for got, want in zip(*grads):
        assert got.dtype == dtype
        assert _norm_err(got, want) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,s,causal", DROPOUT_SHAPES)
def test_dropout_bf16_backward_runs_on_the_tensor_cores_on_card(cuda, b, h,
                                                                t, s, causal):
    """A bf16 backward at every tiled shape launches the tensor-core kernel
    once, and nothing else; f32 keeps the CUDA-core kernel."""
    bwd = dropout_attention.flash_attention_dropout_bwd
    for dtype, kernel in ((torch.bfloat16, "tensor_cores"),
                          (torch.float32, "cuda_cores")):
        assert dropout_attention.dropout_bwd_kernel_for(dtype, 64, t, s) == \
            kernel
        q, k, v, pad = _heads(b, h, t, s, dtype, cuda)
        before = dict(bwd.kernels)
        launches = bwd.launches
        bwd(q, k, v, pad, torch.ones_like(q), 3, causal, 0.1)
        torch.cuda.synchronize()
        assert bwd.launches == launches + 1
        assert {name: n - before[name] for name, n in bwd.kernels.items()} \
            == {name: int(name == kernel) for name in before}


@pytest.mark.cuda
def test_dropout_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, pad = _heads(2, 2, 9, 9, torch.float32, cuda)
    fwd = dropout_attention.flash_attention_dropout_fwd
    with pytest.raises(TypeError):
        fwd(q.half(), k.half(), v.half(), pad, 0, True, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, pad, 0,
            True, 0.1)
    wide = torch.zeros(1, 1, 9, 257, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fwd(wide, wide, wide, torch.zeros(1, 9, device=cuda), 0, True, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t", [(32, 8, 99), (2, 2, 160)],
                         ids=["tiled", "any_shape"])
def test_dropout_seed_through_the_pointer_is_the_seed_by_value_on_card(
        cuda, dtype, b, h, t):
    """The forward, the backward and ``dump_dropout_mask`` with the seed in
    a 0-dim int32 device tensor (its address to the C entry, read when the
    kernel runs) equal the launches that take the same seed by value, bit
    for bit; a tensor holding another seed gives that seed's results, so
    the kernels read the pointer."""
    assert dropout_attention.dropout_kernel_for(64, t, t) == \
        ("tiled" if t <= 128 else "any_shape")
    q, k, v, pad = _heads(b, h, t, t, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)
                     ).to(cuda, dtype)
    fwd = dropout_attention.flash_attention_dropout_fwd
    bwd = dropout_attention.flash_attention_dropout_bwd
    dump = lambda seed: dropout_attention.dump_dropout_mask(b, h, t, t, seed,
                                                            0.1, cuda)
    masks = []
    for seed in (2**31 - 5, 77):
        on_card = torch.tensor(seed, dtype=torch.int32, device=cuda)
        assert torch.equal(fwd(q, k, v, pad, on_card, True, 0.1),
                           fwd(q, k, v, pad, seed, True, 0.1))
        for got, want in zip(bwd(q, k, v, pad, do, on_card, True, 0.1),
                             bwd(q, k, v, pad, do, seed, True, 0.1)):
            assert torch.equal(got, want)
        masks.append(dump(on_card))
        assert torch.equal(masks[-1], dump(seed))
    assert not torch.equal(*masks)


# ----------------------------------------------------------------------
# the fused decode layer and the (B, H, T, hd) attention kernel
# ----------------------------------------------------------------------
def _decode_layer_case(b, t, dtype, device, per_row, f=2048, seed=0):
    """One layer call at D 512, 8 heads: madd hides the keys past pos and a
    tenth of the others; batch row 1 is fully masked."""
    from mit_tpu_torch.ops.decode_layer import pack_decode_layers

    d = 512
    r = np.random.default_rng(seed)
    to = lambda a, dt=dtype: torch.from_numpy(
        np.asarray(a, np.float32)).to(device, dt)
    x = to(r.normal(size=(b, d)))
    kc, vc = to(r.normal(size=(b, t, d))), to(r.normal(size=(b, t, d)))
    cross = to(r.normal(size=(b, d)), torch.float32)
    pos = r.integers(0, t, b).astype(np.int32) if per_row else t // 2
    visible = np.arange(t)[None, :] <= np.broadcast_to(pos, (b,))[:, None]
    visible &= r.random((b, t)) > 0.1
    madd = np.where(visible, 0.0, -1e9)
    if b > 1:
        madd[1] = -1e9
    w = lambda k, n: to(r.normal(size=(1, k, n)) / np.sqrt(k))
    vec = lambda n, dt=dtype: to(0.1 * r.normal(size=(1, n)), dt)
    ln = lambda: {"scale": 1 + vec(d, torch.float32),
                  "bias": vec(d, torch.float32)}
    lay = pack_decode_layers({
        "wqkv": w(d, 3 * d), "bqkv": vec(3 * d), "wo": w(d, d), "bo": vec(d),
        "w1": w(d, f), "b1": vec(f), "w2": w(f, d), "b2": vec(d),
        "ln1": ln(), "ln2": ln(), "ln3": ln()})
    if per_row:
        pos = torch.from_numpy(pos).to(device)
    return [x, pos, to(madd, torch.float32), kc, vc, cross, lay, 0, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "row_pos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,f", [(64, 16, 2048), (64, 100, 2048),
                                   (192, 100, 2048), (3, 7, 2048),
                                   (5, 33, 1024), (1, 1, 4096)])
def test_fused_decode_layer_matches_plain_on_card(cuda, b, t, f, dtype, per_row):
    from mit_tpu_torch.ops.decode_layer import (
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    args = _decode_layer_case(b, t, dtype, cuda, per_row, f)
    before = fused_decode_layer.launches
    out = fused_decode_layer(*args)
    torch.cuda.synchronize()
    assert fused_decode_layer.launches == before + 1
    ref = fused_decode_layer_plain(*args)
    # f32: summation order over 512 to 4096 terms at values of order 1
    tol = 1e-5 if dtype == torch.float32 else 0.05
    for o, r in zip(out, ref):
        assert o.dtype == dtype and bool(torch.isfinite(o).all())
        assert (o.float() - r.float()).abs().max().item() <= tol
    k2, v2 = args[3].clone(), args[4].clone()
    wrote = fused_decode_layer(*args[:3], k2, v2, *args[5:], write_cache=True)
    for o, w in zip(out, wrote):
        assert torch.equal(o, w)
    posv = args[1] if per_row else torch.full((b,), args[1], device=cuda)
    rows = torch.arange(b, device=cuda)
    assert torch.equal(k2[rows, posv.long()], out[1])
    assert torch.equal(v2[rows, posv.long()], out[2])
    assert (k2 != args[3]).any(-1).sum().item() <= b


@pytest.mark.cuda
def test_fused_decode_layer_rejects_what_it_does_not_take(cuda):
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer

    args = _decode_layer_case(4, 8, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="8 heads"):
        fused_decode_layer(*args[:8], 4)
    with pytest.raises(TypeError, match="x is"):
        fused_decode_layer(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="madd must be"):
        fused_decode_layer(*args[:2], args[2][:, :-1], *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_decode_layer(*args[:3], args[3].transpose(0, 1).contiguous()
                           .transpose(0, 1), *args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("ks", [1, 2, 4])
@pytest.mark.parametrize("grid", [1, 7, None], ids=["grid1", "grid7", "plan"])
@pytest.mark.parametrize("b", [7, 64, 130])
def test_fused_decode_layer_design_choices_agree_on_card(cuda, b, grid, ks):
    """The grid (how many blocks share the items) and the slices of K of
    the D-column products change f32 summation order only: every choice
    stays within the kernel's bound of the plain version, and a launch
    repeats bit for bit."""
    from mit_tpu_torch.ops import decode_layer as dl

    args = _decode_layer_case(b, 33, torch.float32, cuda, True)
    x, pos, madd, kc, vc, cross, lay = args[:7]
    grid = grid or dl.decode_layer_plan(lay.dtype, dl._sms(x.device))[0]
    run = lambda: dl._launch(x, pos, madd, kc, vc, cross, lay, 0, 1e-5,
                             False, grid, ks)
    out = run()
    for o, r in zip(out, dl.fused_decode_layer_plain(*args)):
        assert (o - r).abs().max().item() <= 1e-5
    assert all(torch.equal(a, c) for a, c in zip(out, run()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_decode_layer_replays_in_a_cuda_graph_on_card(cuda, dtype):
    """One launch, cooperative grid and barrier included, captured in a CUDA
    graph and replayed: the same outputs as the launch itself."""
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer

    args = _decode_layer_case(64, 100, dtype, cuda, True)
    want = fused_decode_layer(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fused_decode_layer(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(want, got))


@pytest.mark.cuda
def test_fused_decode_layer_at_its_longest_cache_on_card(cuda):
    from mit_tpu_torch.ops.decode_layer import (
        KERNEL_MAX_T,
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    args = _decode_layer_case(4, KERNEL_MAX_T, torch.float32, cuda, True)
    for o, r in zip(fused_decode_layer(*args), fused_decode_layer_plain(*args)):
        assert (o - r).abs().max().item() <= 1e-5
    longer = _decode_layer_case(2, KERNEL_MAX_T + 1, torch.float32, cuda, True)
    with pytest.raises(ValueError, match="cache"):
        fused_decode_layer(*longer)


def test_fused_decode_layer_cpu_takes_the_plain_version():
    from mit_tpu_torch.ops.decode_layer import (
        KERNEL_MAX_T,
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    args = _decode_layer_case(3, 7, torch.float32, "cpu", True, f=64)
    before = fused_decode_layer.launches
    out = fused_decode_layer(*args)
    assert fused_decode_layer.launches == before
    for o, r in zip(out, fused_decode_layer_plain(*args)):
        assert torch.equal(o, r)
    # the kernel's limits do not bind the plain version
    longer = _decode_layer_case(2, KERNEL_MAX_T + 1, torch.float32, "cpu",
                                True, f=64)
    out = fused_decode_layer(*longer)
    assert fused_decode_layer.launches == before
    assert all(bool(torch.isfinite(o).all()) for o in out)


def _bhtd_inputs(b, h, t, s, padded, dtype, device, seed=0):
    q, k, v, pad = _inputs(b, t, s, h * 64, padded, dtype, device, seed)
    split = lambda x: x.view(b, -1, h, 64).transpose(1, 2).contiguous()
    return split(q), split(k), split(v), pad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,causal,padded", [
    (2, 12, 577, 577, False, False),     # BLIP-384 encoder
    (4, 8, 100, 100, True, True),        # decoder self-attention
    (3, 2, 33, 70, False, True),         # ragged, cross lengths
    (2, 3, 5, 9, True, False),           # fewer keys than a lane group
])
def test_flash_attention_bhtd_matches_plain_on_card(cuda, dtype, b, h, t, s,
                                                    causal, padded):
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v, pad = _bhtd_inputs(b, h, t, s, padded, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, pad, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, pad, causal)
    assert out.dtype == dtype and not torch.isnan(out).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_bhtd_autograd_and_rejections_on_card(cuda):
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v, pad = _bhtd_inputs(2, 2, 9, 9, True, torch.float32, cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, pad, True)
    grads = torch.autograd.grad(out.sum(), leaves)
    want = torch.autograd.grad(
        flash_attention_reference(*leaves, pad, True).sum(), leaves)
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-5
    wide = torch.zeros(2, 2, 9, 257, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(wide, wide, wide, None, False)
    with pytest.raises(TypeError, match="k is"):
        flash_attention(q, k.bfloat16(), v, None, False)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                        None, False)


def test_flash_attention_bhtd_cpu_takes_the_plain_version():
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v, pad = _bhtd_inputs(2, 2, 5, 7, True, torch.float32, "cpu")
    before = flash_attention.launches
    out = flash_attention(q, k, v, pad, False)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_reference(q, k, v, pad, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,causal", [
    (3, 2, 100, 100, True),              # one query block, two key tiles
    (3, 2, 197, 197, True),              # the walk ends at a diagonal
    (3, 1, 300, 577, True),              # T < S, many tiles
    (3, 2, 577, 577, False),             # BLIP-384's length, padded
    (3, 2, 70, 130, True),
])
def test_flash_attention_bhtd_masked_rows_on_card(cuda, dtype, b, h, t, s,
                                                  causal):
    """Causal + pad with every key of batch row 0 padded (its rows come out
    uniform over the keys that share their maximum) and, in batch row 1, key
    0 padded: query row 0 then sees a pad only and shares its maximum with
    the causally masked keys that are not padded, beyond any diagonal."""
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v, pad = _bhtd_inputs(b, h, t, s, True, dtype, cuda, seed=3)
    pad[1, 0] = -1e9
    out = flash_attention(q, k, v, pad, causal)
    ref = flash_attention_reference(q, k, v, pad, causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    want = torch.stack([v[0, :, :min(i + 1, s) if causal else s].float().mean(1)
                        for i in range(t)], 1)
    assert (out[0].float() - want).abs().max().item() <= tol
    if causal:        # row 0 of batch row 1: uniform over the unpadded keys
        free = pad[1] == 0
        free[0] = True           # key 0 is visible, and at the same -1e9
        want0 = v[1][:, free].float().mean(1)
        assert (out[1, :, 0].float() - want0).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("warps", BF16_WARPS)
def test_flash_attention_bhtd_bf16_tilings_on_card(cuda, warps):
    """Both tilings of the tensor-core kernel in the (B, H, T, hd) entry's
    two-walk mode, not only the one the wrapper's rule picks."""
    from mit_tpu_torch.ops.flash_attention import flash_attention_reference

    b, h, t, s = 2, 3, 300, 333
    q, k, v, pad = _bhtd_inputs(b, h, t, s, True, torch.bfloat16, cuda)
    pad[1, 0] = -1e9
    for causal in (False, True):
        out = torch.empty_like(q)
        rc = kernels.lib().mit_flash_attention_bhtd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), b, h, t, s, 64, int(causal), 1, 1,
            *bf16_tiling(t, warps), torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "mit_flash_attention_bhtd")
        ref = flash_attention_reference(q, k, v, pad, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _recovered_keep_mask(b, h, t, s, seed, rate, causal, device):
    """The forward kernel's keep-mask, read off its output: q = k = 0 makes p
    uniform over the visible keys, and v one-hot over 64 keys at a time makes
    out[r, c] = pd[r, key c], which is positive iff the key is kept."""
    dtype = torch.bfloat16
    q = torch.zeros(b, h, t, 64, device=device, dtype=dtype)
    k = torch.zeros(b, h, s, 64, device=device, dtype=dtype)
    pad = torch.zeros(b, s, device=device)
    got = torch.zeros(b, h, t, s, dtype=torch.bool, device=device)
    for c0 in range(0, s, 64):
        n = min(64, s - c0)
        v = torch.zeros(b, h, s, 64, device=device, dtype=dtype)
        v[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
        out = dropout_attention.flash_attention_dropout_fwd(q, k, v, pad, seed,
                                                            causal, rate)
        got[..., c0:c0 + n] = out[..., :n] > 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("seed,rate", [(20261016, 0.1), (2**31 - 2, 0.5)])
@pytest.mark.parametrize("b,h,t,s", [(32, 8, 99, 99), (3, 2, 7, 9),
                                     (2, 2, 128, 128), (2, 3, 100, 37)])
def test_dropout_forward_keep_mask_is_bitwise_plain_on_card(cuda, b, h, t, s,
                                                            seed, rate):
    """The keep bit each accumulator element of the bf16 forward draws is
    ``keep_mask``'s for the (row, key) it stands for: an output tolerance
    would not see a wrong bit on a small probability."""
    want = dropout_attention.keep_mask(
        t, s, rate, seed, torch.arange(b * h, device=cuda)).reshape(b, h, t, s)
    for causal in (False, True):
        got = _recovered_keep_mask(b, h, t, s, seed, rate, causal, cuda)
        torch.cuda.synchronize()
        visible = torch.ones(t, s, dtype=torch.bool, device=cuda)
        if causal:
            visible = visible.tril()
        assert torch.equal(got, want & visible)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,s,causal", DROPOUT_SHAPES + [(2, 2, 65, 64, True),
                                                             (2, 2, 64, 65, False)])
def test_dropout_forward_tilings_match_plain_on_card(cuda, b, h, t, s,
                                                     causal):
    """The bf16 tensor-core forward against the plain version, at a query
    block's and a key tile's edges too."""
    q, k, v, pad = _heads(b, h, t, s, torch.bfloat16, cuda)
    ref = dropout_attention.flash_attention_dropout_reference(
        q, k, v, pad, 1234, causal, 0.1)
    out = dropout_attention.flash_attention_dropout_fwd(q, k, v, pad, 1234,
                                                        causal, 0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


# ----------------------------------------------------------------------
# the any-shape kernels: head widths other than 64, dropout past 128
# ----------------------------------------------------------------------
def _wide_heads(b, h, t, s, hd, dtype, device, seed=11):
    """q, k ~ N(0, 1), v ~ U(-1, 1), do ~ N(0, 1) in (B, H, T|S, hd); (B, S)
    pads with every key of batch row 0 masked and key 0 of batch row 1."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    q, do = to(r.normal(size=(b, h, t, hd))), to(r.normal(size=(b, h, t, hd)))
    k = to(r.normal(size=(b, h, s, hd)))
    v = to(r.uniform(-1, 1, size=(b, h, s, hd)))
    pad = np.where(r.random((b, s)) > 0.8, -1e9, 0.0).astype(np.float32)
    pad[0] = -1e9
    pad[1, 0] = -1e9
    return q, k, v, torch.from_numpy(pad).to(device), do


ANY_SHAPES = [(3, 4, 40, 70, 136), (3, 2, 33, 31, 32), (2, 3, 5, 5, 16),
              (2, 2, 64, 64, 100), (2, 1, 9, 130, 256), (2, 2, 1, 1, 8),
              (2, 2, 33, 40, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,hd", ANY_SHAPES)
def test_attention_any_head_width_matches_plain_on_card(cuda, b, h, t, s, hd,
                                                        dtype, causal):
    """Every attention entry at head widths the tiled kernels do not take:
    the any-shape kernel against the plain versions, at the tiled kernels'
    limits, with a fully padded batch row and a row whose only visible key
    is padded."""
    from mit_tpu_torch.ops.flash_attention import (
        attention_kernel_for,
        flash_attention,
        flash_attention_btd_fusedqkv_reference,
        flash_attention_reference,
    )

    assert attention_kernel_for(hd) == "any_shape"
    q, k, v, pad, _ = _wide_heads(b, h, t, s, hd, dtype, cuda)
    tol = TOL[dtype]
    before = (flash_attention.launches, flash_attention_btd.launches,
              flash_attention_btd_fusedqkv.launches)
    out = flash_attention(q, k, v, pad, causal)
    ref = flash_attention_reference(q, k, v, pad, causal)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= \
        (1e-5 if dtype == torch.float32 else tol)

    merge = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], h * hd).contiguous()
    qm, km, vm = merge(q), merge(k), merge(v)
    for p in (pad, None):
        out = flash_attention_btd(qm, km, vm, p, causal, hd)
        ref = flash_attention_btd_reference(qm, km, vm, p, causal, hd)
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= tol

    qkv = torch.cat([km, km.flip(1), vm], -1).contiguous()   # T = S = s
    out = flash_attention_btd_fusedqkv(qkv, hd)
    ref = flash_attention_btd_fusedqkv_reference(qkv, hd)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (flash_attention.launches, flash_attention_btd.launches,
            flash_attention_btd_fusedqkv.launches) == \
        (before[0] + 1, before[1] + 2, before[2] + 1)


# heads wider than 64 on the tiled kernels: every padded width (80 to 128)
# and the widths padded up to them (72, 120); ViT-H/14's 257 tokens
WIDE_HDS = [72, 80, 96, 112, 120, 128]
WIDE_SHAPES = [(3, 2, 40, 70), (2, 3, 257, 257), (2, 2, 1, 1), (2, 2, 130, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s", WIDE_SHAPES)
@pytest.mark.parametrize("hd", WIDE_HDS)
def test_attention_wide_heads_match_plain_on_card(cuda, hd, b, h, t, s, dtype,
                                                  causal):
    """Every attention entry at head widths 72 to 128 runs the tiled
    kernels and matches its plain version, with a fully padded batch row
    and a row whose only visible key is padded; the int8 layer's numerics
    (bf16 in, f32 out) too."""
    from mit_tpu_torch.ops.flash_attention import (
        attention_kernel_for,
        flash_attention,
        flash_attention_reference,
    )

    assert attention_kernel_for(hd) == "tiled"
    q, k, v, pad, _ = _wide_heads(b, h, t, s, hd, dtype, cuda)
    tol = TOL[dtype]
    wrappers = (flash_attention, flash_attention_btd,
                flash_attention_btd_fusedqkv)
    before = [dict(w.kernels) for w in wrappers]
    out = flash_attention(q, k, v, pad, causal)
    ref = flash_attention_reference(q, k, v, pad, causal)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= \
        (1e-5 if dtype == torch.float32 else tol)

    merge = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], h * hd).contiguous()
    qm, km, vm = merge(q), merge(k), merge(v)
    for p in (pad, None):
        out = flash_attention_btd(qm, km, vm, p, causal, hd)
        ref = flash_attention_btd_reference(qm, km, vm, p, causal, hd)
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= tol

    qkv = torch.cat([km, km.flip(1), vm], -1).contiguous()   # T = S = s
    layers = (False, True) if dtype == torch.bfloat16 else (False,)
    for layer in layers:
        out = flash_attention_btd_fusedqkv(qkv, hd, layer)
        ref = flash_attention_btd_fusedqkv_reference(qkv, hd, layer)
        torch.cuda.synchronize()
        assert out.dtype == (torch.float32 if layer else dtype)
        assert (out.float() - ref.float()).abs().max().item() <= tol
    launched = [w.kernels["tiled"] - n["tiled"] for w, n in zip(wrappers, before)]
    assert launched == [1, 2, len(layers)]
    assert [w.kernels["any_shape"] for w in wrappers] == \
        [n["any_shape"] for n in before]


@pytest.mark.cuda
@pytest.mark.parametrize("warps", BF16_WARPS)
@pytest.mark.parametrize("hd", [80, 128])
def test_wide_bf16_tilings_match_plain_on_card(cuda, hd, warps):
    """Both tilings of the wide bf16 kernel (one warpgroup a block, or two)
    through the C entry, causal and padded, and at ViT-H/14's shape."""
    from mit_tpu_torch.ops.flash_attention import flash_attention_reference

    for b, h, t, s, causal in ((2, 3, 300, 333, True), (2, 16, 257, 257,
                                                          False)):
        q4, k4, v4, pad, _ = _wide_heads(b, h, t, s, hd, torch.bfloat16, cuda)
        merge = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], h * hd
                                                    ).contiguous()
        q, k, v = merge(q4), merge(k4), merge(v4)
        out = torch.empty_like(q)
        rc = kernels.lib().mit_flash_attention_btd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), b, t, s, h * hd, hd, int(causal), 1,
            *bf16_tiling(t, warps), torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "mit_flash_attention_btd_bf16")
        ref = flash_attention_btd_reference(q, k, v, pad, causal, hd)
        out4 = torch.empty_like(q4)
        rc = kernels.lib().mit_flash_attention_bhtd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), pad.data_ptr(),
            out4.data_ptr(), b, h, t, s, hd, int(causal), 1, 1,
            *bf16_tiling(t, warps), torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "mit_flash_attention_bhtd")
        ref4 = flash_attention_reference(q4, k4, v4, pad, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(out4).all()
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        assert (out4.float() - ref4.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [60, 136, 129])
def test_wide_entries_refuse_other_head_widths_on_card(cuda, hd):
    """The C entries of the tiled kernels return an error for a head width
    they have no instantiation for, instead of running one."""
    b, t, h = 1, 8, 2
    q = torch.zeros(b, t, h * hd, dtype=torch.bfloat16, device=cuda)
    out = torch.empty_like(q)
    rc = kernels.lib().mit_flash_attention_btd_bf16(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), None, out.data_ptr(), b, t,
        t, h * hd, hd, 0, 0, *bf16_tiling(t),
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


DROPOUT_ANY_SHAPES = [(2, 2, 160, 160, 64), (2, 2, 129, 40, 64),
                      (2, 2, 40, 129, 64), (3, 4, 40, 70, 128),
                      (3, 2, 33, 31, 32), (2, 1, 7, 9, 256), (2, 2, 1, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,hd", DROPOUT_ANY_SHAPES)
def test_dropout_attention_any_shape_matches_plain_on_card(cuda, b, h, t, s,
                                                           hd, dtype, causal):
    """The any-shape dropout kernels, forward and backward, at the tiled
    kernels' bounds (forward 1e-5 in f32, TOL in bf16; dq, dk, dv within
    1e-5 and 1e-2 of their largest value), and through autograd."""
    assert dropout_attention.dropout_kernel_for(hd, t, s) == "any_shape"
    q, k, v, pad, do = _wide_heads(b, h, t, s, hd, dtype, cuda)
    seed, rate = 4321, 0.2
    out = dropout_attention.flash_attention_dropout_fwd(q, k, v, pad, seed,
                                                        causal, rate)
    ref = dropout_attention.flash_attention_dropout_reference(
        q, k, v, pad, seed, causal, rate)
    grads = dropout_attention.flash_attention_dropout_bwd(
        q, k, v, pad, do, seed, causal, rate)
    want = dropout_attention.flash_attention_dropout_reference_backward(
        q, k, v, pad, do, seed, causal, rate)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in (out, *grads))
    assert (out.float() - ref.float()).abs().max().item() <= \
        (1e-5 if dtype == torch.float32 else TOL[dtype])
    for g, w in zip(grads, want):
        assert _norm_err(g, w) <= (1e-5 if dtype == torch.float32 else 1e-2)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (dropout_attention.flash_attention_dropout_fwd.launches,
              dropout_attention.flash_attention_dropout_bwd.launches)
    o = dropout_attention.flash_attention_dropout(*leaves, pad, seed, causal,
                                                  rate)
    auto = torch.autograd.grad(o, leaves, do)
    assert (dropout_attention.flash_attention_dropout_fwd.launches,
            dropout_attention.flash_attention_dropout_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(auto, grads):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,rate", [(20261016, 0.1), (2**31 - 2, 0.5)])
@pytest.mark.parametrize("b,h,t,s,hd", [(2, 2, 160, 160, 64),
                                        (3, 2, 33, 70, 128)])
def test_dropout_any_shape_keep_mask_is_bitwise_plain_on_card(cuda, b, h, t, s,
                                                              hd, seed, rate):
    """The any-shape forward's keep-mask, recovered from its output (q = k =
    0, v one-hot over hd keys at a time), is ``keep_mask`` bit for bit."""
    want = dropout_attention.keep_mask(
        t, s, rate, seed, torch.arange(b * h, device=cuda)).reshape(b, h, t, s)
    q = torch.zeros(b, h, t, hd, device=cuda)
    k = torch.zeros(b, h, s, hd, device=cuda)
    pad = torch.zeros(b, s, device=cuda)
    for causal in (False, True):
        got = torch.zeros(b, h, t, s, dtype=torch.bool, device=cuda)
        for c0 in range(0, s, hd):
            n = min(hd, s - c0)
            v = torch.zeros(b, h, s, hd, device=cuda)
            v[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
            out = dropout_attention.flash_attention_dropout_fwd(
                q, k, v, pad, seed, causal, rate)
            got[..., c0:c0 + n] = out[..., :n] > 0
        visible = torch.ones(t, s, dtype=torch.bool, device=cuda)
        if causal:
            visible = visible.tril()
        assert torch.equal(got, want & visible)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,t", [(128, 40), (32, 160), (64, 160)])
def test_multihead_attention_runs_a_kernel_at_any_shape_on_card(cuda, hd, t,
                                                                dtype):
    """``multihead_attention`` with ``use_kernel`` on the card launches a
    kernel at head widths other than 64 and, with fused dropout, past 128
    tokens: it never gives way to the plain path there, forward or backward."""
    from mit_tpu_torch.ops import attention as attn

    heads, b, rate = 2, 2, 0.25
    d = heads * hd
    r = np.random.default_rng(5)
    p = {w: torch.from_numpy(r.normal(size=(d, d)).astype(np.float32) * 0.1
                             ).to(cuda) for w in ("wq", "wk", "wv", "wo")}
    p.update({"b" + w[1]: torch.zeros(d, device=cuda) for w in list(p)})
    x = torch.from_numpy(r.normal(size=(b, t, d)).astype(np.float32)).to(cuda)
    pad = torch.from_numpy(np.where(r.random((b, t)) > 0.8, -1e9, 0.0)
                           .astype(np.float32)).to(cuda)
    counters = (flash_attention_btd,
                dropout_attention.flash_attention_dropout_fwd,
                dropout_attention.flash_attention_dropout_bwd)
    before = [c.launches for c in counters]
    routes = dict(attn.multihead_attention.routes)
    outs = {}
    for use_kernel in (True, False):
        xg = x.clone().requires_grad_()
        gens = attn.DropoutGenerators.for_step(3, 1, cuda)
        plain = attn.multihead_attention(p, xg, xg, heads, None, dtype,
                                         use_kernel, True, pad)
        dropped = attn.multihead_attention(
            p, xg, xg, heads, None, dtype, use_kernel, True, pad, rate, gens,
            False, True)
        (g,) = torch.autograd.grad(dropped.float().square().sum(), xg)
        outs[use_kernel] = (plain, dropped, g)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    after = attn.multihead_attention.routes
    assert (after["kernel"] - routes["kernel"],
            after["plain"] - routes["plain"]) == (2, 2)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b_ in zip(outs[True], outs[False]):
        assert _norm_err(a, b_) <= tol


# ----------------------------------------------------------------------
# the continuously batched service on the card
# ----------------------------------------------------------------------
SVC_MAXLEN, SVC_VOCAB, SVC_END = 24, 500, 3


def _service_captioner(device, mode, fused, end_bias=3.0):
    """A 2-layer decoder at the fused kernel's geometry (512 wide, 8 heads),
    seeded weights with the END logit's bias raised so that captions end at
    several lengths, over the tiny encoder preset (17 rows of full memory)."""
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import PRESETS

    class Ids:
        pad_id, start_id, end_id, unk_id = 0, 2, SVC_END, 1

    cfg = DecoderConfig(vocab_size=SVC_VOCAB, embed_dim=512, num_heads=8,
                        num_layers=2, ff_dim=512, max_seq_len=SVC_MAXLEN)
    dec = init_decoder_params(torch.Generator().manual_seed(0), cfg, device)
    dec["fc_out_b"][SVC_END] = end_bias
    name = "mit/tiny-vit-debug"
    return Captioner({"decoder": dec, "encoder": {}},
                     ModelConfig(name, PRESETS[name], cfg, mode), Ids(),
                     torch.float32, fused_decode=fused)


def _service_rows(cap, mems, **kw):
    """Every request through a 3-slot service → whole rows, PAD after END."""
    from mit_tpu_torch.decode.service import CaptionService

    svc = CaptionService(cap, num_slots=3, **kw)
    rids = svc.submit_memory_batch(mems)
    res = svc.run_to_completion()
    return [res[r] + [0] * (SVC_MAXLEN - len(res[r])) for r in rids], svc


def _service_memories(device, s, n=10):
    m = np.random.default_rng(3).normal(size=(n, s, 512)).astype(np.float32)
    return torch.from_numpy(m).to(device)


@pytest.mark.cuda
def test_fused_service_kernel_equals_plain_layer_and_batch_on_card(cuda):
    """CLS memory, f32, the fused route at per-row positions: the service's
    tokens on the kernel, with the plain fused layer swapped in, and the
    batch loop's ``fused=True`` tokens are identical; every layer of every
    step launched the kernel."""
    from mit_tpu_torch.decode import step
    from mit_tpu_torch.decode.greedy import greedy_generate
    from mit_tpu_torch.ops.decode_layer import (
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    cap = _service_captioner(cuda, "cls", fused=True)
    mems = _service_memories(cuda, 1)
    before, routes = fused_decode_layer.launches, dict(step.decoder_step.routes)
    kernel, svc = _service_rows(cap, mems, steps_per_sync=4)
    launched = fused_decode_layer.launches - before
    fused_steps = step.decoder_step.routes["fused"] - routes["fused"]
    assert step.decoder_step.routes["unfused"] == routes["unfused"]
    assert fused_steps > 0 and launched == 2 * fused_steps
    kernel_fn = step.fused_decode_layer
    step.fused_decode_layer = fused_decode_layer_plain
    try:
        plain, _ = _service_rows(cap, mems, steps_per_sync=4)
    finally:
        step.fused_decode_layer = kernel_fn
    tokens, _ = greedy_generate(cap.params["decoder"], cap.mcfg.decoder, mems,
                                2, SVC_END, 0, SVC_MAXLEN, fused=True)
    assert kernel == plain == tokens.tolist()
    lengths = {r.index(SVC_END) + 1 if SVC_END in r else SVC_MAXLEN
               for r in kernel}
    assert len(lengths) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cls", "full"])
def test_unfused_service_equals_batch_greedy_on_card(cuda, mode):
    """The unfused service (CLS memory; full memory, which has no fused
    route) against batch greedy on the card, f32: identical tokens, and no
    fused step and no kernel launch of the decode layer."""
    from mit_tpu_torch.decode import step
    from mit_tpu_torch.decode.greedy import greedy_generate
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer

    cap = _service_captioner(cuda, mode, fused=(mode == "full"))
    s = cap.mcfg.vision.seq_len if mode == "full" else 1
    mems = _service_memories(cuda, s)
    before, routes = fused_decode_layer.launches, dict(step.decoder_step.routes)
    rows, svc = _service_rows(cap, mems, steps_per_sync=3, cache_len=12)
    assert fused_decode_layer.launches == before
    assert step.decoder_step.routes["fused"] == routes["fused"]
    tokens, _ = greedy_generate(cap.params["decoder"], cap.mcfg.decoder, mems,
                                2, SVC_END, 0, SVC_MAXLEN)
    assert rows == tokens.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(4, 480, 640), (3, 100, 80)])
@pytest.mark.parametrize("name", ["google/vit-base-patch16-224-in21k",
                                  "openai/clip-vit-large-patch14",
                                  "Salesforce/blip-image-captioning-base"])
def test_device_preprocess_on_card_matches_cpu(cuda, name, b, h, w):
    """The uint8 path on the card against the same call on the CPU (which
    tests/test_torch_preprocess.py holds to the JAX package): within 1e-4 of
    the normalized output, bilinear and bicubic, down and up."""
    from mit_tpu_torch.data.preprocess import device_preprocess

    u8 = torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, h, w, 3), dtype=np.uint8))
    card = device_preprocess(u8.to(cuda), name)
    assert card.device.type == "cuda" and card.is_contiguous()
    torch.testing.assert_close(card.cpu(), device_preprocess(u8, name),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_pretrained_clip_tower_kernel_matches_plain_on_card(cuda, tmp_path):
    """A CLIP ViT-L/14-wide tower at two layers, written as a composite HF
    checkpoint and loaded onto the card: bit-equal weights, and its forward
    through flash_attention_btd within 1e-4 of the plain path, f32, full
    sequence and CLS only."""
    import json

    from mit_tpu_torch.models.pretrained import load_pretrained_encoder
    from mit_tpu_torch.models.vision import (PRESETS,
                                             hf_vision_state_dict_from_params,
                                             init_vision_params, vision_forward)
    from mit_tpu_torch.train.checkpoint import save_file

    vcfg = PRESETS["openai/clip-vit-large-patch14"]._replace(num_layers=2)
    params = init_vision_params(torch.Generator().manual_seed(0), vcfg)
    save_file(hf_vision_state_dict_from_params(params, vcfg, "vision_model."),
              str(tmp_path / "model.safetensors"))
    vision = {"hidden_size": 1024, "num_hidden_layers": 2,
              "num_attention_heads": 16, "intermediate_size": 4096,
              "image_size": 224, "patch_size": 14}
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "clip", "vision_config": vision}))
    cfg, loaded = load_pretrained_encoder(str(tmp_path), device=cuda)
    assert cfg == vcfg
    assert loaded["patch_w"].device.type == "cuda"
    torch.testing.assert_close(loaded["layers"]["fc1"].cpu(),
                               params["layers"]["fc1"], rtol=0, atol=0)
    px = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 3, 224, 224)).astype(np.float32)).to(cuda)
    before = flash_attention_btd.launches
    with torch.no_grad():
        for cls_only in (False, True):
            kern = vision_forward(loaded, cfg, px, cls_only=cls_only)
            plain = vision_forward(loaded, cfg, px, use_kernel=False,
                                   cls_only=cls_only)
            torch.testing.assert_close(kern, plain, rtol=0, atol=1e-4)
    assert flash_attention_btd.launches - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,hd,d,m", [
    (8, 8, 99, 99, 64, 2, 1), (8, 8, 99, 99, 64, 1, 2),
    (4, 4, 99, 99, 64, 2, 2), (4, 4, 40, 160, 32, 2, 2)],
    ids=["dp", "tp", "dp_x_tp", "any_shape"])
def test_dropout_cell_map_gives_the_global_launchs_slice_on_card(
        cuda, dtype, b, h, t, s, hd, d, m):
    """A mesh rank's launch at its cell map (b_offset, h_total, h_offset):
    the dump kernel's mask, the forward's output and the backward's dq, dk,
    dv bitwise equal to its slice of the global launch's (cells are
    independent), and the mask to the plain mask at the map."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(b, h, n, hd, generator=g).to(cuda, dtype)
                   for n in (t, s, s, t))
    pad = torch.zeros(b, s, device=cuda)
    pad[0, -5:] = -1e9
    seed, rate = 77, 0.2
    da = dropout_attention
    whole = da.dump_dropout_mask(b, h, t, s, seed, rate, cuda)
    out = da.flash_attention_dropout_fwd(q, k, v, pad, seed, True, rate)
    grads = da.flash_attention_dropout_bwd(q, k, v, pad, do, seed, True, rate)
    for i in range(d):
        for j in range(m):
            rows = slice(i * b // d, (i + 1) * b // d)
            heads = slice(j * h // m, (j + 1) * h // m)
            cells = (rows.start, h, heads.start)
            part = lambda x: x[rows, heads].contiguous()
            args = (part(q), part(k), part(v), pad[rows].contiguous())
            mask = da.dump_dropout_mask(b // d, h // m, t, s, seed, rate, cuda,
                                        cells)
            got = da.flash_attention_dropout_fwd(*args, seed, True, rate, cells)
            got_g = da.flash_attention_dropout_bwd(*args, part(do), seed, True,
                                                   rate, cells)
            torch.cuda.synchronize()
            assert torch.equal(mask, part(whole))
            assert torch.equal(mask.cpu(), da.dump_dropout_mask(
                b // d, h // m, t, s, seed, rate, "cpu", cells))
            assert torch.equal(got, part(out))
            for x, y in zip(got_g, grads):
                assert torch.equal(x, part(y))


# ----------------------------------------------------------------------
# the float encoder's elementwise passes (csrc/encoder_fused.cu)
# ----------------------------------------------------------------------
def _boundary_inputs(m, d, dtype, device, seed, which):
    """x, a, bias, ln of one boundary; ``which``: "boundary" (all four),
    "no_residual" (a and ln: ln_pre, layer 0's ln1), "no_ln" (no h: the
    last boundary of a tower without ln_post), "cls_rows" (x the CLS rows
    of a (m, 9, d) stream)."""
    g = torch.Generator().manual_seed(seed)
    stream = (torch.randn(m, 9, d, generator=g) * 2).to(device, dtype)
    x = stream[:, :1] if which == "cls_rows" else stream[:, 0]
    a = (torch.randn(*x.shape, generator=g) + 0.5).to(device, dtype)
    bias = (torch.randn(d, generator=g) * 0.3).to(device)
    ln = {"scale": (1 + 0.2 * torch.randn(d, generator=g)).to(device),
          "bias": (0.1 * torch.randn(d, generator=g)).to(device)}
    if which == "no_residual":
        return None, a, None, ln
    return x, a, bias, None if which == "no_ln" else ln


def _within_one_rounding(got, want):
    """The LayerNorm's sums in another order: f32 within 1e-5; bf16 within
    one rounding (the spacing of bf16 at |want|) beyond that 1e-5, which
    an h near 0 needs, where the scale's and the shift's terms cancel."""
    if got.dtype == torch.bfloat16:
        hf = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(hf))) * 2.0 ** -7
        gap = (got.float() - want.float()).abs()
        assert bool((gap <= ulp + 1e-5).all()), (gap - ulp).max().item()
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["boundary", "no_residual", "no_ln",
                                   "cls_rows"])
@pytest.mark.parametrize("m,d", [(64 * 257, 1024), (64 * 197, 768),
                                 (37, 1280), (5, 48), (3, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_add_layer_norm_kernel_matches_plain_on_card(cuda, dtype, m, d,
                                                     which):
    """At the main path's shapes (CLIP-L's and ViT-B's batch 64), ragged and
    the widest: y bitwise the plain version's, h within one rounding."""
    x, a, bias, ln = _boundary_inputs(m, d, dtype, cuda, d, which)
    before = encoder_fused.add_layer_norm.launches
    with torch.no_grad():
        y, h = encoder_fused.add_layer_norm(x, a, bias, ln, 1e-5)
        y_p, h_p = encoder_fused.add_layer_norm_reference(x, a, bias, ln,
                                                          1e-5)
    torch.cuda.synchronize()
    assert encoder_fused.add_layer_norm.launches == before + 1
    assert torch.equal(y, y_p) and y.shape == a.shape
    if ln is None:
        assert h is None
    else:
        assert h.is_contiguous() and h.shape == a.shape
        _within_one_rounding(h, h_p)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("m,f", [(64 * 257, 4096), (64 * 197, 3072),
                                 (37, 5120), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bias_act_kernel_matches_plain_on_card(cuda, dtype, m, f, act):
    """At fc1's shapes of the main paths and a ragged one: bitwise the
    plain composition's (bias cast, add, the activation's rounded steps)."""
    g = torch.Generator().manual_seed(f)
    a = (torch.randn(m, f, generator=g) * 3).to(cuda, dtype)
    bias = (torch.randn(f, generator=g) * 0.3).to(cuda)
    before = encoder_fused.bias_act.launches
    with torch.no_grad():
        out = encoder_fused.bias_act(a, bias, act)
        want = encoder_fused.bias_act_reference(a, bias, act)
    torch.cuda.synchronize()
    assert encoder_fused.bias_act.launches == before + 1
    diff = (out.float() - want.float()).abs().max().item()
    assert torch.equal(out, want), diff


@pytest.mark.cuda
def test_encoder_fused_wrappers_refuse_on_card(cuda):
    x, a, bias, ln = _boundary_inputs(4, 768, torch.bfloat16, cuda, 0,
                                      "boundary")
    ef = encoder_fused
    with pytest.raises(TypeError):
        ef.add_layer_norm(None, a.half(), None, ln, 1e-5)
    with pytest.raises(ValueError, match="16-byte"):
        ef.add_layer_norm(None, a[:, 1:761], None,
                          {k: v[:760].contiguous() for k, v in ln.items()},
                          1e-5)
    with pytest.raises(ValueError):
        ef.add_layer_norm(x, a, bias.to(torch.bfloat16), ln, 1e-5)
    with pytest.raises(ValueError):
        ef.add_layer_norm(x, a, bias, {"scale": ln["scale"].cpu(),
                                       "bias": ln["bias"]}, 1e-5)
    with pytest.raises(ValueError):
        ef.add_layer_norm(None, torch.zeros(4, 2056, device=cuda,
                                            dtype=torch.bfloat16),
                          None, {"scale": torch.ones(2056, device=cuda),
                                 "bias": torch.zeros(2056, device=cuda)},
                          1e-5)
    with pytest.raises(ValueError):
        ef.bias_act(a[:, :764].contiguous(), bias[:764].contiguous(), "gelu")
    with pytest.raises(ValueError):
        ef.bias_act(a.t(), torch.zeros(4, device=cuda), "gelu")
    with pytest.raises(ValueError, match="unknown act"):
        ef.bias_act(a, bias, "relu")
    grad = a.float().requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        ef.bias_act(grad, bias, "gelu")


def _drawn_tower(preset, device):
    """A preset's float encoder with its biases and LayerNorm parameters
    drawn (an initializer's zeros and ones would hide a bias or a scale
    applied in the wrong place)."""
    from mit_tpu_torch.models.vision import PRESETS, init_vision_params

    vcfg = PRESETS[preset]
    g = torch.Generator().manual_seed(0)
    params = init_vision_params(g, vcfg)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k.startswith("b") or k in ("scale", "patch_b"):
                tree[k] = v + 0.05 * torch.randn(v.shape, generator=g)
    draw(params)
    return vcfg, {k: ({kk: ({k3: t.to(device) for k3, t in vv.items()}
                            if isinstance(vv, dict) else vv.to(device))
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to(device)) for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("preset", ["google/vit-base-patch16-224-in21k",
                                    "openai/clip-vit-large-patch14"],
                         ids=["vit_b16", "clip_l14"])
def test_float_encode_matches_the_old_composition_on_card(cuda, monkeypatch,
                                                          preset, dtype):
    """The whole float encode at batch 4, CLS and full memory, against the
    same encode with both kernels' wrappers replaced by the old composition
    (their plain versions): f32 within 1e-5 of the largest value, bf16
    within 2e-2 relative L2. An encode of L layers launches 2L + 1
    add_layer_norm kernels (one more with ln_pre) and L bias_act kernels,
    and runs no LayerNorm composition."""
    from mit_tpu_torch.models import vision

    vcfg, params = _drawn_tower(preset, cuda)
    px = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 3, 224, 224)).astype(np.float32)).to(cuda)
    ef = encoder_fused
    n_ln = 2 * vcfg.num_layers + 1 + vcfg.ln_pre
    def no_composition(*args, **kw):
        raise AssertionError("the kernel path ran a LayerNorm composition")

    for cls_only in (False, True):
        before = (ef.add_layer_norm.launches, ef.bias_act.launches)
        with monkeypatch.context() as m, torch.no_grad():
            m.setattr(vision, "layer_norm", no_composition)
            m.setattr(ef, "layer_norm", no_composition)
            got = vision.vision_forward(params, vcfg, px, dtype,
                                        cls_only=cls_only)
        after = (ef.add_layer_norm.launches, ef.bias_act.launches)
        assert tuple(x - y for x, y in zip(after, before)) == (
            n_ln, vcfg.num_layers)
        with monkeypatch.context() as m:
            m.setattr(vision, "add_layer_norm", ef.add_layer_norm_reference)
            m.setattr(vision, "bias_act", ef.bias_act_reference)
            with torch.no_grad():
                want = vision.vision_forward(params, vcfg, px, dtype,
                                             cls_only=cls_only)
        assert (ef.add_layer_norm.launches, ef.bias_act.launches) == after
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if dtype == torch.float32:
            err = (g - w).abs().max().item() / w.abs().max().item()
            assert err <= 1e-5, err
        else:
            rel = ((g - w).norm() / w.norm()).item()
            assert rel <= 2e-2, rel
