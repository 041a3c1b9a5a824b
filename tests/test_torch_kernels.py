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
from mit_tpu_torch.ops import dropout_attention, int8_layer, int8_mlp
from mit_tpu_torch.ops.flash_attention import (
    _check_cuda_inputs,
    _check_fusedqkv,
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


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, pad = _inputs(2, 8, 8, 128, True, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_btd(q, k, v, pad, False, 32)
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
    (dict(head_dim=32), ValueError),
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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [197, 1000, 7])
@pytest.mark.parametrize("k,n", GEMM_SHAPES + [(48, 40)])
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
@pytest.mark.parametrize("b,t,d", [(4, 197, 768), (2, 257, 1024), (3, 13, 128)])
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
                                           (2, 257, 1024, 4096, 16)],
                         ids=["vit-b", "vit-l"])
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
            torch.zeros(2, 5, 96, device=cuda), 32)
    with pytest.raises(TypeError):
        flash_attention_btd_fusedqkv(
            torch.zeros(2, 5, 192, device=cuda), 64, layer_numerics=True)
    with pytest.raises(TypeError):
        int8_layer.fused_int8_vit_layer(
            x.half().reshape(2, 4, 64), *_layer_weights(64, 128, cuda), 1,
            1e-6)


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
    (dict(head_dim=32), ValueError),
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
def test_dropout_attention_autograd_on_card(cuda):
    """The autograd Function launches the forward and backward kernels and
    gives the plain autograd version's gradients."""
    q, k, v, pad = _heads(4, 8, 99, 99, torch.float32, cuda)
    grads = []
    counts = []
    for fn in (dropout_attention.flash_attention_dropout,
               dropout_attention.flash_attention_dropout_plain):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        before = (dropout_attention.flash_attention_dropout_fwd.launches,
                  dropout_attention.flash_attention_dropout_bwd.launches)
        out = fn(*qkv, pad, 99, True, 0.1)
        grads.append(torch.autograd.grad(out.square().sum(), qkv))
        counts.append((dropout_attention.flash_attention_dropout_fwd.launches
                       - before[0],
                       dropout_attention.flash_attention_dropout_bwd.launches
                       - before[1]))
    torch.cuda.synchronize()
    assert counts == [(1, 1), (0, 0)]
    for a, b in zip(*grads):
        assert _norm_err(a, b) <= 1e-5


@pytest.mark.cuda
def test_dropout_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, pad = _heads(2, 2, 9, 9, torch.float32, cuda)
    fwd = dropout_attention.flash_attention_dropout_fwd
    with pytest.raises(TypeError):
        fwd(q.half(), k.half(), v.half(), pad, 0, True, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, pad, 0,
            True, 0.1)
    big = torch.zeros(1, 1, 129, 64, device=cuda)
    with pytest.raises(ValueError, match="128"):
        fwd(big, big, big, torch.zeros(1, 129, device=cuda), 0, True, 0.1)


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
@pytest.mark.parametrize("stagger", [True, False], ids=["stagger", "lockstep"])
@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("b", [7, 64])
def test_fused_decode_layer_design_choices_agree_on_card(cuda, b, rows, stagger):
    """Rows per block and the staggered walk change f32 summation order
    only: every choice stays within the kernel's bound of the plain version."""
    from mit_tpu_torch.ops.decode_layer import (
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    args = _decode_layer_case(b, 33, torch.float32, cuda, True)
    out = fused_decode_layer(*args, rows_per_block=rows, stagger=stagger)
    for o, r in zip(out, fused_decode_layer_plain(*args)):
        assert (o - r).abs().max().item() <= 1e-5


def test_fused_decode_layer_cpu_takes_the_plain_version():
    from mit_tpu_torch.ops.decode_layer import (
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    args = _decode_layer_case(3, 7, torch.float32, "cpu", True, f=64)
    before = fused_decode_layer.launches
    out = fused_decode_layer(*args, rows_per_block=2, stagger=False)
    assert fused_decode_layer.launches == before
    for o, r in zip(out, fused_decode_layer_plain(*args)):
        assert torch.equal(o, r)
    with pytest.raises(ValueError, match="rows_per_block"):
        fused_decode_layer(*args, rows_per_block=3)


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
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), None, False)
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
