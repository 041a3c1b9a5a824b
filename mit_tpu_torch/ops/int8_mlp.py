"""int8 (W8A8) GEMMs of the encoder: row quantization, the int8 GEMM with
its epilogues, the fused MLP half, ``int8_linear`` and ``fused_int8_mlp``
(port of ``mit_tpu/ops/pallas_int8_mlp.py`` and of the MLP pass of
``mit_tpu/ops/pallas_int8_layer.py``).

Three hand-written CUDA kernels do the work on the card:

- ``csrc/quantize_rows.cu``: (M, K) f32/bf16 → int8 codes and an f32 scale
  per row, optionally after a LayerNorm in f32 (the fused layer's
  prologue);
- ``csrc/int8_gemm.cu``: int8 (M, K) · int8 (K, N) → exact int32 →
  ``acc·(sx[m]·s_w[n]) + bias[n]`` → optional GELU (polynomial erf) or
  quick_gelu → optional f32/bf16 residual add → f32 or bf16 (or the raw
  int32 accumulators, for checking);
- ``csrc/int8_mlp_fused.cu``: the whole MLP half, [LayerNorm →] quantize →
  fc1 + act → quantize → fc2 [+ residual], in one launch: a cluster of 8
  blocks holds 64 rows and keeps the f32 hidden and its int8 codes in
  shared memory (the TPU kernels kept it in VMEM).

``int8_linear`` (the TPU ``_linear_kernel``) is quantize + GEMM.
``fused_int8_mlp`` (the TPU ``_mlp_kernel``) and the fused layer's MLP
half (``_mlp_half_kernel`` / ``_mlp_body``) go through :func:`mlp_half`:
one ``int8_mlp_fused`` launch where :func:`mlp_kernel_for` names the
kernel (the (D, F) pairs of the supported presets, up to the rows at which
it beat the composition on the card: small batches and the CLS rows), else
the composition quantize → fc1 + act → quantize → fc2, whose f32 hidden
makes a round trip through device memory. Both routes give the same
numbers (bit for bit on the card, up to the last ulp of ``expf`` in
quick_gelu).

Every wrapper takes its plain PyTorch version (``*_reference``) for CPU
tensors only; a CUDA tensor launches the kernel or raises. Each counts its
kernel launches in ``<wrapper>.launches``; ``fused_int8_mlp.kernels`` counts
its calls by route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mit_tpu_torch.kernels import ptr, require_cuda, stream
from mit_tpu_torch.ops.quant import QuantizedLinear, dynamic_quantize, int8_accumulate

ACTS = ("none", "gelu", "quick_gelu")
_ACT_CODE = {name: i for i, name in enumerate(ACTS)}
# GEMM output kinds the kernel writes; int32 is the raw accumulator
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_RES_CODE = {None: 0, torch.float32: 1, torch.bfloat16: 2}
# quantize_rows stages one row in shared memory as f32 (48 KB without opt-in)
QUANT_MAX_K = 12288
# the (D, F) pairs csrc/int8_mlp_fused.cu is built for: ViT-B/16, CLIP-B/32
# and BLIP-base; CLIP ViT-L/14; ViT-H/14. A cluster of MLP_CLUSTER blocks
# holds MLP_ROWS rows; block r owns F / MLP_CLUSTER hidden columns (two
# warpgroups of chunks of MLP_CHUNK) and D / MLP_CLUSTER output columns.
FUSED_MLP_SHAPES = ((768, 3072), (1024, 4096), (1280, 5120))
MLP_CLUSTER, MLP_ROWS, MLP_CHUNK = 8, 64, 64
# The most rows at which the card's path sends an MLP half to the fused
# kernel, by (D, F): the largest batch of ViT-B's 197, CLIP-L's and ViT-H's
# 257 tokens at which it beat the composition in turns on an H100 (PERF.md,
# tools/mlp_phases.py --sweep). Past them its clusters run their phases one
# after another in too many waves; below, the composition's four launches
# cost more. The CLS rows of the last layer (the batch) always fit.
MLP_KERNEL_MAX_ROWS = {(768, 3072): 16 * 197, (1024, 4096): 4 * 257,
                       (1280, 5120): 2 * 257}

# odd-polynomial least-squares fit of erf(z) = z * P(z^2) on |z| <= 3
# (pallas_int8_mlp.py:39-46); csrc/int8_gemm.cu carries the same numbers
_ERF_C = (
    1.1265645860e+00, -3.6740184481e-01, 1.0037558057e-01,
    -1.8627491535e-02, 2.1716450163e-03, -1.4152522556e-04,
    3.8978985791e-06,
)


def _erf(z: torch.Tensor) -> torch.Tensor:
    """erf as the int8 kernels compute it: the odd polynomial on |z| <= 3,
    clamped outside; max abs error about 1e-3 against exact erf."""
    z = torch.clamp(z, -3.0, 3.0)
    u = z * z
    p = torch.full_like(z, _ERF_C[6])
    for k in (5, 4, 3, 2, 1, 0):
        p = p * u + _ERF_C[k]
    return z * p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865475))


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return _gelu(h)
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act != "none":
        raise ValueError(f"unknown act {act!r}; choose one of {ACTS}")
    return h


def _ln(x: torch.Tensor, ln: dict, eps: float) -> torch.Tensor:
    """The fused layer's LayerNorm in f32 (``pallas_int8_layer.py:42-45``):
    mean, biased variance, rsqrt(var + eps), scale, bias."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * ln["scale"] + ln["bias"]


# ----------------------------------------------------------------------
# quantize_rows
# ----------------------------------------------------------------------
def quantize_rows_reference(x: torch.Tensor, ln: Optional[dict] = None,
                            eps: float = 0.0):
    """x (M, K) → (x8 (M, K) int8, sx (M,) f32); with ``ln`` ({"scale",
    "bias"} f32 (K,)) the row is LayerNormed in f32 first."""
    xf = x.float()
    if ln is not None:
        xf = _ln(xf, ln, eps)
    x8, sx = dynamic_quantize(xf)
    return x8, sx[:, 0]


def _check_quantize_rows(x: torch.Tensor, ln: Optional[dict]) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or not 0 < x.shape[1] <= QUANT_MAX_K:
        raise ValueError(
            f"x must be (M, K) with M > 0 and 0 < K <= {QUANT_MAX_K}, got "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if ln is not None:
        for key in ("scale", "bias"):
            p = ln[key]
            if (p.dtype != torch.float32 or tuple(p.shape) != (x.shape[1],)
                    or not p.is_contiguous() or p.device != x.device):
                raise ValueError(
                    f"ln[{key!r}] must be contiguous float32 ({x.shape[1]},) "
                    f"on {x.device}, got {p.dtype} {tuple(p.shape)}"
                )


def quantize_rows(x: torch.Tensor, ln: Optional[dict] = None,
                  eps: float = 0.0):
    """Per-row int8 quantization, with an optional f32 LayerNorm prologue.

    Codes are ``rint(x * (127 / amax))`` clipped to ±127 and the scale is
    ``amax * (1/127)``, amax floored at 1e-8: bitwise the plain version's
    and the JAX package's for the same f32 row.
    """
    if x.device.type == "cpu":
        return quantize_rows_reference(x, ln, eps)
    require_cuda(x, "quantize_rows")
    _check_quantize_rows(x, ln)

    from mit_tpu_torch import kernels

    m, k = x.shape
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    name = ("mit_quantize_rows_bf16" if x.dtype == torch.bfloat16
            else "mit_quantize_rows_f32")
    with torch.cuda.device(x.device):
        rc = getattr(kernels.lib(), name)(
            x.data_ptr(), ptr(None if ln is None else ln["scale"]),
            ptr(None if ln is None else ln["bias"]), x8.data_ptr(),
            sx.data_ptr(), m, k, float(eps), stream(x),
        )
    kernels.check(rc, name)
    quantize_rows.launches += 1
    return x8, sx


quantize_rows.launches = 0


# ----------------------------------------------------------------------
# int8_gemm
# ----------------------------------------------------------------------
def int8_gemm_reference(a8: torch.Tensor, sx: torch.Tensor,
                        q: QuantizedLinear, act: str = "none",
                        residual: Optional[torch.Tensor] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """a8 (M, K) int8 with row scales sx (M,) · q → (M, N).

    ``acc·(sx·s_w) + bias`` (the scale product first, as ``_dq`` forms it),
    then ``act``, then ``residual + y`` in f32, cast to ``out_dtype``.
    ``out_dtype=torch.int32`` returns the accumulators themselves.
    """
    acc = int8_accumulate(a8, q.w8)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * (sx[:, None] * q.scale[None, :])
    if q.bias is not None:
        y = y + q.bias[None, :]
    y = _act(y, act)
    if residual is not None:
        y = residual.float() + y
    return y.to(out_dtype)


def _check_gemm(a8, sx, q: QuantizedLinear, act, residual, out_dtype) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; choose one of {ACTS}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"out_dtype must be one of {list(_OUT_CODE)}, got "
                        f"{out_dtype}")
    w8 = q.w8
    if a8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"a8 and w8 must be int8, got {a8.dtype}, {w8.dtype}")
    if a8.dim() != 2 or w8.dim() != 2 or a8.shape[1] != w8.shape[0]:
        raise ValueError(
            f"need a8 (M, K) and w8 (K, N); got {tuple(a8.shape)}, "
            f"{tuple(w8.shape)}"
        )
    m, k = a8.shape
    n = w8.shape[1]
    if m == 0 or k == 0 or k % 16 or n == 0 or n % 8:
        raise ValueError(
            f"the int8 GEMM takes M > 0, K a multiple of 16 and N a multiple "
            f"of 8; got M={m}, K={k}, N={n}"
        )
    if not a8.is_contiguous() or not w8.t().is_contiguous():
        raise ValueError(
            "a8 must be contiguous and w8 stored K-contiguous per column "
            "(ops.quant.kernel_layout)"
        )
    aligned = [a8, w8, q.scale, q.bias, residual]
    if any(t is not None and t.data_ptr() % 16 for t in aligned):
        raise ValueError("a8, w8, the scale, the bias and the residual must "
                         "start on a 16-byte boundary")
    vectors = [("sx", sx, m), ("scale", q.scale, n)]
    if q.bias is not None:
        vectors.append(("bias", q.bias, n))
    for name, v, size in vectors:
        if (v.dtype != torch.float32 or tuple(v.shape) != (size,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({size},), "
                             f"got {v.dtype} {tuple(v.shape)}")
    if residual is not None:
        if residual.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"residual must be float32 or bfloat16, got "
                            f"{residual.dtype}")
        if tuple(residual.shape) != (m, n) or not residual.is_contiguous():
            raise ValueError(f"residual must be contiguous ({m}, {n}), got "
                             f"{tuple(residual.shape)}")
        if out_dtype == torch.int32:
            raise ValueError("the raw int32 output takes no residual")
    tensors = [a8, sx, w8, q.scale, q.bias, residual]
    if any(t is not None and t.device != a8.device for t in tensors):
        raise ValueError("the int8 GEMM's operands must be on one device")


def int8_gemm(a8: torch.Tensor, sx: torch.Tensor, q: QuantizedLinear,
              act: str = "none", residual: Optional[torch.Tensor] = None,
              out_dtype=torch.float32) -> torch.Tensor:
    """The int8 GEMM with its epilogue; see :func:`int8_gemm_reference`."""
    if a8.device.type == "cpu":
        return int8_gemm_reference(a8, sx, q, act, residual, out_dtype)
    require_cuda(a8, "int8_gemm")
    _check_gemm(a8, sx, q, act, residual, out_dtype)

    from mit_tpu_torch import kernels

    m, k = a8.shape
    n = q.w8.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a8.device)
    with torch.cuda.device(a8.device):
        rc = kernels.lib().mit_int8_gemm(
            a8.data_ptr(), q.w8.data_ptr(), sx.data_ptr(),
            q.scale.data_ptr(), ptr(q.bias), ptr(residual), out.data_ptr(),
            m, n, k, _ACT_CODE[act],
            _RES_CODE[None if residual is None else residual.dtype],
            _OUT_CODE[out_dtype], stream(a8),
        )
    kernels.check(rc, "mit_int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


# ----------------------------------------------------------------------
# int8_linear: quantize_rows then int8_gemm
# ----------------------------------------------------------------------
def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _linear(x, q, out_dtype, quant, gemm):
    x8, sx = quant(_rows(x))
    return gemm(x8, sx, q, out_dtype=out_dtype).reshape(*x.shape[:-1], -1)


def _gemm_any_k(a8, sx, q: QuantizedLinear, **kw) -> torch.Tensor:
    """:func:`int8_gemm` for any K: zero columns of a8 and zero rows of w8
    up to a multiple of 16 leave the accumulators as they are (CLIP
    ViT-L/14's patch embedding has K = 588)."""
    pad = -a8.shape[1] % 16
    if pad:
        a8 = F.pad(a8, (0, pad))
        q = q._replace(w8=F.pad(q.w8.t(), (0, pad)).t())
    return int8_gemm(a8, sx, q, **kw)


def _check_float(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")


def int8_linear_reference(x: torch.Tensor, q: QuantizedLinear,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) → quantize rows → int8 GEMM → (..., N) in ``out_dtype``."""
    return _linear(x, q, out_dtype, quantize_rows_reference,
                   int8_gemm_reference)


def int8_linear(x: torch.Tensor, q: QuantizedLinear,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """One int8 GEMM with its row quantization and dequant/bias epilogue
    (the TPU ``int8_linear``): ``quantize_rows`` then ``int8_gemm``."""
    if x.device.type == "cpu":
        return int8_linear_reference(x, q, out_dtype)
    require_cuda(x, "int8_linear")
    _check_float(x, "int8_linear")
    out = _linear(x, q, out_dtype, quantize_rows, _gemm_any_k)
    int8_linear.launches += 1
    return out


int8_linear.launches = 0


# ----------------------------------------------------------------------
# the MLP half: one fused kernel, or the composition of the two kernels
# ----------------------------------------------------------------------
def _mlp_half(x, q1, q2, act, ln, eps, residual, out_dtype, quant, gemm):
    x8, sx = quant(x, ln, eps)
    h = gemm(x8, sx, q1, act=act, out_dtype=torch.float32)
    h8, sh = quant(h)
    return gemm(h8, sh, q2, residual=x if residual else None,
                out_dtype=out_dtype)


def int8_mlp_fused_reference(x: torch.Tensor, q1: QuantizedLinear,
                             q2: QuantizedLinear, act: str = "gelu",
                             ln: Optional[dict] = None, eps: float = 0.0,
                             residual: bool = False,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, D) → [LayerNorm in f32] → quantize → fc1 + bias → act (f32) →
    quantize → fc2 + bias [+ x] → (M, D) in ``out_dtype``."""
    return _mlp_half(x, q1, q2, act, ln, eps, residual, out_dtype,
                     quantize_rows_reference, int8_gemm_reference)


def mlp_kernel_for(d: int, f: int, act: str, rows: int) -> str:
    """The route of an MLP half of ``rows`` rows on the card: "fused" (one
    ``int8_mlp_fused`` launch) at a (D, F) of ``MLP_KERNEL_MAX_ROWS`` up to
    its rows, with gelu or quick_gelu; "composition" (``quantize_rows``,
    ``int8_gemm``, ``quantize_rows``, ``int8_gemm``) at any other shape or
    activation."""
    fused = (rows <= MLP_KERNEL_MAX_ROWS.get((d, f), 0)
             and act in ACTS[1:])
    return "fused" if fused else "composition"


def _check_mlp_fused(x, q1: QuantizedLinear, q2: QuantizedLinear, act, ln,
                     out_dtype) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if act not in ACTS[1:]:
        raise ValueError(f"act must be 'gelu' or 'quick_gelu', got {act!r}")
    if x.dim() != 2 or x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (M, D) with M > 0, got "
                         f"{tuple(x.shape)}")
    d = x.shape[1]
    w1, w2 = q1.w8, q2.w8
    if w1.dtype != torch.int8 or w2.dtype != torch.int8:
        raise TypeError(f"w8 must be int8, got {w1.dtype}, {w2.dtype}")
    if (w1.dim() != 2 or w2.dim() != 2 or w1.shape[0] != d
            or tuple(w2.shape) != (w1.shape[1], d)):
        raise ValueError(f"need fc1 (D, F) and fc2 (F, D) for D = {d}; got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    f = w1.shape[1]
    if (d, f) not in FUSED_MLP_SHAPES:
        raise ValueError(f"the fused MLP kernel takes (D, F) in "
                         f"{FUSED_MLP_SHAPES}, got ({d}, {f})")
    if not w1.t().is_contiguous() or not w2.t().is_contiguous():
        raise ValueError("w8 must be stored K-contiguous per column "
                         "(ops.quant.kernel_layout)")
    vectors = [("fc1 scale", q1.scale, f), ("fc1 bias", q1.bias, f),
               ("fc2 scale", q2.scale, d), ("fc2 bias", q2.bias, d)]
    if ln is not None:
        vectors += [("ln scale", ln["scale"], d), ("ln bias", ln["bias"], d)]
    for name, v, size in vectors:
        if v is None:
            continue
        if (v.dtype != torch.float32 or tuple(v.shape) != (size,)
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({size},), "
                             f"got {v.dtype} {tuple(v.shape)}")
    tensors = [x, w1, w2, *(v for _, v, _ in vectors if v is not None)]
    if any(t.device != x.device for t in tensors):
        raise ValueError("the fused MLP's operands must be on one device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, the weights, scales, biases and LayerNorm "
                         "parameters must start on a 16-byte boundary")


def int8_mlp_fused(x: torch.Tensor, q1: QuantizedLinear, q2: QuantizedLinear,
                   act: str = "gelu", ln: Optional[dict] = None,
                   eps: float = 0.0, residual: bool = False,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The MLP half in one launch of ``csrc/int8_mlp_fused.cu``; see
    :func:`int8_mlp_fused_reference`. On the card it takes the (D, F)
    pairs of ``FUSED_MLP_SHAPES`` and raises at any other."""
    if x.device.type == "cpu":
        return int8_mlp_fused_reference(x, q1, q2, act, ln, eps, residual,
                                        out_dtype)
    require_cuda(x, "int8_mlp_fused")
    _check_mlp_fused(x, q1, q2, act, ln, out_dtype)

    from mit_tpu_torch import kernels

    m, d = x.shape
    f = q1.w8.shape[1]
    out = torch.empty((m, d), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mit_int8_mlp_fused(
            x.data_ptr(), ptr(None if ln is None else ln["scale"]),
            ptr(None if ln is None else ln["bias"]), q1.w8.data_ptr(),
            q1.scale.data_ptr(), ptr(q1.bias), q2.w8.data_ptr(),
            q2.scale.data_ptr(), ptr(q2.bias), out.data_ptr(), m, d, f,
            int(x.dtype == torch.bfloat16), _ACT_CODE[act], int(residual),
            int(out_dtype == torch.bfloat16), float(eps), stream(x),
        )
    kernels.check(rc, "mit_int8_mlp_fused")
    int8_mlp_fused.launches += 1
    return out


int8_mlp_fused.launches = 0


def mlp_half(x: torch.Tensor, q1: QuantizedLinear, q2: QuantizedLinear,
             act: str, ln: Optional[dict] = None, eps: float = 0.0,
             residual: bool = False, out_dtype=torch.bfloat16):
    """The MLP half of (M, D) rows on the card, by :func:`mlp_kernel_for`:
    one ``int8_mlp_fused`` launch, or the composition of ``quantize_rows``
    and ``int8_gemm``. Returns (y, route)."""
    route = mlp_kernel_for(x.shape[1], q1.w8.shape[-1], act, x.shape[0])
    if route == "fused":
        return int8_mlp_fused(x, q1, q2, act, ln, eps, residual,
                              out_dtype), route
    return _mlp_half(x, q1, q2, act, ln, eps, residual, out_dtype,
                     quantize_rows, _gemm_any_k), route


def fused_int8_mlp_reference(x: torch.Tensor, q1: QuantizedLinear,
                             q2: QuantizedLinear, act: str = "gelu",
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """quantize → fc1 + bias → act (f32) → quantize → fc2 + bias."""
    return int8_mlp_fused_reference(
        _rows(x), q1, q2, act, out_dtype=out_dtype,
    ).reshape(*x.shape[:-1], -1)


def fused_int8_mlp(x: torch.Tensor, q1: QuantizedLinear, q2: QuantizedLinear,
                   act: str = "gelu", out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 transformer MLP (the TPU ``fused_int8_mlp``): (..., D) →
    (..., D), the hidden in f32 between the two GEMMs; on the card through
    :func:`mlp_half` (``fused_int8_mlp.kernels`` counts the routes)."""
    if x.device.type == "cpu":
        return fused_int8_mlp_reference(x, q1, q2, act, out_dtype)
    require_cuda(x, "fused_int8_mlp")
    _check_float(x, "fused_int8_mlp")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; choose one of {ACTS}")
    out, route = mlp_half(_rows(x), q1, q2, act, out_dtype=out_dtype)
    fused_int8_mlp.kernels[route] += 1
    fused_int8_mlp.launches += 1
    return out.reshape(*x.shape[:-1], -1)


fused_int8_mlp.launches = 0
fused_int8_mlp.kernels = {"fused": 0, "composition": 0}
