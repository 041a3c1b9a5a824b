"""``flash_attention_btd`` and ``flash_attention``: the fused attention
kernels, in the native (B, T, D) layout and in (B, H, T, hd).

Port of ``mit_tpu/ops/pallas_attention.py:flash_attention_btd``. Heads are
D-column blocks of ``head_dim``, so the Q/K/V projections feed the kernel
and its output feeds the out-projection with no head split or merge.

- :func:`flash_attention_btd` is the wrapper, differentiable in q, k and
  v. For CPU tensors it runs :func:`flash_attention_btd_reference`; for
  CUDA tensors it launches a hand-written kernel of
  ``csrc/flash_attention_btd.cu`` or raises: bf16 on the tensor cores
  (wgmma), at the tiling :func:`bf16_tiling` gives, f32 on the CUDA cores
  in full f32 products, one walk over the keys with 8 × 8 register tiles
  (:func:`btd_entry`). It adds one to
  ``flash_attention_btd.launches`` at each kernel launch. The kernel is
  forward-only: the backward recomputes the attention through
  :func:`flash_attention_btd_reference` under autograd, as the JAX
  package's ``_bwd_btd`` recomputes through XLA (``pallas_attention.py:
  372-379``), so training at dropout 0 and eval run the kernel forward.
- :func:`flash_attention_btd_reference` is the plain PyTorch version, the
  twin of ``_xla_attention_btd`` / ``_xla_attention``: it normalizes the
  probabilities before P·V, where the kernel divides by the row sum after
  P·V (as the Pallas kernel does), so the two agree to rounding.

:func:`flash_attention_btd_fusedqkv` (port of the TPU kernel of the same
name) takes one fused (B, T, 3D) qkv tensor, as the int8 encoder's fused
QKV projection writes it: q, k and v are column offsets 0, D and 2D of it,
read in place by the same CUDA kernels with a row stride of 3D. It has two
output modes:

- the TPU ``flash_attention_btd_fusedqkv``: bidirectional, unpadded,
  ``exp(s·scale − m)``, p rounded to qkv's dtype for P·V, division by the
  row sum, output in qkv's dtype;
- ``layer_numerics=True``, the attention stage of the TPU
  ``fused_int8_vit_layer`` (``pallas_int8_layer.py:95-125``): bf16 qkv,
  f32 scores, ``exp2(s·scale2 − m)`` with ``scale2 = log2(e)/√hd``, p
  rounded to bf16 for P·V, multiplication by ``1/rowsum`` after P·V, and
  an f32 context.

The fused-QKV wrapper is forward-only (the encoder is frozen) and raises on
an input that requires grad.

:func:`flash_attention` (port of ``pallas_attention.py:flash_attention``)
takes q (B, H, T, hd) and k, v (B, H, S, hd). It is a second entry of the
same CUDA source, and its numerics are not ``flash_attention_btd``'s: the
probabilities are normalized before P·V and rounded to v's dtype, where the
(B, T, D) kernel divides by the row sum after P·V. In bf16 the tensor-core
kernel therefore walks the key tiles twice (the row max and sum, then
``exp(s − max)/sum`` rounded to bf16 and multiplied); in f32 nothing is
rounded in between, and the f32 kernel's one walk serves both layouts.
:func:`takes_bhtd` is the shape rule by which ``multihead_attention`` picks
between the two, the JAX package's rule, so both packages run the same
numerics at the same shapes.

Those kernels take heads of 64 columns and of 72 to 128 in multiples of 8
(ViT-H/14's 80 among them; templates on the width padded to 16, two
64-column panels a tile past 64). At any other head width up to 256 every
entry, the fused layer's numerics included, launches the any-shape kernel
of ``csrc/attention_any_shape.cu`` instead (a warp to a query row; simple
and slower), so that a CUDA tensor never runs the plain version:
:func:`attention_kernel_for` names the kernel a head width gets, and the
wrappers raise where it has none. Each of the three wrappers counts its
launches by kernel in ``.kernels`` (``"tiled"``, ``"any_shape"``) beside
``.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mit_tpu_torch.ops.masks import causal_mask

TILED_HEAD_DIM = 64         # the head width the tiled kernels are laid out for
WIDE_HEAD_DIM = 128         # and past it, multiples of 8 up to this
MAX_HEAD_DIM = 256          # the any-shape kernel: 8 columns a lane
LOG2E = 1.4426950408889634
# warps a block of the bf16 (tensor-core) kernel: one warpgroup or two, and a
# warpgroup owns 64 query rows
BF16_WARPS = (4, 8)
BF16_GROUP_ROWS = 64


def attention_kernel_supported(head_dim: int) -> bool:
    """True where a CUDA attention kernel takes heads of ``head_dim``
    columns. Lengths and batch are free."""
    return 1 <= head_dim <= MAX_HEAD_DIM


def attention_kernel_for(head_dim: int, layer_numerics: bool = False) -> str:
    """The kernel that runs attention over heads of ``head_dim`` columns on
    the card: ``"tiled"`` (``csrc/flash_attention_btd.cu``: 64, and 72 to
    128 in multiples of 8, each 16-byte aligned and padded to a multiple of
    16 inside) or ``"any_shape"`` (``csrc/attention_any_shape.cu``), in
    every numerics mode, the fused int8 layer's (``layer_numerics``)
    included. Raises where there is no kernel; every wrapper's check and its
    choice of entry point ask this one function."""
    del layer_numerics          # both kernels have every mode
    if head_dim == TILED_HEAD_DIM or (
            TILED_HEAD_DIM < head_dim <= WIDE_HEAD_DIM and head_dim % 8 == 0):
        return "tiled"
    if not attention_kernel_supported(head_dim):
        raise ValueError(
            f"no CUDA attention kernel for head_dim {head_dim}: the tiled "
            f"kernels take {TILED_HEAD_DIM} and multiples of 8 up to "
            f"{WIDE_HEAD_DIM}, the any-shape kernel 1 to {MAX_HEAD_DIM}"
        )
    return "any_shape"


def _count(wrapper, kernel: str) -> None:
    """One launch of ``kernel`` ("tiled" or "any_shape") by ``wrapper``."""
    wrapper.launches += 1
    wrapper.kernels[kernel] += 1


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels load 16 bytes at a time."""
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("q, k, v and qkv must start at 16-byte boundaries")


# the any-shape kernel's numerics: divide by the row sum after P.V, normalize
# before it, or the fused int8 layer's (bf16 in, f32 out)
ANY_DIVIDE_AFTER, ANY_NORM_FIRST, ANY_LAYER = 0, 1, 2


def _any_shape(q, k, v, pad_add, out, b, h, t, s, hd, ldq, ldkv, ldo, bhtd,
               causal, mode, bf16) -> None:
    """Launch the any-shape kernel: q, k and v are tensors or, for the column
    blocks of a fused qkv tensor, data pointers; bf16 or f32 (``bf16``), the
    output of their dtype except in ``ANY_LAYER`` (f32)."""
    from mit_tpu_torch import kernels

    ptr = lambda x: x if isinstance(x, int) else x.data_ptr()
    with torch.cuda.device(out.device):
        rc = kernels.lib().mit_attention_any_shape(
            ptr(q), ptr(k), ptr(v),
            None if pad_add is None else pad_add.data_ptr(), out.data_ptr(),
            b, h, t, s, hd, ldq, ldkv, ldo, int(bhtd), int(causal),
            int(pad_add is not None), mode, int(bf16),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    kernels.check(rc, "mit_attention_any_shape")


def bf16_tiling(t: int, warps: Optional[int] = None) -> tuple[int, int]:
    """``(warps, rows)`` for the bf16 kernel at ``t`` query rows: the warps
    of a block and the query rows a block owns, 64 a warpgroup of 4 warps.

    The 64-row groups of ``t`` are split evenly over the fewest blocks that
    hold them (320 rows on 8 warps: 128 + 128 + 64). Left to the rule, a
    block has one warpgroup up to 64 rows and two above: at the ViT-B
    encoder's 197 rows two read a head's K and V half as often and took
    0.059 ms against 0.069 (an H100 at 700 W).
    """
    if t < 1:
        raise ValueError(f"need at least one query row, got {t}")
    groups = -(-t // BF16_GROUP_ROWS)
    if warps is None:
        warps = BF16_WARPS[0] if groups == 1 else BF16_WARPS[1]
    elif warps not in BF16_WARPS:
        raise ValueError(f"warps must be one of {BF16_WARPS}, got {warps}")
    blocks = -(-groups // (warps // 4))
    return warps, BF16_GROUP_ROWS * -(-groups // blocks)


def btd_entry(dtype: torch.dtype) -> str:
    """The C entry point that runs ``flash_attention_btd`` in ``dtype``:
    the tensor-core kernel for bf16, the CUDA-core kernel for f32."""
    if dtype == torch.bfloat16:
        return "mit_flash_attention_btd_bf16"
    if dtype == torch.float32:
        return "mit_flash_attention_btd_f32"
    raise TypeError(f"q must be float32 or bfloat16, got {dtype}")


def flash_attention_btd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_add: Optional[torch.Tensor] = None,
    causal: bool = False,
    head_dim: int = 64,
) -> torch.Tensor:
    """Plain PyTorch attention: q (B, T, D), k/v (B, S, D) → (B, T, D).

    f32 scores, additive causal mask and (B, S) pad, f32 softmax, then the
    probabilities cast to q's dtype for P·V; output in q's dtype.
    """
    b, t, d = q.shape
    s = k.shape[1]
    h = d // head_dim
    split = lambda x: x.reshape(b, -1, h, head_dim).transpose(1, 2)
    scores = torch.einsum(
        "bhtd,bhsd->bhts", split(q).float(), split(k).float()
    ) / math.sqrt(head_dim)
    if causal:
        scores = scores + causal_mask(t, s, q.device)
    if pad_add is not None:
        scores = scores + pad_add[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhts,bhsd->bhtd", probs.to(q.dtype), split(v))
    return ctx.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def _check_cuda_inputs(q, k, v, pad_add, head_dim) -> None:
    tiled = attention_kernel_for(head_dim) == "tiled"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, T, D) and k, v (B, S, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, d = q.shape
    s = k.shape[1]
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d % head_dim or t == 0 or s == 0 or b == 0 or b > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, S={s}")
    tensors = [q, k, v] + ([] if pad_add is None else [pad_add])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and pad_add must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v and pad_add must be contiguous")
    if tiled:
        _check_aligned(q, k, v)
    if pad_add is not None and (
        pad_add.dtype != torch.float32 or tuple(pad_add.shape) != (b, s)
    ):
        raise ValueError(
            f"pad_add must be float32 ({b}, {s}), got {pad_add.dtype} "
            f"{tuple(pad_add.shape)}"
        )


def _flash_forward_btd(q, k, v, pad_add, causal, head_dim):
    """The forward: the plain version for CPU tensors, the kernel for CUDA."""
    if q.device.type == "cpu":
        return flash_attention_btd_reference(q, k, v, pad_add, causal, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_btd has no kernel for {q.device}")
    _check_cuda_inputs(q, k, v, pad_add, head_dim)

    from mit_tpu_torch import kernels

    b, t, d = q.shape
    out = torch.empty_like(q)
    if attention_kernel_for(head_dim) == "any_shape":
        _any_shape(q, k, v, pad_add, out, b, d // head_dim, t, k.shape[1],
                   head_dim, d, d, d, False, causal, ANY_DIVIDE_AFTER,
                   q.dtype == torch.bfloat16)
        _count(flash_attention_btd, "any_shape")
        return out
    name = btd_entry(q.dtype)
    fn = getattr(kernels.lib(), name)
    tiling = bf16_tiling(t) if q.dtype == torch.bfloat16 else ()
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_add is None else pad_add.data_ptr(), out.data_ptr(),
            b, t, k.shape[1], d, head_dim, int(causal),
            int(pad_add is not None), *tiling,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(rc, name)
    _count(flash_attention_btd, "tiled")
    return out


class _FlashAttentionBTD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_add, causal, head_dim):
        ctx.save_for_backward(q, k, v, pad_add)
        ctx.args = (causal, head_dim)
        return _flash_forward_btd(q, k, v, pad_add, causal, head_dim)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pad_add = ctx.saved_tensors
        causal, head_dim = ctx.args
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            out = flash_attention_btd_reference(*qkv, pad_add, causal, head_dim)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention_btd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_add: Optional[torch.Tensor] = None,
    causal: bool = False,
    head_dim: int = 64,
) -> torch.Tensor:
    """Fused attention: q (B, T, D); k/v (B, S, D); pad_add (B, S) or None.

    ``pad_add=None`` means no key is padding (the encoder's case) and skips
    the pad add, as ``has_pad=False`` does in the JAX kernel. The gradient
    in q, k and v recomputes through the plain version.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttentionBTD.apply(q, k, v, pad_add, causal, head_dim)
    return _flash_forward_btd(q, k, v, pad_add, causal, head_dim)


flash_attention_btd.launches = 0
flash_attention_btd.kernels = {"tiled": 0, "any_shape": 0}


# ----------------------------------------------------------------------
# fused (B, T, 3D) qkv
# ----------------------------------------------------------------------
def flash_attention_btd_fusedqkv_reference(
    qkv: torch.Tensor, head_dim: int = 64, layer_numerics: bool = False,
) -> torch.Tensor:
    """Plain PyTorch attention over fused qkv (B, T, 3D) → (B, T, D).

    Without ``layer_numerics`` it is :func:`flash_attention_btd_reference`
    on the three column blocks. With it, the fused layer's numerics in f32
    (see the module docstring).
    """
    b, t, d3 = qkv.shape
    d = d3 // 3
    q, k, v = qkv.split(d, dim=-1)
    if not layer_numerics:
        return flash_attention_btd_reference(q, k, v, None, False, head_dim)
    h = d // head_dim
    split = lambda x: x.reshape(b, t, h, head_dim).transpose(1, 2).float()
    scores = torch.einsum("bhtd,bhsd->bhts", split(q), split(k))
    scores = scores * (LOG2E / math.sqrt(head_dim))
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    o = torch.einsum("bhts,bhsd->bhtd", p.to(torch.bfloat16).float(), split(v))
    o = o * (1.0 / p.sum(-1, keepdim=True))
    return o.transpose(1, 2).reshape(b, t, d)


def _check_fusedqkv(qkv: torch.Tensor, head_dim: int,
                    layer_numerics: bool) -> None:
    tiled = attention_kernel_for(head_dim, layer_numerics) == "tiled"
    allowed = ((torch.bfloat16,) if layer_numerics
               else (torch.float32, torch.bfloat16))
    if qkv.dtype not in allowed:
        raise TypeError(f"qkv must be one of {allowed}, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * head_dim):
        raise ValueError(
            f"qkv must be (B, T, 3D) with D a multiple of {head_dim}, got "
            f"{tuple(qkv.shape)}"
        )
    b, t, _ = qkv.shape
    if b == 0 or t == 0 or b > 65535:
        raise ValueError(f"unsupported shape qkv {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if tiled:
        _check_aligned(qkv)


def flash_attention_btd_fusedqkv(
    qkv: torch.Tensor, head_dim: int = 64, layer_numerics: bool = False,
) -> torch.Tensor:
    """Bidirectional, unpadded attention over fused qkv (B, T, 3D) →
    context (B, T, D): in qkv's dtype, or f32 with ``layer_numerics``."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError(
            "flash_attention_btd_fusedqkv is forward-only; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if qkv.device.type == "cpu":
        return flash_attention_btd_fusedqkv_reference(qkv, head_dim,
                                                      layer_numerics)
    if qkv.device.type != "cuda":
        raise ValueError(
            f"flash_attention_btd_fusedqkv has no kernel for {qkv.device}"
        )
    _check_fusedqkv(qkv, head_dim, layer_numerics)

    from mit_tpu_torch import kernels

    b, t, d3 = qkv.shape
    out_dtype = torch.float32 if layer_numerics else qkv.dtype
    out = torch.empty((b, t, d3 // 3), dtype=out_dtype, device=qkv.device)
    if attention_kernel_for(head_dim, layer_numerics) == "any_shape":
        d = d3 // 3
        at = lambda i: qkv.data_ptr() + i * d * qkv.element_size()
        _any_shape(at(0), at(1), at(2), None, out, b, d // head_dim, t, t,
                   head_dim, d3, d3, d, False, False,
                   ANY_LAYER if layer_numerics else ANY_DIVIDE_AFTER,
                   qkv.dtype == torch.bfloat16)
        _count(flash_attention_btd_fusedqkv, "any_shape")
        return out
    mode = 2 if layer_numerics else int(qkv.dtype == torch.bfloat16)
    with torch.cuda.device(qkv.device):
        rc = kernels.lib().mit_flash_attention_fusedqkv(
            qkv.data_ptr(), out.data_ptr(), b, t, d3 // 3, head_dim, mode,
            *bf16_tiling(t),         # read by the bf16 modes only
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    kernels.check(rc, "mit_flash_attention_fusedqkv")
    _count(flash_attention_btd_fusedqkv, "tiled")
    return out


flash_attention_btd_fusedqkv.launches = 0
flash_attention_btd_fusedqkv.kernels = {"tiled": 0, "any_shape": 0}


# ----------------------------------------------------------------------
# (B, H, T, hd) layout
# ----------------------------------------------------------------------
BTD_CELL_BYTES = 8 * 1024 * 1024


def takes_bhtd(t: int, s: int, d: int, itemsize: int) -> bool:
    """True where a self- or cross-attention of q (B, t, d) over k (B, s, d)
    goes to :func:`flash_attention` and not :func:`flash_attention_btd`.

    The JAX package's rule (``_btd_fits_vmem``): one batch cell's q, k, v
    and output tiles plus an f32 score block above 8 MiB. Its reason, the
    TPU's fast memory, does not hold on this card; the rule is kept so that
    a model runs the same numerics in both packages. ``PERF.md`` has both
    kernels' times at the BLIP-384 shape, the one supported shape the rule
    sends to :func:`flash_attention`: equal in f32, the (B, T, D) kernel
    ahead in bf16 (one walk against two).
    """
    return (2 * t * d + 2 * s * d) * itemsize + t * s * 4 > BTD_CELL_BYTES


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_add: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Plain PyTorch attention: q (B, H, T, hd), k/v (B, H, S, hd) →
    (B, H, T, hd) in q's dtype. f32 scores and softmax, the probabilities
    cast to q's dtype, f32 accumulation of P·V (``_xla_attention``)."""
    t, s = q.shape[2], k.shape[2]
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    if causal:
        scores = scores + causal_mask(t, s, q.device)
    if pad_add is not None:
        scores = scores + pad_add[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs.float(), v.float()).to(q.dtype)


def _check_bhtd(q, k, v, pad_add) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k is {k.dtype}, v is {v.dtype}, q is {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, H, T, hd) and k, v (B, H, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, t, hd = q.shape
    s = k.shape[2]
    tiled = attention_kernel_for(hd) == "tiled"
    if tuple(k.shape) != (b, h, s, hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if min(b, h, t, s) == 0 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, S={s}")
    tensors = [q, k, v] + ([] if pad_add is None else [pad_add])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and pad_add must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v and pad_add must be contiguous")
    if tiled:
        _check_aligned(q, k, v)
    if pad_add is not None and (
        pad_add.dtype != torch.float32 or tuple(pad_add.shape) != (b, s)
    ):
        raise ValueError(
            f"pad_add must be float32 ({b}, {s}), got {pad_add.dtype} "
            f"{tuple(pad_add.shape)}"
        )


def _flash_forward(q, k, v, pad_add, causal):
    """The forward: the plain version for CPU tensors, the kernel for CUDA."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, pad_add, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    _check_bhtd(q, k, v, pad_add)

    from mit_tpu_torch import kernels

    b, h, t, hd = q.shape
    out = torch.empty_like(q)
    if attention_kernel_for(hd) == "any_shape":
        _any_shape(q, k, v, pad_add, out, b, h, t, k.shape[2], hd, hd, hd, hd,
                   True, causal, ANY_NORM_FIRST, q.dtype == torch.bfloat16)
        _count(flash_attention, "any_shape")
        return out
    with torch.cuda.device(q.device):
        rc = kernels.lib().mit_flash_attention_bhtd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_add is None else pad_add.data_ptr(), out.data_ptr(),
            b, h, t, k.shape[2], hd, int(causal), int(pad_add is not None),
            int(q.dtype == torch.bfloat16),
            *bf16_tiling(t),         # read by the bf16 kernel only
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(rc, "mit_flash_attention_bhtd")
    _count(flash_attention, "tiled")
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_add, causal):
        ctx.save_for_backward(q, k, v, pad_add)
        ctx.causal = causal
        return _flash_forward(q, k, v, pad_add, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pad_add = ctx.saved_tensors
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            out = flash_attention_reference(*qkv, pad_add, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_add: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Fused attention: q (B, H, T, hd); k/v (B, H, S, hd); pad_add (B, S)
    additive f32 or None (no key is padding). ``causal=True`` for decoder
    self-attention, False for the encoder's. The gradient in q, k and v
    recomputes through the plain version, as the JAX package's recomputes
    through XLA."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, pad_add, causal)
    return _flash_forward(q, k, v, pad_add, causal)


flash_attention.launches = 0
flash_attention.kernels = {"tiled": 0, "any_shape": 0}
