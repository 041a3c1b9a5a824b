"""``flash_attention_btd`` and ``flash_attention``: the fused attention
kernels, in the native (B, T, D) layout and in (B, H, T, hd).

Port of ``mit_tpu/ops/pallas_attention.py:flash_attention_btd``. Heads are
D-column blocks of ``head_dim``, so the Q/K/V projections feed the kernel
and its output feeds the out-projection with no head split or merge.

- :func:`flash_attention_btd` is the wrapper, differentiable in q, k and
  v. For CPU tensors it runs :func:`flash_attention_btd_reference`; for
  CUDA tensors it launches the hand-written kernel
  ``csrc/flash_attention_btd.cu`` or raises. It adds one to
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
read in place by the same CUDA kernel with a row stride of 3D. It has two
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
(B, T, D) kernel divides by the row sum after P·V. :func:`takes_bhtd` is the
shape rule by which ``multihead_attention`` picks between the two, the JAX
package's rule, so both packages run the same numerics at the same shapes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mit_tpu_torch.ops.masks import causal_mask

KERNEL_HEAD_DIM = 64
LOG2E = 1.4426950408889634


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
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, got {head_dim}"
        )
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
    name = ("mit_flash_attention_btd_bf16" if q.dtype == torch.bfloat16
            else "mit_flash_attention_btd_f32")
    fn = getattr(kernels.lib(), name)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_add is None else pad_add.data_ptr(), out.data_ptr(),
            b, t, k.shape[1], d, int(causal), int(pad_add is not None),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(rc, name)
    flash_attention_btd.launches += 1
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
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, got {head_dim}"
        )
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
    mode = 2 if layer_numerics else int(qkv.dtype == torch.bfloat16)
    with torch.cuda.device(qkv.device):
        rc = kernels.lib().mit_flash_attention_fusedqkv(
            qkv.data_ptr(), out.data_ptr(), b, t, d3 // 3, mode,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    kernels.check(rc, "mit_flash_attention_fusedqkv")
    flash_attention_btd_fusedqkv.launches += 1
    return out


flash_attention_btd_fusedqkv.launches = 0


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
    a model runs the same numerics in both packages, until both kernels are
    measured against each other on the card.
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
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}"
        )
    if tuple(k.shape) != (b, h, s, hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if min(b, h, t, s) == 0 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, S={s}")
    tensors = [q, k, v] + ([] if pad_add is None else [pad_add])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and pad_add must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v and pad_add must be contiguous")
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

    b, h, t, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kernels.lib().mit_flash_attention_bhtd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_add is None else pad_add.data_ptr(), out.data_ptr(),
            b, h, t, k.shape[2], int(causal), int(pad_add is not None),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(rc, "mit_flash_attention_bhtd")
    flash_attention.launches += 1
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
