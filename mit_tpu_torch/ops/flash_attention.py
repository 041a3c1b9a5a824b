"""``flash_attention_btd``: attention in the native (B, T, D) layout.

Port of ``mit_tpu/ops/pallas_attention.py:flash_attention_btd``. Heads are
D-column blocks of ``head_dim``, so the Q/K/V projections feed the kernel
and its output feeds the out-projection with no head split or merge.

- :func:`flash_attention_btd` is the wrapper. For CPU tensors it runs
  :func:`flash_attention_btd_reference`; for CUDA tensors it launches the
  hand-written kernel ``csrc/flash_attention_btd.cu`` or raises. It adds one
  to ``flash_attention_btd.launches`` at each kernel launch.
- :func:`flash_attention_btd_reference` is the plain PyTorch version, the
  twin of ``_xla_attention_btd`` / ``_xla_attention``: it normalizes the
  probabilities before P·V, where the kernel divides by the row sum after
  P·V (as the Pallas kernel does), so the two agree to rounding.

Forward only: the TPU backward recomputes through plain ops and training is
not ported yet, so the wrapper raises on inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mit_tpu_torch.ops.masks import causal_mask

KERNEL_HEAD_DIM = 64


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
    the pad add, as ``has_pad=False`` does in the JAX kernel.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention_btd is forward-only; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )
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


flash_attention_btd.launches = 0
