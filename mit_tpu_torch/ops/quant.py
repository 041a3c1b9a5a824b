"""int8 (W8A8) quantization of the frozen vision encoder's GEMMs (port of
``mit_tpu/ops/quant.py``).

Scheme, as in the JAX package:
- weights: per-output-channel symmetric int8, ``scale = max|w| / 127``,
  quantized once at load time;
- activations: per-row dynamic symmetric int8 at run time;
- accumulation: exact int32, rescaled by the outer product of the row and
  channel scales, then the f32 bias.

Layout. ``QuantizedLinear.w8`` has the JAX package's logical shape
(..., K, N), but the port stores it column-major: K is contiguous for each
output channel, which is what the int8 GEMM kernel's ``wgmma`` B operand
reads (8-bit operands of ``wgmma`` are K-major only). :func:`quantize_weight` and ``models.convert.params_from_jax`` make
that layout once; :func:`kernel_layout` does it for any int8 tensor.

:func:`int8_matmul` is the plain composition, exact in its accumulators: it
multiplies the int8 codes in float64, where every partial sum of
``127² · K`` stays an integer well below 2⁵³, on the CPU and on the card
alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class QuantizedLinear(NamedTuple):
    """int8 weight + per-output-channel scale (+ optional f32 bias).

    ``w8``: (..., K, N) int8, stored K-contiguous (:func:`kernel_layout`);
    ``scale``: (..., N) f32 with ``w ≈ w8 * scale``; ``bias``: (..., N) f32
    or None. Leading dims stack layers.
    """

    w8: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "QuantizedLinear":
        """Layer ``i`` of a layer-stacked weight (views)."""
        return QuantizedLinear(*(None if a is None else a[i] for a in self))


def _divide(t: torch.Tensor, c: float, divisor: bool) -> torch.Tensor:
    """``t / c`` (``divisor``) or ``c / t``, as IEEE divides. PyTorch
    computes ``c / t`` as ``reciprocal(t) * c``, and on CUDA ``t / c`` as
    ``t * (1 / c)``: either can differ from the divide in the last ulp."""
    full = torch.full_like(t, c)
    return t / full if divisor else full / t


def kernel_layout(w8: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values stored with K contiguous per column."""
    return w8.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor, bias: Optional[torch.Tensor] = None
                    ) -> QuantizedLinear:
    """Per-output-channel symmetric int8 quantization of (..., K, N).

    Two divides, as in the JAX package: ``scale = max(amax, 1e-8) / 127``
    and ``w / scale``; rounding is half to even.
    """
    wf = w.float()
    amax = wf.abs().amax(dim=-2)                          # (..., N)
    scale = _divide(torch.clamp(amax, min=1e-8), 127.0, divisor=True)
    w8 = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QuantizedLinear(
        kernel_layout(w8.to(torch.int8)), scale,
        None if bias is None else bias.float(),
    )


def dynamic_quantize(x: torch.Tensor):
    """Per-row symmetric int8: x (..., K) → (x8 int8, sx (..., 1) f32).

    ``x * (127 / amax)``: one divide per row, as the kernels do, so the
    plain and kernel paths quantize bit-identically.
    """
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    inv = _divide(amax, 127.0, divisor=False)
    x8 = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return x8, amax * (1.0 / 127.0)


def int8_accumulate(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 x8 (..., T, K) · w8 (..., K, N), via float64 products."""
    return torch.matmul(x8.double(), w8.double()).to(torch.int32)


def int8_matmul(x: torch.Tensor, q: QuantizedLinear,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., T, K) @ dequant(q) → (..., T, N) in ``out_dtype``.

    Weight leading dims beyond (K, N) are layer-stack dims matching x's.
    """
    x8, sx = dynamic_quantize(x)
    acc = int8_accumulate(x8, q.w8)
    out = acc.float() * (sx * q.scale[..., None, :])
    if q.bias is not None:
        out = out + q.bias[..., None, :]
    return out.to(out_dtype)
