"""One whole pre-LN ViT encoder layer in W8A8 (port of
``mit_tpu/ops/pallas_int8_layer.py``).

The TPU kernel ``fused_int8_vit_layer`` keeps a layer's 7.1 MB of int8
weights resident in VMEM and runs the layer for one image in one kernel.
An SM's 227 KB of shared memory cannot hold that, so on Hopper the layer
is six (or nine) launches of the port's four CUDA kernels, with the same
numerics:

1. LayerNorm 1 (f32) + row quantize        ``quantize_rows``
2. QKV GEMM → bf16 (even at f32 compute)   ``int8_gemm``
3. attention → f32 context                 ``flash_attention_btd_fusedqkv``
   (``layer_numerics=True``)
4. row quantize of the f32 context         ``quantize_rows``
5. out-projection GEMM + residual, f32     ``int8_gemm``
6. the MLP half: LayerNorm 2 + quantize →  ``int8_mlp_fused``
   fc1 + GELU/quick_gelu → quantize → fc2
   + residual → x's dtype

Step 6 is one launch whose hidden stays in a thread block cluster's shared
memory (``csrc/int8_mlp_fused.cu``) where ``int8_mlp.mlp_kernel_for`` picks
it (the supported presets' (D, F), up to the rows at which it beat the
composition on the card: a few images); elsewhere, a batch of 64 images
among them, it is the composition ``quantize_rows`` → ``int8_gemm`` →
``quantize_rows`` → ``int8_gemm`` (nine launches a layer), with the same
numbers. ``<wrapper>.kernels`` counts the layers by the route of their MLP
half.

The residual stream stays f32 inside the layer; the layer's input and
output are in x's dtype.

``fused_int8_vit_layer_split`` is the TPU's two-pass form for geometries
whose layer exceeds VMEM (ViT-L). Its only numeric difference is that the
residual stream between the halves is stored in x's dtype; on Hopper it is
the same launch sequence with step 5 writing x's dtype.
"""

from __future__ import annotations

import torch

from mit_tpu_torch.ops.flash_attention import (
    flash_attention_btd_fusedqkv,
    flash_attention_btd_fusedqkv_reference,
)
from mit_tpu_torch.ops.int8_mlp import (
    ACTS,
    int8_gemm,
    int8_gemm_reference,
    _mlp_half,
    mlp_half,
    quantize_rows,
    quantize_rows_reference,
)
from mit_tpu_torch.ops.quant import QuantizedLinear


def _layer(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, split,
           quant, gemm, attn, mlp=None):
    """Steps 1-5, then ``mlp(x1, fc1, fc2, act, ln2, eps, residual=True,
    out_dtype=x.dtype)`` for the MLP half (by default the composition of
    ``quant`` and ``gemm``)."""
    if mlp is None:
        mlp = lambda *args, **kw: _mlp_half(*args, **kw, quant=quant,
                                            gemm=gemm)
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    h8, sh = quant(xf, ln1, eps)
    qkv_ = gemm(h8, sh, qkv, out_dtype=torch.bfloat16)
    ctx = attn(qkv_.view(b, t, 3 * d), d // num_heads, layer_numerics=True)
    c8, sc = quant(ctx.view(b * t, d))
    x1 = gemm(c8, sc, out, residual=xf,
              out_dtype=x.dtype if split else torch.float32)
    y = mlp(x1, fc1, fc2, act, ln2, eps, residual=True, out_dtype=x.dtype)
    return y.view(b, t, d)


def _reference(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, split):
    return _layer(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, split,
                  quantize_rows_reference, int8_gemm_reference,
                  flash_attention_btd_fusedqkv_reference)


def _kernels(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, split,
             routes):
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the fused int8 layer is forward-only")
    if x.device.type != "cuda":
        raise ValueError(f"the fused int8 layer has no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % num_heads:
        raise ValueError(f"x must be (B, T, D) with D divisible by "
                         f"num_heads={num_heads}, got {tuple(x.shape)}")
    if act not in ACTS[1:]:
        raise ValueError(f"act must be 'gelu' or 'quick_gelu', got {act!r}")

    def mlp(*args, **kw):
        y, route = mlp_half(*args, **kw)
        routes[route] += 1
        return y

    return _layer(x.contiguous(), ln1, qkv, out, ln2, fc1, fc2, num_heads,
                  eps, act, split, quantize_rows, int8_gemm,
                  flash_attention_btd_fusedqkv, mlp)


def fused_int8_vit_layer_reference(
    x: torch.Tensor, ln1: dict, qkv: QuantizedLinear, out: QuantizedLinear,
    ln2: dict, fc1: QuantizedLinear, fc2: QuantizedLinear, num_heads: int,
    eps: float, act: str = "gelu",
) -> torch.Tensor:
    """The layer in plain PyTorch, with the kernels' numerics."""
    return _reference(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act,
                      False)


def fused_int8_vit_layer(
    x: torch.Tensor,                   # (B, T, D)
    ln1: dict,                         # {"scale": (D,), "bias": (D,)} f32
    qkv: QuantizedLinear,              # (D, 3D)
    out: QuantizedLinear,              # (D, D)
    ln2: dict,
    fc1: QuantizedLinear,              # (D, F)
    fc2: QuantizedLinear,              # (F, D)
    num_heads: int,
    eps: float,
    act: str = "gelu",
) -> torch.Tensor:
    """One pre-LN encoder layer in W8A8 → (B, T, D) in x's dtype."""
    if x.device.type == "cpu":
        return fused_int8_vit_layer_reference(x, ln1, qkv, out, ln2, fc1, fc2,
                                              num_heads, eps, act)
    y = _kernels(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, False,
                 fused_int8_vit_layer.kernels)
    fused_int8_vit_layer.launches += 1
    return y


fused_int8_vit_layer.launches = 0
fused_int8_vit_layer.kernels = {"fused": 0, "composition": 0}


def fused_int8_vit_layer_split_reference(
    x: torch.Tensor, ln1: dict, qkv: QuantizedLinear, out: QuantizedLinear,
    ln2: dict, fc1: QuantizedLinear, fc2: QuantizedLinear, num_heads: int,
    eps: float, act: str = "gelu",
) -> torch.Tensor:
    """The two-pass layer in plain PyTorch."""
    return _reference(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act,
                      True)


def fused_int8_vit_layer_split(
    x: torch.Tensor, ln1: dict, qkv: QuantizedLinear, out: QuantizedLinear,
    ln2: dict, fc1: QuantizedLinear, fc2: QuantizedLinear, num_heads: int,
    eps: float, act: str = "gelu",
) -> torch.Tensor:
    """The TPU's two-pass (ViT-L) form: the residual stream between the
    attention and MLP halves is stored in x's dtype."""
    if x.device.type == "cpu":
        return fused_int8_vit_layer_split_reference(
            x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act)
    y = _kernels(x, ln1, qkv, out, ln2, fc1, fc2, num_heads, eps, act, True,
                 fused_int8_vit_layer_split.kernels)
    fused_int8_vit_layer_split.launches += 1
    return y


fused_int8_vit_layer_split.launches = 0
fused_int8_vit_layer_split.kernels = {"fused": 0, "composition": 0}
