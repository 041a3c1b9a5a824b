"""The float encoder's elementwise passes between its products, as two
hand-written kernels (``csrc/encoder_fused.cu``):

- :func:`add_layer_norm`, at each sublayer boundary of a pre-LN layer:
  ``y = x + (a + bias)`` and ``h = LayerNorm(y)``, where ``x`` is the
  residual stream and ``a`` the sublayer's product (the out-projection's
  or fc2's, before its bias). Without ``x`` it is the LayerNorm of the
  embeddings (``ln_pre``, layer 0's ``ln1``); without ``ln`` only ``y``
  (the last boundary of a tower with no ``ln_post``).
- :func:`bias_act`, after fc1: ``act(a + bias)``, GELU (erf) or
  quick_gelu.

The biases and the LayerNorm's scale and shift are read in f32 straight
from the parameter tree. The XLA fusions of the JAX package's float
encoder (``mit_tpu/models/vision.py``) are what they replace; no Pallas
kernel does this work.

Each wrapper takes its plain PyTorch version (``*_reference``: the
composition of PyTorch ops the encoder ran before the kernels, rounding as
it does) for CPU tensors only; a CUDA tensor launches the kernel or
raises. On the card ``y`` and ``bias_act``'s output are bitwise the plain
version's, and ``h`` within one rounding of the compute dtype (the
LayerNorm's sums run in another order; where the scale's and the shift's
terms cancel near 0, f32's noise of about 1e-7 of them shows). Both count
their launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mit_tpu_torch.ops.attention import layer_norm
from mit_tpu_torch.kernels import ptr, require_cuda, stream

ACTS = ("gelu", "quick_gelu")
# csrc/encoder_fused.cu's codes: the activations as ops/int8_mlp.py numbers
# them, the dtypes
_ACT_CODE = {"gelu": 1, "quick_gelu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# values in one 16-byte load
_VEC = {torch.float32: 4, torch.bfloat16: 8}
# a warp holds a row in registers: at most 16 16-byte chunks a lane
LN_MAX_D = 2048


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# ----------------------------------------------------------------------
# add_layer_norm
# ----------------------------------------------------------------------
def add_layer_norm_reference(x: Optional[torch.Tensor], a: torch.Tensor,
                             bias: Optional[torch.Tensor],
                             ln: Optional[dict], eps: float):
    """``(y, h)``: ``y = x + (a + bias)`` in a's dtype (the bias cast to it;
    without ``x`` and ``bias``, ``a`` itself) and ``h = layer_norm(ln, y,
    eps)``, or None without ``ln``."""
    y = a if bias is None else a + bias.to(a.dtype)
    if x is not None:
        y = x + y
    return y, None if ln is None else layer_norm(ln, y, eps)


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """The (M, D) view of ``t`` with unit column stride and 16-byte aligned
    rows, as the kernel reads them."""
    try:
        rows = t.view(-1, t.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"{name} must view as (rows, D) without a copy: "
                         f"{e}") from None
    size = rows.element_size()
    if (rows.stride(-1) != 1 or rows.data_ptr() % 16
            or (rows.shape[0] > 1 and rows.stride(0) * size % 16)):
        raise ValueError(f"{name}'s rows must be contiguous and 16-byte "
                         f"aligned, got strides {tuple(t.stride())}")
    return rows


def _check_param(p: torch.Tensor, n: int, device, name: str) -> None:
    if (p.dtype != torch.float32 or tuple(p.shape) != (n,)
            or not p.is_contiguous() or p.device != device
            or p.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous float32 ({n},) on "
                         f"{device}, 16-byte aligned, got {p.dtype} "
                         f"{tuple(p.shape)} on {p.device}")


def _check_add_layer_norm(x, a, bias, ln) -> None:
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    d, vec = a.shape[-1], _VEC[a.dtype]
    if a.numel() == 0 or not 0 < d <= LN_MAX_D or d % vec:
        raise ValueError(f"a must have rows of D <= {LN_MAX_D}, a multiple "
                         f"of {vec}, got {tuple(a.shape)}")
    if x is not None and (x.dtype != a.dtype or x.shape != a.shape
                          or x.device != a.device):
        raise ValueError(f"x must be {a.dtype} {tuple(a.shape)} on "
                         f"{a.device} like a, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if x is None and bias is None and ln is None:
        raise ValueError("add_layer_norm with no residual, no bias and no "
                         "LayerNorm computes nothing")
    if bias is not None:
        _check_param(bias, d, a.device, "bias")
    if ln is not None:
        for key in ("scale", "bias"):
            _check_param(ln[key], d, a.device, f"ln[{key!r}]")


def add_layer_norm(x: Optional[torch.Tensor], a: torch.Tensor,
                   bias: Optional[torch.Tensor], ln: Optional[dict],
                   eps: float):
    """One sublayer boundary: ``(y, h)`` of :func:`add_layer_norm_reference`
    in one pass over the rows.

    ``a`` (..., D) and ``x`` (its shape, or None) f32 or bf16, each a view
    of rows with unit column stride (``x`` may be the CLS rows of a wider
    tensor); ``bias`` (D,) f32 or None; ``ln`` ({"scale", "bias"} f32
    (D,)) or None. ``y`` and ``h`` are new contiguous tensors of a's shape
    (``y`` is ``a`` itself where there is neither ``x`` nor ``bias``)."""
    if a.device.type == "cpu":
        return add_layer_norm_reference(x, a, bias, ln, eps)
    require_cuda(a, "add_layer_norm")
    _check_add_layer_norm(x, a, bias, ln)

    from mit_tpu_torch import kernels

    a2 = _rows(a, "a")
    x2 = None if x is None else _rows(x, "x")
    m, d = a2.shape
    adds = x is not None or bias is not None
    y = torch.empty(a.shape, dtype=a.dtype, device=a.device) if adds else a
    h = (None if ln is None
         else torch.empty(a.shape, dtype=a.dtype, device=a.device))
    with torch.cuda.device(a.device):
        rc = kernels.lib().mit_add_layer_norm(
            ptr(x2), a2.data_ptr(), ptr(bias),
            ptr(None if ln is None else ln["scale"]),
            ptr(None if ln is None else ln["bias"]),
            y.data_ptr() if adds else None, ptr(h), m, d,
            0 if x2 is None else x2.stride(0), a2.stride(0),
            _DTYPE_CODE[a.dtype], float(eps), stream(a),
        )
    kernels.check(rc, "mit_add_layer_norm")
    add_layer_norm.launches += 1
    return y, h


add_layer_norm.launches = 0


# ----------------------------------------------------------------------
# bias_act
# ----------------------------------------------------------------------
def bias_act_reference(a: torch.Tensor, bias: torch.Tensor,
                       act: str) -> torch.Tensor:
    """``act(a + bias)`` in a's dtype, the bias cast to it."""
    h = a + bias.to(a.dtype)
    if act == "quick_gelu":
        return _quick_gelu(h)
    if act != "gelu":
        raise ValueError(f"unknown act {act!r}; choose one of {ACTS}")
    return F.gelu(h)


def _check_bias_act(a, bias, act) -> None:
    if act not in _ACT_CODE:
        raise ValueError(f"unknown act {act!r}; choose one of {ACTS}")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    f, vec = a.shape[-1], _VEC[a.dtype]
    if a.numel() == 0 or f % vec or a.numel() // vec >= 2**32:
        raise ValueError(f"a must have rows of F, a multiple of {vec}, and "
                         f"fewer than 2**32 16-byte vectors, got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("a must be contiguous and 16-byte aligned")
    _check_param(bias, f, a.device, "bias")


def bias_act(a: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """``act(a + bias)`` (:func:`bias_act_reference`) in one pass: ``a``
    (..., F) contiguous f32 or bf16, ``bias`` (F,) f32, ``act`` "gelu"
    (erf) or "quick_gelu" → a new tensor of a's shape."""
    if a.device.type == "cpu":
        return bias_act_reference(a, bias, act)
    require_cuda(a, "bias_act")
    _check_bias_act(a, bias, act)

    from mit_tpu_torch import kernels

    out = torch.empty_like(a)
    f = a.shape[-1]
    with torch.cuda.device(a.device):
        rc = kernels.lib().mit_bias_act(
            a.data_ptr(), bias.data_ptr(), out.data_ptr(), a.numel() // f, f,
            _ACT_CODE[act], _DTYPE_CODE[a.dtype], stream(a),
        )
    kernels.check(rc, "mit_bias_act")
    bias_act.launches += 1
    return out


bias_act.launches = 0
