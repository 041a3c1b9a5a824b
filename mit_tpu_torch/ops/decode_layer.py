"""``fused_decode_layer``: one decoder layer of one decode step in one
kernel (port of ``mit_tpu/ops/pallas_decode_layer.py``, CLS memory mode).

One KV-cached decode step of one post-LN decoder layer is about 20 small
PyTorch ops (QKV product, two cache writes, two attention einsums, softmax,
out-projection, the constant cross-attention add, two MLP products, three
LayerNorms); at one token per row the host issuing them, not the device,
bounds the step. The kernel does the whole layer in one launch:

    QKV product → (emit the fresh K/V rows) → attention over the cache
    → out-projection → LN1 → + cross constant → LN2 → MLP → LN3

- :func:`fused_decode_layer` is the wrapper. For CPU tensors it runs
  :func:`fused_decode_layer_plain`; for CUDA tensors it launches the
  hand-written kernel ``csrc/decode_layer.cu`` or raises. It adds one to
  ``fused_decode_layer.launches`` at each kernel launch.
- :func:`fused_decode_layer_plain` is the plain PyTorch version. It follows
  the kernel's rounding points, which are the Pallas kernel's and not those
  of ``decode.step.decoder_step``: the fresh K/V rows serve this step's
  ``t == pos`` term unrounded (f32), the probabilities are not rounded to
  the compute dtype before P·V, the context is divided by the row sum after
  the sum, and the residual stream stays f32 from ``x`` to the output.
- :func:`pack_decode_layers` slices the stacked layer parameters of
  ``prepare_decode_params`` once per generation into per-layer operands
  (f32 biases) and their device pointers, so a step does no casts and no
  slicing. ``fused_decode_layer`` takes either form.

``pos`` is a per-row (B,) int32 tensor or an int (broadcast), so the same
kernel serves the batch decode loops and per-slot positions. Masking is one
additive (B, T) f32 input (0 or ``NEG_INF``) prepared by the caller.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

KERNEL_EMBED_DIM = 512
KERNEL_NUM_HEADS = 8

# the order of the kernel's 14 weight operands
_OPERANDS = ("wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "ln2s", "ln2b",
             "ln3s", "ln3b", "w1", "b1", "w2", "b2")
_MATRICES = ("wqkv", "wo", "w1", "w2")


class PackedDecodeLayers(NamedTuple):
    """Per-layer operands of the fused kernel, made and checked once per
    generation by :func:`pack_decode_layers` (the only way to make one: the
    kernel trusts ``ptrs``)."""

    layers: Tuple[dict, ...]           # L × {operand name: tensor}
    ptrs: Tuple[Tuple[int, ...], ...]  # L × the 14 data pointers, in order
    dtype: torch.dtype                 # the compute dtype (of the matrices)
    device: torch.device
    embed_dim: int
    ff_dim: int


def pack_decode_layers(lay: dict) -> PackedDecodeLayers:
    """``prepare_decode_params(...)["layers"]`` (stacked on a leading layer
    axis) → per-layer operands: the four matrices in their compute dtype,
    the biases and LayerNorm parameters in f32, all contiguous, with their
    shapes checked."""
    num_layers, d, d3 = lay["wqkv"].shape
    f = lay["w1"].shape[-1]
    cd, device = lay["wqkv"].dtype, lay["wqkv"].device
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d), "bo": (d,),
              "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
    shapes.update({f"ln{i}{c}": (d,) for i in (1, 2, 3) for c in "sb"})
    layers = []
    for l in range(num_layers):
        ops = {name: lay[name][l] for name in _MATRICES}
        for name in ("bqkv", "bo", "b1", "b2"):
            ops[name] = lay[name][l].float()
        for i in (1, 2, 3):
            ops[f"ln{i}s"] = lay[f"ln{i}"]["scale"][l].float()
            ops[f"ln{i}b"] = lay[f"ln{i}"]["bias"][l].float()
        ops = {k: v.contiguous() for k, v in ops.items()}
        for name in _OPERANDS:
            a = ops[name]
            want = cd if name in _MATRICES else torch.float32
            if tuple(a.shape) != shapes[name] or a.dtype != want:
                raise ValueError(
                    f"layer {l} operand {name} must be {want} {shapes[name]}, "
                    f"got {a.dtype} {tuple(a.shape)}"
                )
            if a.device != device or a.data_ptr() % 16:
                raise ValueError(
                    f"layer {l} operand {name} must be 16-byte aligned and "
                    f"on {device}"
                )
        layers.append(ops)
    ptrs = tuple(tuple(ops[name].data_ptr() for name in _OPERANDS)
                 for ops in layers)
    return PackedDecodeLayers(tuple(layers), ptrs, cd, device, d, f)


def _ln(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-dim or (B,) tensor) → (B,) int32 on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    # a fill kernel, not a copy from host memory, which would wait
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def fused_decode_layer_plain(
    x: torch.Tensor,                   # (B, D) residual stream, compute dtype
    pos: Union[int, torch.Tensor],     # int or (B,) positions
    madd: torch.Tensor,                # (B, T) f32 additive key mask
    k_cache: torch.Tensor,             # (B, T, D) this layer's K cache
    v_cache: torch.Tensor,             # (B, T, D)
    cross_const: torch.Tensor,         # (B, D) cross-attention constant
    lay: Union[dict, PackedDecodeLayers],
    l: int,
    num_heads: int,
    eps: float = 1e-5,
    write_cache: bool = False,
):
    """Plain PyTorch version → (x', k_new (B, D), v_new (B, D)), with the
    kernel's rounding points (see the module docstring)."""
    if not isinstance(lay, PackedDecodeLayers):
        lay = pack_decode_layers(lay)
    w = lay.layers[l]
    cd = x.dtype
    b, t, d = k_cache.shape
    h, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    posv = positions(pos, b, x.device)

    def product(a, name, bias):
        # compute-dtype operands, f32 accumulation (upcasting is exact)
        return a.to(cd).float() @ w[name].float() + w[bias]

    xf = x.float()
    q, k_new, v_new = product(x, "wqkv", "bqkv").split(d, dim=-1)
    heads = lambda a: a.reshape(b, h, hd)
    kc = k_cache.float().reshape(b, t, h, hd)
    vc = v_cache.float().reshape(b, t, h, hd)
    at_pos = (torch.arange(t, device=x.device)[None, :]
              == posv[:, None])[:, None, :]                        # (B, 1, T)
    s = torch.einsum("bhe,bthe->bht", heads(q), kc) * scale
    s_pos = (heads(q) * heads(k_new)).sum(-1, keepdim=True) * scale
    s = torch.where(at_pos, s_pos, s) + madd.to(f32)[:, None, :]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bht,bthe->bhe", torch.where(at_pos, 0.0, p), vc)
    p_pos = torch.where(at_pos, p, 0.0).sum(-1, keepdim=True)
    ctx = ((ctx + p_pos * heads(v_new)) / denom).reshape(b, d)

    x1 = _ln(xf + product(ctx, "wo", "bo"), w["ln1s"], w["ln1b"], eps)
    x2 = _ln(x1 + cross_const.to(f32), w["ln2s"], w["ln2b"], eps)
    mid = torch.relu(product(x2, "w1", "b1"))
    x3 = _ln(x2 + product(mid, "w2", "b2"), w["ln3s"], w["ln3b"], eps)
    k_new, v_new = k_new.to(cd), v_new.to(cd)
    if write_cache:
        _write_rows(k_cache, v_cache, posv, k_new, v_new)
    return x3.to(cd), k_new, v_new


def _write_rows(k_cache, v_cache, posv, k_new, v_new) -> None:
    """cache[b, pos[b]] = fresh row, for every pos inside the cache."""
    t = k_cache.shape[1]
    inside = (posv >= 0) & (posv < t)
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = posv.long().clamp(0, t - 1)
    k_cache[rows, idx] = torch.where(inside[:, None], k_new, k_cache[rows, idx])
    v_cache[rows, idx] = torch.where(inside[:, None], v_new, v_cache[rows, idx])


def _check_cuda_inputs(x, posv, madd, k_cache, v_cache, cross, lay,
                       num_heads) -> None:
    if lay.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {lay.dtype}")
    if k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"need k_cache and v_cache (B, T, D), got {tuple(k_cache.shape)} "
            f"and {tuple(v_cache.shape)}"
        )
    b, t, d = k_cache.shape
    if (d != KERNEL_EMBED_DIM or lay.embed_dim != d
            or num_heads != KERNEL_NUM_HEADS or lay.ff_dim % 8):
        raise ValueError(
            f"the CUDA kernel takes width {KERNEL_EMBED_DIM}, "
            f"{KERNEL_NUM_HEADS} heads and F a multiple of 8; got cache "
            f"width {d}, weights {lay.embed_dim} x {lay.ff_dim}, "
            f"{num_heads} heads"
        )
    if b == 0 or t == 0:
        raise ValueError(f"empty cache {tuple(k_cache.shape)}")
    for name, a in (("x", x), ("k_cache", k_cache), ("v_cache", v_cache)):
        if a.dtype != lay.dtype:
            raise TypeError(f"{name} is {a.dtype}, the weights {lay.dtype}")
    for name, a, shape in (("x", x, (b, d)), ("madd", madd, (b, t)),
                           ("cross_const", cross, (b, d)), ("pos", posv, (b,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if madd.dtype != torch.float32 or cross.dtype != torch.float32:
        raise TypeError("madd and cross_const must be float32 here")
    tensors = (x, posv, madd, k_cache, v_cache, cross)
    if lay.device != x.device or any(a.device != x.device for a in tensors):
        raise ValueError("every operand must be on x's device")
    if not all(a.is_contiguous() and a.data_ptr() % 16 == 0 for a in tensors):
        raise ValueError("every operand must be contiguous and 16-byte aligned")


def fused_decode_layer(
    x: torch.Tensor,                   # (B, D) residual stream, compute dtype
    pos: Union[int, torch.Tensor],     # int or (B,) int32 position(s)
    madd: torch.Tensor,                # (B, T) f32 additive key mask
    k_cache: torch.Tensor,             # (B, T, D) this layer's K cache
    v_cache: torch.Tensor,             # (B, T, D)
    cross_const: torch.Tensor,         # (B, D) cross-attention constant
    lay: Union[dict, PackedDecodeLayers],
    l: int,                            # layer index
    num_heads: int,
    eps: float = 1e-5,
    write_cache: bool = False,
    *,
    rows_per_block: Optional[int] = None,
    stagger: bool = True,
):
    """→ (x', k_new (B, D), v_new (B, D)).

    The caller scatters the fresh rows into the caches, or sets
    ``write_cache`` and the rows are also written in place at ``pos`` (a
    position outside the cache matches no column and writes nothing).
    ``lay`` is ``prepare_decode_params(...)["layers"]`` or, to keep the
    casts and slicing out of the step, :func:`pack_decode_layers` of it.

    ``rows_per_block`` (1, 2 or 4; None lets the kernel pick by B) and
    ``stagger`` are the kernel's two design choices, exposed so that a
    measurement can hold the defaults against the alternatives; they change
    f32 summation order only. CPU tensors ignore them.
    """
    if rows_per_block not in (None, 1, 2, 4):
        raise ValueError(f"rows_per_block must be 1, 2 or 4, got {rows_per_block}")
    if x.device.type == "cpu":
        return fused_decode_layer_plain(x, pos, madd, k_cache, v_cache,
                                        cross_const, lay, l, num_heads, eps,
                                        write_cache)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_layer has no kernel for {x.device}")
    if not isinstance(lay, PackedDecodeLayers):
        lay = pack_decode_layers(lay)
    b, t, d = k_cache.shape
    posv = positions(pos, b, x.device).contiguous()
    madd = madd.float()
    cross = cross_const.float()
    _check_cuda_inputs(x, posv, madd, k_cache, v_cache, cross, lay, num_heads)

    from mit_tpu_torch import kernels

    xo, k_new, v_new = (torch.empty_like(x) for _ in range(3))
    flags = int(lay.dtype == torch.bfloat16) | (int(write_cache) << 1)
    flags |= (int(not stagger) << 2) | ((rows_per_block or 0) << 4)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mit_fused_decode_layer(
            x.data_ptr(), posv.data_ptr(), madd.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), cross.data_ptr(),
            *lay.ptrs[l],
            xo.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            b, t, d, num_heads, lay.ff_dim, flags, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "mit_fused_decode_layer")
    fused_decode_layer.launches += 1
    return xo, k_new, v_new


fused_decode_layer.launches = 0
