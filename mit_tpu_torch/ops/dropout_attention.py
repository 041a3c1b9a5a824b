"""Attention with in-kernel dropout (port of
``mit_tpu/ops/pallas_dropout_attention.py``): forward, backward and the mask.

The dropout mask is a stateless hash of (seed, cell, element), so the
backward regenerates exactly the forward's mask and the (B, H, T, S)
probabilities and mask never exist in device memory in either pass:

    p   = softmax(mask(q·kᵀ·scale))               normalized before dropout
    pd  = keep ? p / (1 − r) : 0                  rounded to v's dtype for P·V
    out = pd·v                                    f32 accumulation

    dv = (p·inv)ᵀ·do     with inv = 1/(1 − r), dropped where not kept
    dp = keep ? (do·vᵀ)·inv : 0
    ds = p ∘ (dp − rowsum(dp ∘ p))
    dq = ds·k·scale      dk = dsᵀ·q·scale

- :func:`keep_mask` is the plain hash of ``_keep_mask``, bit for bit: a
  murmur3 finalizer over ``idx = row·S + col``, the seed and the cell
  ``b·H + h``, computed in int64 with every product reduced mod 2³².
- **The cell map.** Under a device mesh a rank holds rows ``b_offset ..``
  of the global batch and heads ``h_offset ..`` of ``h_total``, and its
  local cell ``c`` (``b·H_local + h``) hashes as the global cell
  ``(b_offset + c / H_local)·h_total + h_offset + c % H_local``, so a
  rank's mask is its slice of the single-device mask. Every entry takes
  the map as ``cells=(b_offset, h_total, h_offset)``; None is (0, H, 0),
  the local cell itself. The pad row stays local (``c / H_local``).
- :func:`flash_attention_dropout` is an autograd Function. For CUDA tensors
  it launches the forward kernel of ``csrc/flash_attention_dropout.cu`` (bf16
  on the tensor cores, a cell's whole score rows in registers and a keep bit
  drawn per accumulator element; f32 on the CUDA cores) and, in its
  backward, the backward kernel (bf16 on the tensor cores: pd and ds enter
  the products as f32-exact pairs of bf16 values; f32 on the CUDA cores);
  for CPU tensors it runs the plain versions. It gives no gradient for
  ``pad_add`` and ``seed``.
  :func:`flash_attention_dropout_plain` runs the plain versions on any
  device, for comparison with the kernels on the card.
- :func:`dump_dropout_mask` is the (B, H, T, S) keep-mask as the kernels
  draw it: the dump kernel on a CUDA device, :func:`keep_mask` on the CPU.
- **The seed** is a host int, or, for the kernels alone, a 0-dim int32
  tensor on the inputs' device. The kernels take an int by value and read
  a tensor when they run (its address goes to the C entry, which reads it
  in place of the value), so a CUDA graph that captured the launches
  replays them with whatever seed was staged into that tensor. The plain
  versions take an int only.

``flash_attention_dropout_fwd.launches``, ``flash_attention_dropout_bwd.
launches`` and ``dump_dropout_mask.launches`` count kernel launches;
``flash_attention_dropout_bwd.kernels`` counts them by the kernel that
:func:`dropout_bwd_kernel_for` names.

Those kernels take head_dim 64, T ≤ 128 and S ≤ 128 (the decoder's
self-attention at any ``MAX_SEQ_LEN`` ≤ 129): a cell's whole (T, S) tile
stays on chip. At any other head width up to 256 and at any length the
wrappers launch the any-shape kernels of ``csrc/attention_any_shape.cu``
instead (a warp to a query row or a key; simple and slower; the same hash
mask), so that a CUDA tensor never runs the plain versions:
:func:`dropout_kernel_for` names the kernels a shape gets, and the wrappers
raise where it has none.
"""

from __future__ import annotations

import math

import torch

from mit_tpu_torch.ops.masks import causal_mask

TILED_HEAD_DIM = 64         # the head width the tiled kernels are laid out for
TILED_MAX_LEN = 128         # and the most queries and keys they hold on chip
MAX_HEAD_DIM = 256          # the any-shape kernels: 8 columns a lane
_M32 = 0xFFFFFFFF


def dropout_kernel_supported(head_dim: int, t: int, s: int) -> bool:
    """True where CUDA dropout-attention kernels take heads of ``head_dim``
    columns, ``t`` queries and ``s`` keys."""
    return 1 <= head_dim <= MAX_HEAD_DIM and t > 0 and s > 0


def dropout_kernel_for(head_dim: int, t: int, s: int) -> str:
    """The kernels that run dropout attention at this shape on the card:
    ``"tiled"`` (``csrc/flash_attention_dropout.cu``: head_dim 64 and a
    cell's whole (t, s) probability tile on chip, which bounds both lengths
    at 128) or ``"any_shape"`` (``csrc/attention_any_shape.cu``). Raises
    where there is none; the wrappers' check and their choice of entry
    point ask this one function."""
    if not dropout_kernel_supported(head_dim, t, s):
        raise ValueError(
            f"no CUDA dropout-attention kernel for head_dim {head_dim}, "
            f"T={t}, S={s}: they take head_dim 1 to {MAX_HEAD_DIM} and "
            f"T, S >= 1"
        )
    if head_dim == TILED_HEAD_DIM and max(t, s) <= TILED_MAX_LEN:
        return "tiled"
    return "any_shape"


def dropout_bwd_kernel_for(dtype, head_dim: int, t: int, s: int) -> str:
    """The backward kernel a CUDA call launches at this shape and dtype:
    ``"tensor_cores"`` (bf16 at the tiled shapes, ``dropout_bwd_tc_kernel``),
    ``"cuda_cores"`` (f32 there, ``dropout_bwd_kernel``) or
    ``"any_shape"``. Raises where :func:`dropout_kernel_for` does."""
    if dropout_kernel_for(head_dim, t, s) == "any_shape":
        return "any_shape"
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"


def _threshold(rate: float) -> int:
    """The uint32 keep threshold, as the JAX kernel computes it."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for int64 x in [0, 2³²), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_mask(t: int, s: int, rate: float, seed: int, cell,
              device=None) -> torch.Tensor:
    """Bernoulli(1 − rate) keep-mask (t, s) of one grid cell, or (N, t, s)
    for a 1-D tensor of N cells: ``_keep_mask`` of the JAX kernels."""
    cell = torch.as_tensor(cell, dtype=torch.int64, device=device)
    row = torch.arange(t, dtype=torch.int64, device=cell.device)[:, None]
    col = torch.arange(s, dtype=torch.int64, device=cell.device)[None, :]
    idx = (_mul32(row, s) + col) & _M32
    seed_mix = ((seed & _M32) * 2654435761) & _M32       # a Python int
    cell_mix = _mul32(cell & _M32, 0x9E3779B9)
    x = idx ^ seed_mix ^ cell_mix[..., None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _threshold(rate)


def _cell_map(cells, h: int):
    """(b_offset, h_total, h_offset) of ``cells``; None is the identity."""
    if cells is None:
        return 0, h, 0
    b_offset, h_total, h_offset = (int(x) for x in cells)
    if b_offset < 0 or h_offset < 0 or h_offset + h > h_total:
        raise ValueError(f"cell map {tuple(cells)} does not hold {h} heads")
    return b_offset, h_total, h_offset


def _global_cells(b: int, h: int, cells=None, device=None) -> torch.Tensor:
    """(B·H,) the global cell of each local cell ``b·H + h`` under the map
    ``cells`` = (b_offset, h_total, h_offset)."""
    b_offset, h_total, h_offset = _cell_map(cells, h)
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    heads = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return ((b_offset + rows) * h_total + h_offset + heads).reshape(-1)


def _cells_mask(b, h, t, s, seed, rate, device, cells=None):
    if isinstance(seed, torch.Tensor):
        raise ValueError("a seed tensor is read by the kernels alone; the "
                         "plain versions take an int")
    return keep_mask(t, s, rate, seed, _global_cells(b, h, cells, device),
                     device).reshape(b, h, t, s)


def _probs(q, k, pad_add, causal):
    """f32 softmax of the masked, scaled scores, as ``_scores`` and the
    kernels' exact max, exp and division."""
    t, s = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        scores = scores + causal_mask(t, s, q.device)
    scores = scores + pad_add[:, None, None, :].float()
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def flash_attention_dropout_reference(q, k, v, pad_add, seed: int,
                                      causal: bool, rate: float, cells=None):
    """Plain forward: q (B, H, T, hd), k/v (B, H, S, hd), pad_add (B, S) f32
    → (B, H, T, hd) in q's dtype; the mask at the cell map ``cells``."""
    b, h, t, _ = q.shape
    p = _probs(q, k, pad_add, causal)
    keep = _cells_mask(b, h, t, k.shape[2], seed, rate, q.device, cells)
    # tensor / tensor: an IEEE divide, as the kernel's (PyTorch turns
    # t / c into t * (1/c) on CUDA); torch.full fills on the device, where
    # torch.tensor would copy from the host and wait for the device
    one_minus_r = torch.full((), 1.0 - rate, dtype=torch.float32,
                             device=q.device)
    pd = torch.where(keep, p / one_minus_r, 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", pd.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_dropout_reference_backward(q, k, v, pad_add, do,
                                               seed: int, causal: bool,
                                               rate: float, cells=None):
    """Plain backward, the formulas of ``_bwd_kernel``, all in f32:
    (dq, dk, dv) in the dtypes of q, k and v."""
    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    p = _probs(q, k, pad_add, causal)
    keep = _cells_mask(b, h, t, k.shape[2], seed, rate, q.device, cells)
    inv = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                     device=q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    pd = torch.where(keep, p * inv, 0.0)
    dv = torch.einsum("bhts,bhtd->bhsd", pd, dof)
    dp = torch.where(keep, torch.einsum("bhtd,bhsd->bhts", dof, vf) * inv, 0.0)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# the kernels' wrappers
# ----------------------------------------------------------------------
def _check_cuda_inputs(q, k, v, pad_add, do=None) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    tensors = [("k", k), ("v", v)] + ([] if do is None else [("do", do)])
    for name, x in tensors:
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, H, T, hd) and k, v (B, H, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, t, hd = q.shape
    s = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    dropout_kernel_for(hd, t, s)
    if not (0 < b <= 65535 and 0 < h <= 65535 and b * h <= 2**31 - 1):
        raise ValueError(f"unsupported batch and heads ({b}, {h})")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} differs from q {tuple(q.shape)}")
    if pad_add.dtype != torch.float32 or tuple(pad_add.shape) != (b, s):
        raise ValueError(
            f"pad_add must be float32 ({b}, {s}), got {pad_add.dtype} "
            f"{tuple(pad_add.shape)}"
        )
    every = [q, k, v, pad_add] + ([] if do is None else [do])
    if any(x.device != q.device for x in every):
        raise ValueError("q, k, v, pad_add and do must be on one device")
    if not all(x.is_contiguous() for x in every):
        raise ValueError("q, k, v, pad_add and do must be contiguous")


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def _as_seed(seed):
    """A seed as the wrappers take it: a host int, or a 0-dim int32 tensor
    kept as it is."""
    if not isinstance(seed, torch.Tensor):
        return int(seed)
    if seed.dtype != torch.int32 or seed.dim() != 0:
        raise ValueError(f"a seed tensor must be 0-dim int32, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    return seed


def _launch_seed(seed, device) -> tuple:
    """(value, pointer) of a launch's seed: an int by value and a null
    pointer, or a tensor on ``device`` by its address (value 0)."""
    seed = _as_seed(seed)
    if not isinstance(seed, torch.Tensor):
        return seed & _M32, None
    if seed.device != device:
        raise ValueError(f"the seed is on {seed.device}, the inputs on {device}")
    return 0, seed.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def flash_attention_dropout_fwd(q, k, v, pad_add, seed, causal: bool,
                                rate: float, cells=None) -> torch.Tensor:
    """Forward: the plain version for CPU tensors, a kernel for CUDA.

    At the tiled kernels' shapes bf16 tensors run the tensor-core kernel
    (a warpgroup of 4 warps to 64 query rows) and f32 tensors the CUDA-core
    kernel, which keeps full f32 products; every other shape runs the
    any-shape kernel.
    """
    _check_rate(rate)
    if q.device.type == "cpu":
        return flash_attention_dropout_reference(q, k, v, pad_add, seed,
                                                 causal, rate, cells)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_dropout has no kernel for {q.device}")
    _check_cuda_inputs(q, k, v, pad_add)
    seed, seed_ptr = _launch_seed(seed, q.device)

    from mit_tpu_torch import kernels

    b, h, t, hd = q.shape
    s = k.shape[2]
    cmap = _cell_map(cells, h)
    out = torch.empty_like(q)
    if dropout_kernel_for(hd, t, s) == "any_shape":
        name = "mit_dropout_attention_any_shape_fwd"
        with torch.cuda.device(q.device):
            rc = kernels.lib().mit_dropout_attention_any_shape_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_add.data_ptr(),
                out.data_ptr(), b, h, t, s, hd, int(causal), _bf16(q),
                seed, seed_ptr, _threshold(rate), 1.0 - rate, *cmap,
                _stream(q),
            )
    else:
        name = "mit_flash_attention_dropout_fwd"
        if _bf16(q) and any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("q, k and v must start at 16-byte boundaries")
        with torch.cuda.device(q.device):
            rc = kernels.lib().mit_flash_attention_dropout_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_add.data_ptr(),
                out.data_ptr(), b, h, t, s, int(causal), _bf16(q),
                seed, seed_ptr, _threshold(rate), 1.0 - rate, *cmap,
                _stream(q),
            )
    kernels.check(rc, name)
    flash_attention_dropout_fwd.launches += 1
    return out


flash_attention_dropout_fwd.launches = 0


def flash_attention_dropout_bwd(q, k, v, pad_add, do, seed, causal: bool,
                                rate: float, cells=None):
    """Backward → (dq, dk, dv): the plain formulas for CPU tensors, for
    CUDA the kernel :func:`dropout_bwd_kernel_for` names."""
    _check_rate(rate)
    if q.device.type == "cpu":
        return flash_attention_dropout_reference_backward(
            q, k, v, pad_add, do, seed, causal, rate, cells)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_dropout has no kernel for {q.device}")
    _check_cuda_inputs(q, k, v, pad_add, do)
    seed, seed_ptr = _launch_seed(seed, q.device)

    from mit_tpu_torch import kernels

    b, h, t, hd = q.shape
    s = k.shape[2]
    cmap = _cell_map(cells, h)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    kernel = dropout_bwd_kernel_for(q.dtype, hd, t, s)
    if kernel == "any_shape":
        name = "mit_dropout_attention_any_shape_bwd"
        # each row's max, sum and delta, from the first kernel to the second
        stats = torch.empty((b * h, t, 3), dtype=torch.float32,
                            device=q.device)
        with torch.cuda.device(q.device):
            rc = kernels.lib().mit_dropout_attention_any_shape_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_add.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats.data_ptr(), b, h, t, s, hd, int(causal), _bf16(q),
                seed, seed_ptr, _threshold(rate), 1.0 / (1.0 - rate), *cmap,
                _stream(q),
            )
    else:
        name = "mit_flash_attention_dropout_bwd"
        if kernel == "tensor_cores" and any(x.data_ptr() % 16
                                            for x in (q, k, v, do)):
            raise ValueError("q, k, v and do must start at 16-byte boundaries")
        with torch.cuda.device(q.device):
            rc = kernels.lib().mit_flash_attention_dropout_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_add.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, h, t, s, int(causal), _bf16(q), seed, seed_ptr,
                _threshold(rate), 1.0 / (1.0 - rate), *cmap, _stream(q),
            )
    kernels.check(rc, name)
    flash_attention_dropout_bwd.launches += 1
    flash_attention_dropout_bwd.kernels[kernel] += 1
    return dq, dk, dv


flash_attention_dropout_bwd.launches = 0
flash_attention_dropout_bwd.kernels = {"tensor_cores": 0, "cuda_cores": 0,
                                       "any_shape": 0}


class _DropoutAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_add, seed, causal, rate, use_kernel, cells):
        ctx.save_for_backward(q, k, v, pad_add)
        ctx.args = (seed, causal, rate, use_kernel, cells)
        if use_kernel:
            return flash_attention_dropout_fwd(q, k, v, pad_add, seed, causal,
                                               rate, cells)
        return flash_attention_dropout_reference(q, k, v, pad_add, seed,
                                                 causal, rate, cells)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad_add = ctx.saved_tensors
        seed, causal, rate, use_kernel, cells = ctx.args
        bwd = (flash_attention_dropout_bwd if use_kernel
               else flash_attention_dropout_reference_backward)
        dq, dk, dv = bwd(q, k, v, pad_add, do.contiguous(), seed, causal, rate,
                         cells)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_dropout(q, k, v, pad_add, seed, causal: bool = True,
                            rate: float = 0.1, cells=None) -> torch.Tensor:
    """Fused attention with dropout on the probabilities.

    q (B, H, T, hd); k/v (B, H, S, hd); pad_add (B, S) additive f32; seed
    the dropout stream, a host int or (the kernels) a 0-dim int32 tensor on
    q's CUDA device that the backward reads again, so it must hold the same
    value until then (the same seed gives the same mask, which makes the
    backward exact); ``cells`` the cell map (b_offset, h_total, h_offset) of a mesh
    rank, None on one device. Differentiable in q, k and v.
    """
    return _DropoutAttention.apply(q, k, v, pad_add, _as_seed(seed),
                                   bool(causal), float(rate), True, cells)


def flash_attention_dropout_plain(q, k, v, pad_add, seed,
                                  causal: bool = True, rate: float = 0.1,
                                  cells=None) -> torch.Tensor:
    """:func:`flash_attention_dropout` through the plain forward and
    backward on any device: the kernels' comparison on the card."""
    _check_rate(rate)
    return _DropoutAttention.apply(q, k, v, pad_add, _as_seed(seed),
                                   bool(causal), float(rate), False, cells)


def dump_dropout_mask(b: int, h: int, t: int, s: int, seed, rate: float,
                      device="cpu", cells=None) -> torch.Tensor:
    """(B, H, T, S) bool keep-mask exactly as the kernels draw it at the
    cell map ``cells``: the dump kernel on a CUDA device, :func:`keep_mask`
    on the CPU."""
    _check_rate(rate)
    device = torch.device(device)
    cmap = _cell_map(cells, h)
    seed = _as_seed(seed)
    if device.type == "cpu":
        return _cells_mask(b, h, t, s, seed, rate, device, cells)
    if device.type != "cuda":
        raise ValueError(f"dump_dropout_mask has no kernel for {device}")
    if not (0 < t and 0 < s and 0 < b * h <= 2**31 - 1):
        raise ValueError(f"unsupported mask shape ({b}, {h}, {t}, {s})")

    from mit_tpu_torch import kernels

    out = torch.empty((b, h, t, s), dtype=torch.bool, device=device)
    seed, seed_ptr = _launch_seed(seed, out.device)
    with torch.cuda.device(device):
        rc = kernels.lib().mit_dump_dropout_mask(
            out.data_ptr(), b * h, h, t, s, seed, seed_ptr, _threshold(rate),
            *cmap, torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check(rc, "mit_dump_dropout_mask")
    dump_dropout_mask.launches += 1
    return out


dump_dropout_mask.launches = 0
