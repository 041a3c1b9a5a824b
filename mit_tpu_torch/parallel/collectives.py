"""The collectives that the mesh's training step writes out.

- :func:`copy_to_model` and :func:`reduce_from_model` are Megatron's two
  operators around a tensor-parallel sublayer: the first is the identity
  forward and sums the gradient over "model" backward, where a replicated
  activation enters column-parallel products; the second sums the partial
  outputs of a row-parallel product over "model" forward and passes the
  gradient through.
- :class:`Shard` says where a rank's activations sit in the global step,
  and draws its slice of a global dropout mask.
- :func:`all_reduce_sum` sums a tensor over a group in place;
  :func:`all_gather_cat` concatenates the group's pieces. Under ``gloo``
  the gather goes through host copies (gloo sums and broadcasts CUDA
  tensors; its gather is not relied on).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Shard(NamedTuple):
    """Where one rank's activations sit in the step of the whole mesh: rows
    ``b0 ..`` of a global batch of ``batch`` rows, and piece ``m_index`` of
    ``m`` of the heads and FFN columns, summed over ``group`` (None when
    ``m`` is 1)."""

    batch: int
    b0: int
    m: int = 1
    m_index: int = 0
    group: Optional[object] = None

    def keep(self, shape, rate: float, generator: torch.Generator, device,
             split_dim: Optional[int] = None) -> torch.Tensor:
        """This rank's slice of the Bernoulli(1 − rate) keep-mask of the
        global tensor: drawn at the global shape (rows ``batch``, and
        ``split_dim`` ``m`` times wider), so every rank draws what one
        device draws and keeps its rows and columns."""
        full = list(shape)
        full[0] = self.batch
        if split_dim is not None:
            full[split_dim] *= self.m
        keep = torch.rand(full, generator=generator, device=device) < 1.0 - rate
        keep = keep.narrow(0, self.b0, shape[0])
        if split_dim is not None:
            n = shape[split_dim]
            keep = keep.narrow(split_dim, self.m_index * n, n)
        return keep


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The pieces of ``group``'s ranks, in rank order, concatenated along
    ``dim``; on ``x``'s device."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    pieces = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(pieces, src, group=group)
    return torch.cat(pieces, dim).to(x.device)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # bf16 partials add in f32: the same sum under gloo and nccl
        return all_reduce_sum(x.to(torch.float32, copy=True), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward (in f32, then x's dtype); the
    gradient as it is backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)
