"""Attention mask utilities (port of ``mit_tpu/ops/masks.py``).

On the hot path masks are structural (a causal flag and a per-key pad
vector) and the attention kernel applies them from indices; these helpers
build the same masks as tensors for the plain paths.
"""

from __future__ import annotations

from typing import Optional

import torch

# Large-negative instead of -inf: a fully masked row stays finite (uniform
# after softmax) instead of turning into NaN.
NEG_INF = -1e9


def causal_mask(t: int, s: Optional[int] = None, device=None) -> torch.Tensor:
    """Additive f32 causal mask (t, s): 0 where col <= row, NEG_INF above."""
    s = t if s is None else s
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).to(torch.float32)


def padding_mask(seq: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """Boolean (B, T) mask, True at PAD positions."""
    return seq == pad_idx


def padding_add(seq: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """Additive f32 (B, T) key mask: NEG_INF at PAD positions, else 0."""
    return torch.where(padding_mask(seq, pad_idx), NEG_INF, 0.0).to(
        torch.float32
    )


def combine_causal_and_padding(sz: int, seq: torch.Tensor, pad_idx: int,
                               dtype=torch.float32) -> torch.Tensor:
    """Additive (B, 1, T, T) mask, causal plus key padding (NEG_INF at the
    keys that are PAD), broadcastable over heads: what torch's
    ``MultiheadAttention`` builds from ``attn_mask`` and
    ``key_padding_mask``."""
    c = causal_mask(sz, device=seq.device).to(dtype)[None, None]
    p = torch.where(padding_mask(seq, pad_idx), NEG_INF, 0.0).to(dtype)
    return c + p[:, None, None, :]
