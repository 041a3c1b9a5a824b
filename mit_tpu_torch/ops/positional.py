"""Sinusoidal positional table (port of ``mit_tpu/ops/positional.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def sinusoid_table(max_len: int, d_model: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(max_len, d_model) table; even dims sin, odd dims cos.

    Computed in float64 with numpy, as the JAX package does, then cast.
    Cached per arguments: the copy to a device would otherwise wait for the
    device at every forward. Callers must not write to the table.
    """
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: d_model // 2])
    return torch.from_numpy(pe.astype(np.float32)).to(device=device, dtype=dtype)


def add_positional(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) plus the first T rows of ``table``, in x's dtype."""
    return x + table[None, :x.shape[1]].to(x.dtype)
