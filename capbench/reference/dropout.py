"""The training step's dropout streams, frozen here for the reference.

The program draws its dropout from a pair of generators that are a pure
function of (seed, step): a device generator for the Bernoulli masks and
a host generator for the int32 seed of each hash-mask attention call.
The hash mask is a murmur3 finalizer over the element index, the seed and
the (row, head) cell. The reference repeats both so that it drops out the
same elements; these are plain copies of that protocol, kept with the
yardstick so that a change to the program cannot move them.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_generators(seed: int, step: int, device):
    """(device generator, host generator) of training step ``step``."""
    base = splitmix64(splitmix64(seed & _M64) ^ (step & _M64))
    dev = torch.Generator(device=device)
    dev.manual_seed(splitmix64(base ^ 1) >> 1)
    host = torch.Generator()
    host.manual_seed(splitmix64(base ^ 2) >> 1)
    return dev, host


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep(b: int, h: int, t: int, s: int, rate: float, seed: int,
              device) -> torch.Tensor:
    """(B, H, T, S) bool keep-mask of the hash-mask attention dropout."""
    cell = torch.arange(b * h, dtype=torch.int64, device=device)
    row = torch.arange(t, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(s, dtype=torch.int64, device=device)[None, :]
    idx = (_mul32(row, s) + col) & _M32
    seed_mix = ((seed & _M32) * 2654435761) & _M32
    x = idx ^ seed_mix ^ _mul32(cell & _M32, 0x9E3779B9)[:, None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    threshold = min(int(rate * (1 << 32)), (1 << 32) - 1)
    return (x >= threshold).reshape(b, h, t, s)
