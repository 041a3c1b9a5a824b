"""The CUDA kernel of mit_tpu_torch against its plain PyTorch version.

Torch only (no JAX), so the card's tests run without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` need an NVIDIA GPU and skip without one; they build
the kernels from ``mit_tpu_torch/csrc`` on first use. The rest check, on
the CPU, what surrounds the kernel: input validation, the launch counter
and the build's failure path.
"""

import numpy as np
import pytest
import torch

from mit_tpu_torch import kernels
from mit_tpu_torch.ops.flash_attention import (
    _check_cuda_inputs,
    flash_attention_btd,
    flash_attention_btd_reference,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, s, d, padded, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    q, k = to(r.normal(size=(b, t, d))), to(r.normal(size=(b, s, d)))
    v = to(r.uniform(-1, 1, size=(b, s, d)))
    pad = None
    if padded:
        p = np.where(r.random((b, s)) > 0.7, -1e9, 0.0).astype(np.float32)
        p[0] = -1e9                      # batch row 0: every key masked
        pad = torch.from_numpy(p).to(device)
    return q, k, v, pad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,s,d,causal,padded", [
    (4, 197, 197, 768, False, False),    # encoder
    (4, 100, 100, 512, True, True),      # decoder self-attention
    (2, 577, 577, 768, False, False),    # BLIP-384: K/V exceed shared memory
    (3, 13, 70, 128, True, True),        # ragged tiles, T != S
    (2, 1, 1, 64, False, True),
    (2, 33, 65, 64, False, True),
])
def test_kernel_matches_plain_on_card(cuda, dtype, b, t, s, d, causal, padded):
    q, k, v, pad = _inputs(b, t, s, d, padded, dtype, cuda)
    before = flash_attention_btd.launches
    out = flash_attention_btd(q, k, v, pad, causal, 64)
    ref = flash_attention_btd_reference(q, k, v, pad, causal, 64)
    torch.cuda.synchronize()
    assert flash_attention_btd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert not torch.isnan(out).any()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, pad = _inputs(2, 8, 8, 128, True, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_btd(q, k, v, pad, False, 32)
    with pytest.raises(TypeError):
        flash_attention_btd(q.half(), k.half(), v.half(), pad, False, 64)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_btd(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, v, pad, False, 64)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_btd(q.requires_grad_(), k, v, pad, False, 64)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, pad = _inputs(2, 9, 9, 64, True, torch.float32, "cpu")
    before = flash_attention_btd.launches
    out = flash_attention_btd(q, k, v, pad, True, 64)
    assert flash_attention_btd.launches == before
    torch.testing.assert_close(
        out, flash_attention_btd_reference(q, k, v, pad, True, 64)
    )


@pytest.mark.parametrize("change,error", [
    (dict(head_dim=32), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(k_len=7), ValueError),
    (dict(pad_len=5), ValueError),
    (dict(d=96), ValueError),
])
def test_kernel_input_checks(change, error):
    d = change.get("d", 128)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(2, 9, d, dtype=dtype)
    k = torch.zeros(2, 9, d, dtype=dtype)
    v = torch.zeros(2, change.get("k_len", 9), d, dtype=dtype)
    pad = torch.zeros(2, change.get("pad_len", 9))
    with pytest.raises(error):
        _check_cuda_inputs(q, k, v, pad, change.get("head_dim", 64))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler failure is an error with its output."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert not list(tmp_path.iterdir())
