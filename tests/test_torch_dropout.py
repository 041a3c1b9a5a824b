"""Port parity: dropout attention and the attention gradients of
mit_tpu_torch against mit_tpu on the CPU.

Inputs come from a numpy seed and cross as numpy arrays. The JAX side runs
its Pallas kernels in interpret mode; the port's wrappers run their plain
PyTorch versions for CPU tensors. Tolerances: the keep-mask is compared bit
for bit; f32 values within 1e-5 (the same f32 operations, summed in
another order); bf16 outputs within 2e-2 absolute (one bf16 rounding of
values up to about 2).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.ops.pallas_attention import flash_attention_btd as jax_flash_btd
from mit_tpu.ops.pallas_dropout_attention import (
    dump_dropout_mask as jax_dump_mask,
    flash_attention_dropout as jax_flash_dropout,
)
from mit_tpu_torch.ops import dropout_attention as tdrop
from mit_tpu_torch.ops.flash_attention import (
    flash_attention_btd,
    flash_attention_btd_reference,
)
from mit_tpu_torch.ops.masks import NEG_INF


def _qkv(b, h, t, s, hd, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, t, hd)).astype(np.float32)
    k = r.normal(size=(b, h, s, hd)).astype(np.float32)
    v = r.uniform(-1, 1, size=(b, h, s, hd)).astype(np.float32)
    pad = np.where(r.random((b, s)) > 0.7, NEG_INF, 0.0).astype(np.float32)
    pad[0] = NEG_INF                         # batch row 0: every key masked
    return q, k, v, pad


def _jax_oracle(q, k, v, pad, mask, causal, rate):
    """XLA attention fed the dumped keep-mask (tests/test_pallas_dropout.py)."""
    t, s = q.shape[2], k.shape[2]
    scores = jnp.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        scores = scores + jnp.where(
            jnp.arange(s)[None, :] <= jnp.arange(t)[:, None], 0.0, NEG_INF)
    p = jax.nn.softmax(scores + pad[:, None, None, :], axis=-1)
    return jnp.einsum("bhts,bhsd->bhtd", jnp.where(mask, p / (1.0 - rate), 0.0),
                      v)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 11, 2**31 - 2])
@pytest.mark.parametrize("shape", [(2, 3, 7, 9), (1, 2, 99, 99)],
                         ids=["ragged", "decoder"])
def test_dump_dropout_mask_equals_jax(shape, seed, rate):
    want = np.asarray(jax_dump_mask(*shape, seed=seed, rate=rate))
    got = tdrop.dump_dropout_mask(*shape, seed, rate)
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_per_cell_and_statistics():
    m = tdrop.dump_dropout_mask(2, 3, 40, 40, 7, 0.25)
    for cell in range(6):
        torch.testing.assert_close(
            tdrop.keep_mask(40, 40, 0.25, 7, cell), m.reshape(6, 40, 40)[cell])
    assert abs(m.float().mean().item() - 0.75) < 0.02
    assert tdrop.dump_dropout_mask(1, 1, 5, 5, 3, 0.0).all()


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5),
                                        (jnp.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s,causal", [(12, 12, True), (7, 9, False)])
def test_forward_matches_jax_kernel(t, s, causal, dtype, atol):
    q, k, v, pad = _qkv(2, 3, t, s, 16)
    seed, rate = 5, 0.25
    want = jax_flash_dropout(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                             jnp.asarray(pad), jnp.int32(seed), causal, rate)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tdrop.flash_attention_dropout(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(pad), seed, causal, rate)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("t,s,causal", [(12, 12, True), (7, 9, False)])
def test_backward_matches_jax_vjp_of_masked_oracle(t, s, causal):
    q, k, v, pad = _qkv(2, 3, t, s, 16, seed=1)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    seed, rate = 13, 0.25
    mask = jax_dump_mask(2, 3, t, s, seed=seed, rate=rate)
    _, vjp = jax.vjp(
        lambda q, k, v: _jax_oracle(q, k, v, jnp.asarray(pad), mask, causal,
                                    rate),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tdrop.flash_attention_dropout(*qkv, torch.from_numpy(pad), seed,
                                        causal, rate)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_plain_and_wrapper_agree_and_count_no_launch():
    """On the CPU the wrapper is the plain version and launches nothing;
    the plain autograd path gives the wrapper's gradients."""
    q, k, v, pad = (torch.from_numpy(x) for x in _qkv(1, 2, 6, 6, 8))
    before = (tdrop.flash_attention_dropout_fwd.launches,
              tdrop.flash_attention_dropout_bwd.launches,
              tdrop.dump_dropout_mask.launches)
    grads = []
    for fn in (tdrop.flash_attention_dropout,
               tdrop.flash_attention_dropout_plain):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*qkv, pad, 3, True, 0.3)
        grads.append(torch.autograd.grad(out.square().sum(), qkv))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tdrop.dump_dropout_mask(1, 2, 6, 6, 3, 0.3)
    assert (tdrop.flash_attention_dropout_fwd.launches,
            tdrop.flash_attention_dropout_bwd.launches,
            tdrop.dump_dropout_mask.launches) == before


@pytest.mark.parametrize("change,error", [
    (dict(hd=257), ValueError),     # past the any-shape kernels' 256
    (dict(s=0), ValueError),
    (dict(t=0), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(pad_len=5), ValueError),
    (dict(contiguous=False), ValueError),
])
def test_dropout_kernel_input_checks(change, error):
    dtype = change.get("dtype", torch.float32)
    hd, t, s = change.get("hd", 64), change.get("t", 9), change.get("s", 9)
    q = torch.zeros(2, 3, t, hd, dtype=dtype)
    k = torch.zeros(2, 3, s, hd, dtype=dtype)
    if change.get("contiguous") is False:
        k = torch.zeros(2, s, 3, hd, dtype=dtype).transpose(1, 2)
    pad = torch.zeros(2, change.get("pad_len", s))
    with pytest.raises(error):
        tdrop._check_cuda_inputs(q, k, torch.zeros_like(k), pad)


def test_dropout_rate_is_checked():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError, match="rate"):
        tdrop.flash_attention_dropout(q, q, q, torch.zeros(1, 2), 0, True, 1.0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_btd_grads_match_jax_vjp(causal):
    r = np.random.default_rng(4)
    b, t, d, hd = 3, 11, 32, 16
    q, k, v = (r.normal(size=(b, t, d)).astype(np.float32) for _ in range(3))
    pad = np.where(r.random((b, t)) > 0.7, NEG_INF, 0.0).astype(np.float32)
    pad[:, 0] = 0.0
    g = r.normal(size=(b, t, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash_btd(q, k, v, jnp.asarray(pad), causal, hd),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_btd(*qkv, torch.from_numpy(pad), causal, hd)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    # the recompute backward is the plain version's own gradient
    ref = flash_attention_btd_reference(*qkv, torch.from_numpy(pad), causal, hd)
    for a, w in zip(got, torch.autograd.grad(ref, qkv, torch.from_numpy(g))):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
