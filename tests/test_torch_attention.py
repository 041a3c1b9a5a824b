"""Port parity: attention ops of mit_tpu_torch against mit_tpu on the CPU.

Inputs come from a numpy seed and go through both frameworks as numpy
arrays. The JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does; the port's wrapper runs its plain PyTorch
version for CPU tensors. All comparisons are in f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mit_tpu.ops import attention as jattn
from mit_tpu.ops.masks import causal_mask as jax_causal_mask
from mit_tpu.ops.pallas_attention import flash_attention_btd as jax_flash_btd
from mit_tpu.ops.positional import sinusoid_table as jax_sinusoid_table
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.ops import attention as tattn
from mit_tpu_torch.ops.flash_attention import (
    flash_attention_btd,
    flash_attention_btd_reference,
)
from mit_tpu_torch.ops.masks import NEG_INF, causal_mask
from mit_tpu_torch.ops.positional import sinusoid_table

B, H, HD = 3, 2, 16
D = H * HD


def _pad(r, s, fully_masked_row=True):
    """Random -1e9 key pads; batch row 0 has every key masked."""
    pad = np.where(r.random((B, s)) > 0.7, NEG_INF, 0.0).astype(np.float32)
    if fully_masked_row:
        pad[0] = NEG_INF
    return pad


@pytest.mark.parametrize("t,s", [(13, 13), (9, 21)])
@pytest.mark.parametrize("has_pad", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_btd_matches_jax_kernel(causal, has_pad, t, s):
    r = np.random.default_rng(0)
    q, k, v = (r.normal(size=(B, n, D)).astype(np.float32) for n in (t, s, s))
    pad = _pad(r, s) if has_pad else np.zeros((B, s), np.float32)
    ref = jax_flash_btd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pad), causal, HD, has_pad)
    out = flash_attention_btd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pad) if has_pad else None, causal, HD,
    )
    out = out.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    if has_pad and not causal:
        # a fully masked row is a uniform average of v, not NaN
        np.testing.assert_allclose(
            out[0], np.broadcast_to(v[0].mean(0), out[0].shape), atol=1e-5
        )


def test_flash_btd_is_forward_only():
    """The kernel is forward-only: with grad the wrapper's backward
    recomputes through the plain version (JAX's ``_bwd_btd``)."""
    q = torch.randn(1, 4, D, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    out = flash_attention_btd(q, q, q, None, False, HD)
    assert out.requires_grad and out.shape == q.shape
    (g,) = torch.autograd.grad(out.sum(), q)
    (want,) = torch.autograd.grad(
        flash_attention_btd_reference(q, q, q, None, False, HD).sum(), q)
    # q feeds q, k and v: their three gradients are summed in another order
    torch.testing.assert_close(g, want, rtol=0, atol=1e-6)
    with torch.no_grad():
        assert not flash_attention_btd(q, q, q, None, False, HD).requires_grad


def _attn_params(r, d=D):
    keys = ("wq", "wk", "wv", "wo")
    p = {w: r.normal(size=(d, d)).astype(np.float32) * 0.2 for w in keys}
    p.update({"b" + w[1]: r.normal(size=(d,)).astype(np.float32) * 0.1
              for w in keys})
    return p


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("causal,has_pad", [(True, True), (False, False)])
def test_multihead_attention_matches_jax(use_kernel, causal, has_pad):
    r = np.random.default_rng(1)
    p = _attn_params(r)
    x = r.normal(size=(B, 11, D)).astype(np.float32)
    pad = _pad(r, 11, fully_masked_row=False) if has_pad else None
    ref = jattn.multihead_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
        jnp.asarray(x), H, use_flash=use_kernel, causal=causal,
        pad_add=None if pad is None else jnp.asarray(pad),
    )
    xt = torch.from_numpy(x)
    out = tattn.multihead_attention(
        params_from_jax(p), xt, xt, H, use_kernel=use_kernel, causal=causal,
        pad_add=None if pad is None else torch.from_numpy(pad),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_multihead_attention_dense_mask_matches_jax():
    """Cross-attention over a padded memory (the plain path's dense mask)."""
    r = np.random.default_rng(2)
    p = _attn_params(r)
    x = r.normal(size=(B, 5, D)).astype(np.float32)
    mem = r.normal(size=(B, 7, D)).astype(np.float32)
    mask = _pad(r, 7, fully_masked_row=False)[:, None, None, :]
    ref = jattn.multihead_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
        jnp.asarray(mem), H, jnp.asarray(mask),
    )
    out = tattn.multihead_attention(
        params_from_jax(p), torch.from_numpy(x), torch.from_numpy(mem), H,
        torch.from_numpy(mask), use_kernel=False,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="dense mask"):
        tattn.multihead_attention(
            params_from_jax(p), torch.from_numpy(x), torch.from_numpy(mem),
            H, torch.from_numpy(mask), use_kernel=True,
        )


def test_single_key_cross_attention_matches_jax():
    r = np.random.default_rng(3)
    p = _attn_params(r)
    mem = r.normal(size=(B, 1, D)).astype(np.float32)
    ref = jattn.single_key_cross_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, 6, jnp.asarray(mem), H
    )
    out = tattn.single_key_cross_attention(
        params_from_jax(p), 6, torch.from_numpy(mem), H
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm_matches_jax(eps):
    r = np.random.default_rng(4)
    x = (r.normal(size=(B, 7, D)) * 3 + 1).astype(np.float32)
    p = {"scale": r.normal(size=(D,)).astype(np.float32),
         "bias": r.normal(size=(D,)).astype(np.float32)}
    ref = jattn.layer_norm({k: jnp.asarray(a) for k, a in p.items()},
                           jnp.asarray(x), eps)
    out = tattn.layer_norm(params_from_jax(p), torch.from_numpy(x), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_positional_and_masks_match_jax():
    np.testing.assert_array_equal(
        sinusoid_table(100, 512).numpy(), np.asarray(jax_sinusoid_table(100, 512))
    )
    np.testing.assert_array_equal(causal_mask(9).numpy(),
                                  np.asarray(jax_causal_mask(9)))
