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


# ----------------------------------------------------------------------
# flash_attention, the (B, H, T, hd) kernel, and the rule that picks it
# ----------------------------------------------------------------------
def _bhtd(r, t, s, dtype):
    q, k, v = (r.normal(size=(B, H, n, HD)).astype(np.float32)
               for n in (t, s, s))
    return [np.array(jnp.asarray(a, dtype).astype(jnp.float32))
            for a in (q, k, v)]      # values exact in `dtype`


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("t,s", [(13, 13), (9, 21)])
@pytest.mark.parametrize("causal,has_pad", [(True, True), (False, True),
                                            (False, False)])
def test_flash_bhtd_matches_jax_kernel(causal, has_pad, t, s, dtype, tol):
    """The port's flash_attention (its plain version, on the CPU) against
    the JAX package's Pallas kernel in interpret mode and its XLA version."""
    from mit_tpu.ops.pallas_attention import _xla_attention
    from mit_tpu.ops.pallas_attention import flash_attention as jax_flash
    from mit_tpu_torch.ops.flash_attention import flash_attention

    r = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _bhtd(r, t, s, jdt)
    pad = _pad(r, s) if has_pad else np.zeros((B, s), np.float32)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, jnp.asarray(pad), causal)
    xla = _xla_attention(jq, jk, jv, jnp.asarray(pad), causal)
    out = flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(pad) if has_pad else None, causal)
    assert out.dtype == tdt and out.shape == (B, H, t, HD)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    for want in (ref, xla):
        np.testing.assert_allclose(
            got, np.asarray(want.astype(jnp.float32)), rtol=0, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bhtd_gradient_matches_jax(causal):
    """Differentiable in q, k and v: the backward recomputes through the
    plain version, as the JAX package's recomputes through XLA."""
    import jax

    from mit_tpu.ops.pallas_attention import flash_attention as jax_flash
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    r = np.random.default_rng(6)
    q, k, v = _bhtd(r, 7, 11, jnp.float32)
    pad = _pad(r, 11, fully_masked_row=False)
    g = r.normal(size=(B, H, 7, HD)).astype(np.float32)
    ref = jax.grad(
        lambda q, k, v: (jax_flash(q, k, v, jnp.asarray(pad), causal)
                         * jnp.asarray(g)).sum(), argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(pad), causal)
    assert out.requires_grad
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    plain = torch.autograd.grad(
        (flash_attention_reference(tq, tk, tv, torch.from_numpy(pad), causal)
         * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for got, want in zip(grads, plain):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with torch.no_grad():
        assert not flash_attention(tq, tk, tv, None, causal).requires_grad


def test_dispatch_rule_matches_jax_over_the_presets():
    """takes_bhtd names the shapes that the JAX package sends to
    flash_attention: of the presets' encoders and the decoder, in both
    dtypes, only BLIP-384 in f32."""
    import jax

    from mit_tpu.ops.pallas_attention import _btd_fits_vmem
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.ops.flash_attention import takes_bhtd

    shapes = {name: (cfg.seq_len, cfg.seq_len, cfg.hidden_size)
              for name, cfg in PRESETS.items()}
    shapes["decoder"] = (100, 100, 512)
    shapes["decoder over full BLIP memory"] = (100, 577, 512)
    taken = set()
    for name, (t, s, d) in shapes.items():
        for dtype, size in ((jnp.float32, 4), (jnp.bfloat16, 2)):
            q = jax.ShapeDtypeStruct((2, t, d), dtype)
            k = jax.ShapeDtypeStruct((2, s, d), dtype)
            assert takes_bhtd(t, s, d, size) == (not _btd_fits_vmem(q, k, 64)), \
                (name, dtype)
            if takes_bhtd(t, s, d, size):
                taken.add((name, size))
    assert taken == {("Salesforce/blip-image-captioning-base", 4)}
    # the boundary itself: a cell of exactly 8 MiB stays on flash_attention_btd
    assert not takes_bhtd(512, 512, 768, 4) or (
        4 * 512 * 768 * 4 + 512 * 512 * 4 <= 8 * 1024 * 1024)
    assert takes_bhtd(577, 577, 768, 4) and not takes_bhtd(577, 577, 768, 2)


def test_blip384_f32_encoder_takes_flash_attention_and_matches_jax(monkeypatch):
    """The BLIP-384 encoder at full width (577 tokens, D 768) and reduced
    depth, f32: the port sends its self-attention to flash_attention, and
    its output equals the JAX package's with the Pallas kernels on."""
    import jax

    from mit_tpu.models import vision as jvis
    from mit_tpu_torch.models import vision as tvis

    name = "Salesforce/blip-image-captioning-base"
    tcfg = tvis.PRESETS[name]._replace(num_layers=2)
    jcfg = jvis.VisionConfig(**tcfg._asdict())
    params = jax.tree.map(
        np.asarray, jvis.init_vision_params(jax.random.PRNGKey(0), jcfg))
    px = np.random.default_rng(0).normal(size=(1, 3, 384, 384)).astype(
        np.float32)
    calls = {"bhtd": 0, "btd": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tattn, "flash_attention",
                        counted("bhtd", tattn.flash_attention))
    monkeypatch.setattr(tattn, "flash_attention_btd",
                        counted("btd", tattn.flash_attention_btd))
    ref = jvis.vision_forward(params, jcfg, jnp.asarray(px), use_pallas=True)
    out = tvis.vision_forward(params_from_jax(params), tcfg,
                              torch.from_numpy(px))
    assert calls == {"bhtd": 2, "btd": 0}
    assert out.shape == ref.shape == (1, 577, 768)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    tvis.vision_forward(params_from_jax(params), tcfg, torch.from_numpy(px),
                        compute_dtype=torch.bfloat16)
    assert calls == {"bhtd": 2, "btd": 2}         # bf16 stays on the BTD kernel
