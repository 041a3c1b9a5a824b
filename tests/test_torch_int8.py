"""Port parity: the int8 (W8A8) encoder arm of mit_tpu_torch against
mit_tpu on the CPU.

Inputs and float weights come from a numpy seed; one set of int8 weights
(the JAX package's ``quantize_vision_params``) drives both packages through
``params_from_jax``. The JAX side runs its Pallas kernels in interpret
mode; the port's wrappers run their plain PyTorch versions for CPU tensors.

Tolerances, and why:
- the quantizers and the int32 accumulators are exact, so they are compared
  bitwise;
- where both sides compute the same f32 function from the same int8 codes
  they differ only by f32 summation order (about 1e-7 relative); the bound
  1e-3 (relative L2) also admits a rare int8 code flipped by such an ulp
  (one code moves a row by one quantization step), while a change of form
  (LayerNorm rounded to the compute dtype, f32 against bf16 qkv) moves
  these outputs by 4e-3 to 2e-2;
- bf16 outputs are compared within a few bf16 ulps (2e-2 absolute at unit
  scale), as slice 1 compares bf16 attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.models import model as jmodel
from mit_tpu.models import vision as jvis
from mit_tpu.ops import pallas_int8_layer as jlayer
from mit_tpu.ops import pallas_int8_mlp as jmlp
from mit_tpu.ops import quant as jquant
from mit_tpu.ops.pallas_attention import (
    flash_attention_btd_fusedqkv as jax_fusedqkv,
)
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import layer_params, params_from_jax
from mit_tpu_torch.ops import int8_layer as tlayer
from mit_tpu_torch.ops import int8_mlp as tmlp
from mit_tpu_torch.ops import quant as tquant
from mit_tpu_torch.ops.flash_attention import flash_attention_btd_fusedqkv

REL = 1e-3


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _vision_kw(d, heads, family):
    kw = dict(family="vit", image_size=32, patch_size=8, hidden_size=d,
              num_layers=2, num_heads=heads, intermediate_size=2 * d,
              hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
              ln_pre=False, ln_post=True)
    if family == "clip":
        kw.update(family="clip", hidden_act="quick_gelu", layer_norm_eps=1e-5,
                  patch_bias=False, ln_pre=True, ln_post=False)
    return kw


def _float_params(jcfg, seed=0):
    params = _host(jvis.init_vision_params(jax.random.PRNGKey(seed), jcfg))
    # non-trivial biases and LayerNorm parameters, so each one is exercised
    r = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + r.normal(size=a.shape).astype(np.float32) * 0.05, params
    )


@pytest.fixture(scope="module")
def layer128():
    """One quantized layer at d = 128, 2 heads, F = 256, in both packages."""
    jcfg = jvis.VisionConfig(**_vision_kw(128, 2, "vit"))
    q8 = _host(jvis.quantize_vision_params(_float_params(jcfg), jcfg))
    jl = jax.tree.map(lambda a: a[0], q8["layers"])
    return jl, layer_params(params_from_jax(q8)["layers"], 0)


def _layer_args(lay):
    return (lay["ln1"], lay["attn"]["qkv"], lay["attn"]["o"], lay["ln2"],
            lay["fc1"], lay["fc2"])


# ----------------------------------------------------------------------
# exact pieces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,bias", [((96, 64), True), ((3, 96, 40), False)],
                         ids=["2d-bias", "stacked"])
def test_quantize_weight_is_bitwise_jax(shape, bias):
    r = np.random.default_rng(0)
    w = r.normal(size=shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0                                  # an all-zero channel
    b = r.normal(size=shape[:-2] + shape[-1:]).astype(np.float32) if bias else None
    ref = jquant.quantize_weight(_j(w), None if b is None else _j(b))
    out = tquant.quantize_weight(_t(w), None if b is None else _t(b))
    assert out.w8.dtype == torch.int8 and out.w8.shape == shape
    assert out.w8.transpose(-1, -2).is_contiguous()   # the kernel's layout
    np.testing.assert_array_equal(out.w8.numpy(), np.asarray(ref.w8))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    if bias:
        np.testing.assert_array_equal(out.bias.numpy(), np.asarray(ref.bias))
    else:
        assert out.bias is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dynamic_quantize_and_quantize_rows_are_bitwise_jax(dtype):
    r = np.random.default_rng(1)
    x = (r.normal(size=(40, 96)) * 3).astype(np.float32)
    x[5] = 0.0                                       # the 1e-8 amax floor
    x[6, :4] = [2.5, -2.5, 0.5, 1.5]                 # halves: round to even
    xt = _t(x, dtype)
    xj = jnp.asarray(xt.float().numpy())            # the same rounded row
    j8, jsx = jquant.dynamic_quantize(xj)
    t8, tsx = tquant.dynamic_quantize(xt)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    k8, ksx = jmlp._quantize_rows(xj)
    q8, qsx = tmlp.quantize_rows(xt)                # CPU: the plain version
    np.testing.assert_array_equal(q8.numpy(), np.asarray(k8))
    np.testing.assert_array_equal(qsx.numpy(), np.asarray(ksx)[:, 0])
    assert not q8[5].any() and int(q8.abs().amax(1).min()) in (0, 127)


def test_quantize_rows_with_layernorm_matches_jax(layer128):
    jl, tl = layer128
    r = np.random.default_rng(2)
    x = (r.normal(size=(64, 128)) * 2 + 0.5).astype(np.float32)
    ln = jl["ln1"]
    h = jlayer._ln(_j(x), ln["scale"][None, :], ln["bias"][None, :], 1e-12)
    k8, ksx = jmlp._quantize_rows(h)
    q8, qsx = tmlp.quantize_rows(_t(x), tl["ln1"], 1e-12)
    # the LayerNorm's sums run in another order: a code may flip by one
    diff = np.abs(q8.numpy().astype(np.int32) - np.asarray(k8, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(qsx.numpy(), np.asarray(ksx)[:, 0], rtol=1e-6)


def test_int8_accumulators_and_matmul_match_jax():
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 30, 3072)).astype(np.float32)
    w = (r.normal(size=(3072, 48)) * 0.05).astype(np.float32)
    b = r.normal(size=(48,)).astype(np.float32)
    x8 = r.integers(-127, 128, size=(30, 3072)).astype(np.int8)
    x8[0] = 127                                      # 127² · 3072 > 2²⁴
    qj = jquant.quantize_weight(_j(w), _j(b))
    qt = tquant.quantize_weight(_t(w), _t(b))
    acc = jax.lax.dot_general(jnp.asarray(x8), qj.w8, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    ours = tquant.int8_accumulate(torch.from_numpy(x8), qt.w8)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(acc))
    ref = jquant.int8_matmul(_j(x), qj, jnp.float32)
    out = tquant.int8_matmul(_t(x), qt, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_gelu_polynomial_matches_jax():
    z = np.linspace(-6, 6, 4001).astype(np.float32)
    np.testing.assert_allclose(tmlp._gelu(_t(z)).numpy(),
                               np.asarray(jmlp._gelu(_j(z))), rtol=0, atol=1e-6)
    # it is the clamped polynomial, not exact erf (max error about 1e-3)
    err = (tmlp._erf(_t(z)) - torch.erf(_t(z))).abs().max().item()
    assert 1e-4 < err < 1.5e-3


# ----------------------------------------------------------------------
# the kernels' functions against the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(layer128, out_dtype):
    jl, tl = layer128
    x = np.random.default_rng(4).normal(size=(2, 17, 128)).astype(np.float32)
    ref = jmlp.int8_linear(_j(x), jl["attn"]["qkv"], jnp.dtype(out_dtype))
    out = tmlp.int8_linear(_t(x), tl["attn"]["qkv"], getattr(torch, out_dtype))
    assert out.shape == (2, 17, 384) and str(out.dtype) == f"torch.{out_dtype}"
    if out_dtype == "float32":
        assert _rel(out, ref) < 1e-6
    else:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_int8_mlp_matches_jax(layer128, act):
    jl, tl = layer128
    x = np.random.default_rng(5).normal(size=(3, 11, 128)).astype(np.float32)
    ref = jmlp.fused_int8_mlp(_j(x), jl["fc1"], jl["fc2"], act, jnp.float32)
    out = tmlp.fused_int8_mlp(_t(x), tl["fc1"], tl["fc2"], act, torch.float32)
    assert out.shape == (3, 11, 128)
    assert _rel(out, ref) < REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusedqkv_attention_matches_jax(dtype):
    qkv = np.random.default_rng(6).normal(size=(3, 17, 3 * 128)).astype(
        np.float32)
    ref = jax_fusedqkv(_j(qkv, jnp.dtype(dtype)), 64)
    out = flash_attention_btd_fusedqkv(_t(qkv, getattr(torch, dtype)), 64)
    assert out.shape == (3, 17, 128) and str(out.dtype) == f"torch.{dtype}"
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_int8_vit_layer_matches_jax(layer128, dtype, act):
    jl, tl = layer128
    x = np.random.default_rng(7).normal(size=(2, 17, 128)).astype(np.float32)
    ref = jlayer.fused_int8_vit_layer(_j(x, jnp.dtype(dtype)), *_layer_args(jl),
                                      num_heads=2, eps=1e-12, act=act)
    out = tlayer.fused_int8_vit_layer(_t(x, getattr(torch, dtype)),
                                      *_layer_args(tl), 2, 1e-12, act)
    assert out.shape == x.shape and str(out.dtype) == f"torch.{dtype}"
    assert _rel(out.float(), ref) < (REL if dtype == "float32" else 5e-3)


def test_fused_int8_vit_layer_split_matches_jax(layer128):
    """bf16 x, so the residual stream between the halves is rounded."""
    jl, tl = layer128
    x = np.random.default_rng(8).normal(size=(2, 17, 128)).astype(np.float32)
    ref = jlayer.fused_int8_vit_layer_split(
        _j(x, jnp.bfloat16), *_layer_args(jl), num_heads=2, eps=1e-12)
    out = tlayer.fused_int8_vit_layer_split(_t(x, torch.bfloat16),
                                            *_layer_args(tl), 2, 1e-12)
    mega = tlayer.fused_int8_vit_layer(_t(x, torch.bfloat16),
                                       *_layer_args(tl), 2, 1e-12)
    assert _rel(out.float(), ref) < 5e-3
    assert not torch.equal(out, mega)        # the halves' rounding shows
    f32 = _t(x)
    torch.testing.assert_close(               # and vanishes at f32 x
        tlayer.fused_int8_vit_layer_split(f32, *_layer_args(tl), 2, 1e-12),
        tlayer.fused_int8_vit_layer(f32, *_layer_args(tl), 2, 1e-12),
        rtol=0, atol=0,
    )


# ----------------------------------------------------------------------
# vision_forward_int8 in both forms
# ----------------------------------------------------------------------
# JAX picks its tier by VMEM fit: at d = 128 the whole-layer kernel, at
# d = 64 (not a multiple of 128) the per-op kernels with fused-QKV attention.
FORMS = {"fused": (128, 2, True), "per_op": (64, 1, False)}


@pytest.fixture(scope="module")
def encoders():
    out = {}
    for form, (d, heads, _) in FORMS.items():
        for family in ("vit", "clip"):
            kw = _vision_kw(d, heads, family)
            jcfg, tcfg = jvis.VisionConfig(**kw), tvis.VisionConfig(**kw)
            params = _float_params(jcfg, seed=10)
            q8 = _host(jvis.quantize_vision_params(params, jcfg))
            out[form, family] = (jcfg, tcfg, params, q8)
    return out


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(11).normal(size=(2, 3, 32, 32)).astype(
        np.float32)


@pytest.mark.parametrize("cls_only", [False, True], ids=["all", "cls_only"])
@pytest.mark.parametrize("family", ["vit", "clip"])
@pytest.mark.parametrize("form", list(FORMS))
def test_vision_forward_int8_matches_jax(encoders, pixels, form, family,
                                         cls_only):
    jcfg, tcfg, _, q8 = encoders[form, family]
    ref = jvis.vision_forward_int8(q8, jcfg, jnp.asarray(pixels), jnp.float32,
                                   use_pallas=True, cls_only=cls_only)
    out = tvis.vision_forward_int8(
        params_from_jax(q8), tcfg, torch.from_numpy(pixels), torch.float32,
        cls_only=cls_only, fused_layers=FORMS[form][2],
    )
    assert out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < REL


def test_quantize_vision_params_is_bitwise_jax(encoders):
    jcfg, tcfg, params, q8 = encoders["fused", "clip"]   # no patch bias
    ours = tvis.quantize_vision_params(params_from_jax(params), tcfg)
    want = params_from_jax(q8)
    assert ours["patch"].bias is None and want["patch"].bias is None
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 ours, want)


def test_params_from_jax_carries_int8_leaves(encoders):
    _, _, _, q8 = encoders["fused", "vit"]
    tp = params_from_jax(q8, dtype=torch.bfloat16)
    qkv = tp["layers"]["attn"]["qkv"]
    assert isinstance(qkv, tquant.QuantizedLinear)
    assert qkv.w8.dtype == torch.int8 and qkv.w8.shape == (2, 128, 384)
    assert qkv.scale.dtype == qkv.bias.dtype == torch.float32
    assert qkv.w8.transpose(-1, -2).is_contiguous()
    assert tp["pos"].dtype == torch.bfloat16          # float leaves as asked
    np.testing.assert_array_equal(qkv.w8.numpy(), q8["layers"]["attn"]["qkv"].w8)
    one = layer_params(tp["layers"], 1)["fc2"]
    np.testing.assert_array_equal(one.w8.numpy(), q8["layers"]["fc2"].w8[1])


def test_int8_close_to_float_encoder(encoders, pixels):
    """The JAX package's own bound between its int8 and float encoders
    (tests/test_quant.py: cosine > 0.999)."""
    _, tcfg, params, q8 = encoders["fused", "vit"]
    ref = tvis.vision_forward(params_from_jax(params), tcfg,
                              torch.from_numpy(pixels))
    for fused in (True, False):
        out = tvis.vision_forward_int8(params_from_jax(q8), tcfg,
                                       torch.from_numpy(pixels), torch.float32,
                                       fused_layers=fused)
        cos = torch.nn.functional.cosine_similarity(
            out.flatten(), ref.flatten(), dim=0).item()
        assert cos > 0.999, cos


# ----------------------------------------------------------------------
# the model, the API and the CLI
# ----------------------------------------------------------------------
DEC = dict(vocab_size=50, embed_dim=32, num_heads=2, num_layers=1, ff_dim=48,
           max_seq_len=16, dropout=0.0, pad_idx=0)


def _model_configs():
    from mit_tpu.models.decoder import DecoderConfig as JDec
    from mit_tpu_torch.models.decoder import DecoderConfig as TDec

    kw = _vision_kw(128, 2, "vit")
    j = jmodel.ModelConfig("tiny", jvis.VisionConfig(**kw), JDec(**DEC))
    t = tmodel.ModelConfig("tiny", tvis.VisionConfig(**kw), TDec(**DEC))
    return j, t


class _Ids:
    pad_id, start_id, end_id = 0, 2, 3


def test_captioner_encoder_quant(pixels):
    from mit_tpu_torch.decode.api import Captioner

    _, tcfg = _model_configs()
    params = tmodel.init_model_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="encoder_quant"):
        Captioner(params, tcfg, _Ids(), encoder_quant="int4")
    caps = {q: Captioner(params, tcfg, _Ids(), encoder_quant=q)
            for q in ("none", "int8", "int8_defect")}
    assert "patch" not in caps["none"].params["encoder"]
    assert "patch_w" in params["encoder"]            # the caller's tree kept
    q8 = caps["int8"].params["encoder"]["layers"]
    bad = caps["int8_defect"].params["encoder"]["layers"]
    # the defect doubles exactly the fc2 scales, and nothing else
    torch.testing.assert_close(bad["fc2"].scale, q8["fc2"].scale * 2,
                               rtol=0, atol=0)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 {**bad, "fc2": None}, {**q8, "fc2": None})
    px = torch.from_numpy(pixels)
    mem = {q: c.memory_from_pixels(px) for q, c in caps.items()}
    err = lambda q: (mem[q] - mem["none"]).norm().item()
    assert mem["int8"].shape == mem["none"].shape == (2, 1, 32)
    assert err("int8_defect") > 10 * err("int8")
    tokens = caps["int8"].generate_from_memory(mem["int8"], max_len=8)
    assert len(tokens) == 2 and all(t[0] == _Ids.start_id for t in tokens)


def test_cli_takes_encoder_quant(monkeypatch):
    from mit_tpu_torch.decode import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--image_path", "x.jpg", "--encoder_quant", "int8"])
    with pytest.raises(SystemExit):
        cli.main(["--image_path", "x.jpg", "--encoder_quant", "int4"])
