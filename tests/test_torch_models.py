"""Port parity: vision tower, decoder, model assembly and weight loading of
mit_tpu_torch against mit_tpu on the CPU, in f32.

JAX parameters come from the JAX package's own init and cross over through
``params_from_jax``; inputs come from a numpy seed. The JAX forwards run
with ``use_pallas=True`` (the Pallas kernel in interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.models import decoder as jdec
from mit_tpu.models import model as jmodel
from mit_tpu.models import vision as jvis
from mit_tpu.models.vision import quantize_vision_params
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import params_from_jax

VIT = dict(family="vit", image_size=32, patch_size=8, hidden_size=32,
           num_layers=2, num_heads=2, intermediate_size=48, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
CLIP = dict(VIT, family="clip", hidden_act="quick_gelu", layer_norm_eps=1e-5,
            patch_bias=False, ln_pre=True, ln_post=False)
BLIP = dict(VIT, family="blip", layer_norm_eps=1e-5)
DEC = dict(vocab_size=50, embed_dim=32, num_heads=2, num_layers=2, ff_dim=48,
           max_seq_len=16, dropout=0.0, pad_idx=0)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _pixels(b=2, size=32, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 3, size, size)).astype(
        np.float32
    )


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("family", [VIT, CLIP], ids=["vit", "clip"])
def test_vision_forward_matches_jax(family, cls_only):
    jcfg, tcfg = jvis.VisionConfig(**family), tvis.VisionConfig(**family)
    params = _host(jvis.init_vision_params(jax.random.PRNGKey(0), jcfg))
    # non-trivial biases and LN parameters, so each one is exercised
    r = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + r.normal(size=a.shape).astype(np.float32) * 0.05, params
    )
    px = _pixels()
    ref = jvis.vision_forward(params, jcfg, jnp.asarray(px), use_pallas=True,
                              cls_only=cls_only)
    out = tvis.vision_forward(params_from_jax(params), tcfg,
                              torch.from_numpy(px), cls_only=cls_only)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_vision_forward_plain_path_matches_kernel_path():
    cfg = tvis.VisionConfig(**VIT)
    params = tvis.init_vision_params(torch.Generator().manual_seed(0), cfg)
    px = torch.from_numpy(_pixels())
    a = tvis.vision_forward(params, cfg, px, use_kernel=True)
    b = tvis.vision_forward(params, cfg, px, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _tokens():
    # batch row 1 holds PAD keys mid-sequence and at the tail
    return np.array([[2, 11, 25, 7, 9, 3, 0, 0],
                     [2, 4, 0, 33, 12, 0, 0, 0],
                     [2, 41, 8, 19, 6, 30, 17, 3]], np.int32)


@pytest.mark.parametrize("mem_len", [1, 5])
def test_decoder_forward_matches_jax(mem_len):
    cfg_j, cfg_t = jdec.DecoderConfig(**DEC), tdec.DecoderConfig(**DEC)
    params = _host(jdec.init_decoder_params(jax.random.PRNGKey(2), cfg_j))
    r = np.random.default_rng(3)
    mem = r.normal(size=(3, mem_len, DEC["embed_dim"])).astype(np.float32)
    mask = None
    if mem_len > 1:
        mask = np.zeros((3, mem_len), bool)
        mask[0, 3:] = True
    toks = _tokens()
    ref = jdec.decoder_forward(
        params, cfg_j, jnp.asarray(toks), jnp.asarray(mem),
        None if mask is None else jnp.asarray(mask), use_pallas=True,
    )
    out = tdec.decoder_forward(
        params_from_jax(params), cfg_t, torch.from_numpy(toks).long(),
        torch.from_numpy(mem), None if mask is None else torch.from_numpy(mask),
    )
    # the bound tests/test_decoder_parity.py holds the JAX decoder to
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("family", [VIT, CLIP, BLIP], ids=["vit", "clip", "blip"])
def test_params_from_hf_vision_matches_jax(family):
    jcfg, tcfg = jvis.VisionConfig(**family), tvis.VisionConfig(**family)
    params = jvis.init_vision_params(jax.random.PRNGKey(4), jcfg)
    sd = jvis.hf_vision_state_dict_from_params(params, jcfg, "encoder.")
    prefix = tvis.detect_hf_prefix(sd, tcfg)
    assert prefix == jvis.detect_hf_prefix(sd, jcfg) == "encoder."
    ours = tvis.params_from_hf_vision(sd, tcfg, prefix)
    want = params_from_jax(_host(jvis.params_from_hf_vision(sd, jcfg, prefix)))
    jax.tree.map(torch.testing.assert_close, ours, want)


def test_decoder_state_dict_matches_jax():
    cfg_j, cfg_t = jdec.DecoderConfig(**DEC), tdec.DecoderConfig(**DEC)
    params = jdec.init_decoder_params(jax.random.PRNGKey(5), cfg_j)
    sd = jdec.torch_state_dict_from_params(params, "decoder.")
    ours = tdec.params_from_torch_state_dict(sd, cfg_t, "decoder.")
    want = params_from_jax(
        _host(jdec.params_from_torch_state_dict(sd, cfg_j, "decoder."))
    )
    jax.tree.map(torch.testing.assert_close, ours, want)


def _model_configs(vocab=50):
    vis = dict(VIT, hidden_size=48, num_heads=2)
    j = jmodel.ModelConfig("tiny", jvis.VisionConfig(**vis),
                           jdec.DecoderConfig(**dict(DEC, vocab_size=vocab)))
    t = tmodel.ModelConfig("tiny", tvis.VisionConfig(**vis),
                           tdec.DecoderConfig(**dict(DEC, vocab_size=vocab)))
    return j, t


def test_init_model_params_has_jax_tree_and_shapes():
    jcfg, tcfg = _model_configs()
    want = _host(jmodel.init_model_params(jax.random.PRNGKey(0), jcfg))
    ours = tmodel.init_model_params(torch.Generator().manual_seed(0), tcfg)
    jax.tree.map(lambda a, b: a.shape == tuple(b.shape) or pytest.fail(
        f"{a.shape} != {tuple(b.shape)}"), want, ours)


def test_encode_and_project_match_jax():
    jcfg, tcfg = _model_configs()
    params = _host(jmodel.init_model_params(jax.random.PRNGKey(6), jcfg))
    px = _pixels(seed=7)
    feats = jmodel.encode_images(params, jcfg, jnp.asarray(px))
    ref = jmodel.project_features(params, jcfg, feats)
    tp = params_from_jax(params)
    out = tmodel.project_features(
        tp, tcfg, tmodel.encode_images(tp, tcfg, torch.from_numpy(px))
    )
    assert out.shape == (2, 1, DEC["embed_dim"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_int8_encoder_tree_is_not_ported():
    jcfg, tcfg = _model_configs()
    params = jmodel.init_model_params(jax.random.PRNGKey(0), jcfg)
    q8 = quantize_vision_params(params["encoder"], jcfg.vision)
    with pytest.raises(TypeError):
        params_from_jax(_host(q8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.encode_images({"encoder": {"patch": None}}, tcfg,
                             torch.zeros(1, 3, 32, 32))


def test_model_config_build_matches_jax():
    from mit_tpu.config import Config

    cfg = Config()
    j, t = jmodel.ModelConfig.build(cfg, 123), tmodel.ModelConfig.build(cfg, 123)
    assert tuple(t.vision) == tuple(j.vision)
    assert tuple(t.decoder) == tuple(j.decoder)
    assert (t.encoder_name, t.memory_mode) == (j.encoder_name, j.memory_mode)
    assert t.needs_projection == j.needs_projection
