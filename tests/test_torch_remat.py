"""Port parity: rematerialization in training (``remat``) and the
``MIT_FUSED_DROPOUT`` switch of ``train()``, on the CPU in f32.

- The port's remat step against the JAX remat step at dropout 0: losses
  within 1e-5 over 3 steps (the tolerance of the step's trajectory test).
- The port's remat step against its own step without remat at dropout 0.1,
  fused and unfused dropout: the loss, every gradient and the next state
  bitwise equal (the recompute redraws the same masks and kernel seeds; a
  recompute that drew anew would change the gradients).
- ``train()`` takes the hash-mask route under ``MIT_FUSED_DROPOUT=1`` and an
  explicit ``fused_dropout`` overrides the variable; the train CLI leaves
  the choice to ``train()``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.models import decoder as jdec
from mit_tpu.models import model as jmodel
from mit_tpu.models import vision as jvis
from mit_tpu.train import steps as jsteps
from mit_tpu_torch.config import Config
from mit_tpu_torch.data import dataset as tdata
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.ops import attention as tattn
from mit_tpu_torch.ops.attention import DropoutGenerators
from mit_tpu_torch.train import steps as tsteps

VIS = dict(family="vit", image_size=32, patch_size=16, hidden_size=48,
           num_layers=1, num_heads=2, intermediate_size=64, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
DEC = dict(vocab_size=64, embed_dim=128, num_heads=2, num_layers=3,
           ff_dim=160, max_seq_len=12, dropout=0.0, pad_idx=0)
CFG = Config(GRAD_CLIP_VALUE=1.0, LEARNING_RATE=3e-3, WEIGHT_DECAY=0.01,
             WARMUP_STEPS=2, NUM_EPOCHS=1)


def _configs(memory_mode="cls", **dec):
    j = jmodel.ModelConfig("tiny", jvis.VisionConfig(**VIS),
                           jdec.DecoderConfig(**dict(DEC, **dec)), memory_mode)
    t = tmodel.ModelConfig("tiny", tvis.VisionConfig(**VIS),
                           tdec.DecoderConfig(**dict(DEC, **dec)), memory_mode)
    return j, t


def _batch(seq=1, b=4, t=11, seed=0):
    """Features (B, seq, 48), pixels and tokens; row 0 is padded after 6."""
    r = np.random.default_rng(seed)
    toks = r.integers(4, 64, (b, t + 1)).astype(np.int32)
    toks[:, 0] = 2
    toks[0, 6:] = 0
    return {"features": r.normal(size=(b, seq, 48)).astype(np.float32),
            "images": r.normal(size=(b, 3, 32, 32)).astype(np.float32),
            "decoder_input_tokens": toks[:, :-1],
            "target_tokens": toks[:, 1:]}


def _params(mcfg_j, seed=0):
    return jax.tree.map(np.asarray,
                        jmodel.init_model_params(jax.random.PRNGKey(seed), mcfg_j))


@pytest.mark.parametrize("memory_mode,seq,from_features", [
    ("cls", 1, True), ("full", 5, True), ("cls", 1, False)],
    ids=["cls", "full", "pixels"])
def test_remat_step_matches_jax_remat_step(memory_mode, seq, from_features):
    """Dropout 0: three remat steps of each package, losses within 1e-5."""
    mj, mt = _configs(memory_mode)
    params = _params(mj)
    trainable, frozen = jmodel.split_trainable(params)
    if from_features:
        frozen = {}
    jopt, _ = jsteps.make_optimizer(CFG, steps_per_epoch=3)
    topt, _ = tsteps.make_optimizer(CFG, steps_per_epoch=3)
    jstep = jsteps.make_train_step(mj, jopt, 0, jnp.float32,
                                   from_features=from_features, donate=False,
                                   remat=True)
    tstep = tsteps.make_train_step(mt, topt, 0, torch.float32,
                                   from_features=from_features, remat=True)
    js = jsteps.init_train_state(jax.tree.map(jnp.asarray, trainable), jopt)
    ts = tsteps.init_train_state(params_from_jax(trainable), topt)
    jfrozen = jax.tree.map(jnp.asarray, frozen)
    tfrozen = params_from_jax(frozen) if frozen else {}
    for i in range(3):
        batch = _batch(seq, seed=i)
        js, jloss = jstep(js, jfrozen,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
        ts, tloss = tstep(ts, tfrozen, tdata.to_device(batch, "cpu"), 0)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def _grads(mt, params, batch, fused, remat):
    """The train step's loss and gradients at (seed 7, step 0)."""
    gens = DropoutGenerators.for_step(7, 0, "cpu")
    leaves = [p.detach().requires_grad_() for p in tsteps.tree_leaves(params)]
    logits = tmodel.forward_from_features(
        tsteps.tree_unflatten(params, leaves), mt, batch["features"],
        batch["decoder_input_tokens"], False, gens, torch.float32, True,
        fused, remat)
    loss = tsteps.masked_cross_entropy(logits, batch["target_tokens"], 0)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("memory_mode,seq", [("cls", 1), ("full", 5)])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_remat_equals_no_remat_under_dropout(fused, memory_mode, seq):
    """Dropout 0.1: remat gives the same loss, the same gradients and the
    same next state, bit for bit (the bound: equality), and remat really
    recomputed (each self-attention ran twice)."""
    _, mt = _configs(memory_mode, dropout=0.1)
    trainable, _ = tmodel.split_trainable(params_from_jax(_params(
        _configs(memory_mode)[0])))
    batch = tdata.to_device(_batch(seq), "cpu")
    out = {}
    for remat in (False, True):
        tattn.multihead_attention.routes = {"kernel": 0, "plain": 0}
        loss, grads = _grads(mt, trainable, batch, fused, remat)
        routes = dict(tattn.multihead_attention.routes)
        opt, _ = tsteps.make_optimizer(CFG)
        state, step_loss = tsteps.make_train_step(
            mt, opt, 0, torch.float32, from_features=True,
            fused_dropout=fused, remat=remat)(
            tsteps.init_train_state(trainable, opt), {}, batch, 7)
        out[remat] = (loss, grads, state, step_loss, routes)
    (l0, g0, s0, sl0, r0), (l1, g1, s1, sl1, r1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(sl0, sl1)
    assert len(g0) == len(g1) and all(map(torch.equal, g0, g1))
    assert all(map(torch.equal, tsteps.tree_leaves(s0.params),
                   tsteps.tree_leaves(s1.params)))
    # the self-attention (and the full-memory cross-attention) ran again in
    # the backward
    assert sum(r1.values()) == 2 * sum(r0.values()) > 0


def test_remat_off_without_gradients_and_at_eval():
    """Under no_grad (the eval step, decoding) remat changes nothing and
    recomputes nothing."""
    _, mt = _configs(dropout=0.1)
    trainable, _ = tmodel.split_trainable(params_from_jax(_params(
        _configs()[0])))
    batch = tdata.to_device(_batch(), "cpu")
    with torch.no_grad():
        outs = []
        for remat in (False, True):
            tattn.multihead_attention.routes = {"kernel": 0, "plain": 0}
            outs.append((tmodel.forward_from_features(
                trainable, mt, batch["features"],
                batch["decoder_input_tokens"], remat=remat),
                dict(tattn.multihead_attention.routes)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


# ----------------------------------------------------------------------
# MIT_FUSED_DROPOUT in train() (tests/test_torch_train.py's tiny corpus)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import json

    from PIL import Image

    d = tmp_path_factory.mktemp("f2")
    cfg = Config(
        DATA_DIR=str(d) + "/", MAX_SEQ_LEN=16, VOCAB_SIZE=300, BATCH_SIZE=4,
        NUM_EPOCHS=1, DECODER_EMBED_DIM=32, DECODER_LAYERS=1, DECODER_HEADS=2,
        DECODER_FF_DIM=48, DECODER_DROPOUT=0.1, LEARNING_RATE=3e-3,
        NUM_WORKERS=1, COMPUTE_DTYPE="float32", PRETRAINED_ENCODER="off",
        ENCODER_MODEL_NAME="tiny/test-vit", IMAGE_PROCESSOR_NAME="tiny/test-vit",
        HF_UPLOAD_BEST_CHECKPOINTS=False,
    )
    os.makedirs(cfg.IMAGE_DIR)
    caps = {}
    for i in range(8):
        name = f"im{i}.jpg"
        Image.new("RGB", (40, 40), (i * 30 % 255, 60, 90)).save(
            os.path.join(cfg.IMAGE_DIR, name))
        caps[name] = [f"a photo number {i} with things"]
    with open(cfg.CAPTIONS_FILE, "w") as f:
        json.dump(caps, f)
    return cfg


@pytest.mark.parametrize("env,arg,want", [
    ("1", None, True), (None, None, False), ("1", False, False),
    ("0", True, True)], ids=["env_on", "env_unset", "arg_off", "arg_on"])
def test_train_reads_mit_fused_dropout(corpus, monkeypatch, env, arg, want):
    """``fused_dropout=None`` takes the hash-mask route exactly when
    MIT_FUSED_DROPOUT is "1"; a bool overrides the variable."""
    from mit_tpu_torch.train import loop as tloop

    monkeypatch.setitem(tvis.PRESETS, "tiny/test-vit", tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56)))
    if env is None:
        monkeypatch.delenv("MIT_FUSED_DROPOUT", raising=False)
    else:
        monkeypatch.setenv("MIT_FUSED_DROPOUT", env)
    calls = []
    real = tattn.flash_attention_dropout

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_dropout", spy)
    kw = {} if arg is None else {"fused_dropout": arg}
    tattn.multihead_attention.routes = {"kernel": 0, "plain": 0}
    summary = tloop.train(corpus,
                          auto_prepare=False, wandb_enabled=False,
                          device="cpu", max_steps_per_epoch=1, **kw)
    assert np.isfinite(summary["epochs"][0]["train_loss"])
    assert bool(calls) == want
    # the unfused training step drops out on the plain route
    assert (tattn.multihead_attention.routes["plain"] > 0) == (not want)


def test_train_cli_leaves_fused_dropout_to_train(monkeypatch):
    """The CLI passes no fused_dropout (train() reads MIT_FUSED_DROPOUT),
    and --no_hf_upload turns the HF Hub upload off."""
    from mit_tpu_torch.train import cli
    from mit_tpu_torch.train import loop as tloop

    seen = {}

    def fake_train(cfg, **kw):
        seen.update(kw, cfg=cfg)
        return {"best_val_loss": 1.0, "best_checkpoint": None}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tloop, "train", fake_train)
    monkeypatch.setenv("MIT_FUSED_DROPOUT", "1")
    assert cli.main(["--no_prepare", "--no_wandb", "--no_hf_upload"]) == 0
    assert "fused_dropout" not in seen
    assert seen["cfg"].HF_UPLOAD_BEST_CHECKPOINTS is False
    assert cli.main(["--no_prepare", "--no_wandb"]) == 0
    assert seen["cfg"].HF_UPLOAD_BEST_CHECKPOINTS is True
