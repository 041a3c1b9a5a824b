"""Port parity: the training path of mit_tpu_torch against mit_tpu on the
CPU, in f32.

JAX parameters come from the JAX package's own init and cross over through
``params_from_jax``; batches come from a numpy seed. Tolerances: the
optimizer within 1e-6 relative of optax (the same f32 operations); a
5-step trajectory of the train step within 1e-5 (the same model, its sums
in another order); checkpoints and resumes exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mit_tpu.config import Config
from mit_tpu.data import dataset as jdata
from mit_tpu.models import decoder as jdec
from mit_tpu.models import model as jmodel
from mit_tpu.models import vision as jvis
from mit_tpu.train import checkpoint as jckpt
from mit_tpu.train import steps as jsteps
from mit_tpu_torch.data import dataset as tdata
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import params_from_jax, params_to_jax
from mit_tpu_torch.ops.attention import DropoutGenerators, multihead_attention
from mit_tpu_torch.train import checkpoint as tckpt
from mit_tpu_torch.train import steps as tsteps

VIS = dict(family="vit", image_size=32, patch_size=16, hidden_size=48,
           num_layers=1, num_heads=2, intermediate_size=64, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
DEC = dict(vocab_size=64, embed_dim=128, num_heads=2, num_layers=2,
           ff_dim=160, max_seq_len=12, dropout=0.0, pad_idx=0)
CFG = Config(GRAD_CLIP_VALUE=1.0, LEARNING_RATE=3e-3, WEIGHT_DECAY=0.01,
             WARMUP_STEPS=2, NUM_EPOCHS=1)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(memory_mode="cls", **dec):
    j = jmodel.ModelConfig("tiny", jvis.VisionConfig(**VIS),
                           jdec.DecoderConfig(**dict(DEC, **dec)), memory_mode)
    t = tmodel.ModelConfig("tiny", tvis.VisionConfig(**VIS),
                           tdec.DecoderConfig(**dict(DEC, **dec)), memory_mode)
    return j, t


def _batch(seq=1, b=4, t=11, seed=0):
    """Features (B, seq, 48) and tokens; row 0 is padded after 6 tokens."""
    r = np.random.default_rng(seed)
    toks = r.integers(4, 64, (b, t + 1)).astype(np.int32)
    toks[:, 0] = 2
    toks[0, 6:] = 0
    return {"features": r.normal(size=(b, seq, 48)).astype(np.float32),
            "images": r.normal(size=(b, 3, 32, 32)).astype(np.float32),
            "decoder_input_tokens": toks[:, :-1],
            "target_tokens": toks[:, 1:]}


def _torch_batch(batch):
    return tdata.to_device(batch, "cpu")


def _params(mcfg_j, seed=0):
    return _host(jmodel.init_model_params(jax.random.PRNGKey(seed), mcfg_j))


def _assert_trees_close(ours, want, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **tol),
                 params_to_jax(ours), _host(want))


# ----------------------------------------------------------------------
def test_masked_cross_entropy_matches_jax():
    r = np.random.default_rng(0)
    logits = r.normal(size=(3, 7, 11)).astype(np.float32)
    targets = r.integers(0, 11, (3, 7)).astype(np.int32)
    targets[0, 4:] = 0
    want = jsteps.masked_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(targets), 0)
    got = tsteps.masked_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets), 0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # all-PAD targets give 0, not NaN
    zero = tsteps.masked_cross_entropy(torch.from_numpy(logits),
                                       torch.zeros(3, 7, dtype=torch.int64), 0)
    assert zero.item() == 0.0


def test_optimizer_matches_optax_chain():
    """20 updates, warmup 3, the clip triggered on some: params within 1e-6
    relative of ``optax.chain(clip_by_global_norm, adamw)``."""
    cfg = CFG.replace(LEARNING_RATE=1e-2, WARMUP_STEPS=3, NUM_EPOCHS=2)
    r = np.random.default_rng(1)
    params = {"a": r.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": r.normal(size=(7,)).astype(np.float32)}}
    jopt, jsched = jsteps.make_optimizer(cfg, steps_per_epoch=10)
    topt, tsched = tsteps.make_optimizer(cfg, steps_per_epoch=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_jax(params)
    ts = topt.init(tp)
    clipped = []
    for i in range(20):
        scale = 3.0 if i % 3 == 0 else 0.05
        g = jax.tree.map(lambda x: (r.normal(size=x.shape) * scale)
                         .astype(np.float32), params)
        clipped.append(float(optax.global_norm(g)) >= cfg.GRAD_CLIP_VALUE)
        assert float(tsched(i)) == float(jsched(i))
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = topt.update(params_from_jax(g), ts, tp)
        _assert_trees_close(tp, jp, rtol=1e-6, atol=0)
    assert ts.count == 20 and any(clipped) and not all(clipped)


@pytest.mark.parametrize("memory_mode,seq", [("cls", 1), ("full", 5)])
def test_train_step_trajectory_matches_jax(memory_mode, seq):
    """5 steps from features, dropout 0, f32: losses and params within 1e-5."""
    mj, mt = _configs(memory_mode)
    trainable, _ = jmodel.split_trainable(_params(mj))
    jopt, _ = jsteps.make_optimizer(CFG, steps_per_epoch=5)
    topt, _ = tsteps.make_optimizer(CFG, steps_per_epoch=5)
    jstep = jsteps.make_train_step(mj, jopt, 0, jnp.float32,
                                   from_features=True, donate=False)
    tstep = tsteps.make_train_step(mt, topt, 0, torch.float32,
                                   from_features=True)
    js = jsteps.init_train_state(jax.tree.map(jnp.asarray, trainable), jopt)
    ts = tsteps.init_train_state(params_from_jax(trainable), topt)
    for i in range(5):
        batch = _batch(seq, seed=i)
        js, jloss = jstep(js, {}, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
        ts, tloss = tstep(ts, {}, _torch_batch(batch), 0)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert ts.step == int(js.step) == 5
    # A key bias adds a per-row constant to the scores, so its exact gradient
    # is zero, and Adam (eps 1e-9) turns the rounding noise of each
    # framework into steps of up to lr: the key biases are held to that
    # bound, every other leaf to 1e-5.
    lr_bound = 5 * CFG.LEARNING_RATE
    for attn in ("self", "cross"):
        for st in (ts.params, js.params):
            bk = st["decoder"]["layers"][attn].pop("bk")
            assert np.abs(np.asarray(bk)).max() <= lr_bound
    _assert_trees_close(ts.params, js.params, rtol=1e-5, atol=1e-5)


def test_train_step_from_pixels_matches_from_features():
    """The frozen encoder in the step gives the step on its cached output."""
    _, mt = _configs()
    mj, _ = _configs()
    params = params_from_jax(_params(mj))
    trainable, frozen = tmodel.split_trainable(params)
    opt, _ = tsteps.make_optimizer(CFG)
    batch = _torch_batch(_batch())
    batch["features"] = tmodel.encode_images(params, mt, batch["images"])
    s_px, l_px = tsteps.make_train_step(mt, opt, 0, torch.float32)(
        tsteps.init_train_state(trainable, opt), frozen, batch, 0)
    s_ft, l_ft = tsteps.make_train_step(mt, opt, 0, torch.float32,
                                        from_features=True)(
        tsteps.init_train_state(trainable, opt), {}, batch, 0)
    assert l_px.item() == l_ft.item()
    jax.tree.map(torch.testing.assert_close, s_px.params, s_ft.params)


def test_pad_row_gradient_is_zero():
    mj, mt = _configs()
    trainable, _ = tmodel.split_trainable(params_from_jax(_params(mj)))
    opt, _ = tsteps.make_optimizer(CFG.replace(WEIGHT_DECAY=0.0, WARMUP_STEPS=0))
    state = tsteps.init_train_state(trainable, opt)
    new, _ = tsteps.make_train_step(mt, opt, 0, torch.float32,
                                    from_features=True)(
        state, {}, _torch_batch(_batch()), 0)
    emb0 = state.params["decoder"]["token_embedding"]
    emb1 = new.params["decoder"]["token_embedding"]
    assert torch.equal(emb1[0], emb0[0])            # PAD row: no update
    assert not torch.equal(emb1[5], emb0[5])
    assert not new.opt_state.mu["decoder"]["token_embedding"][0].any()


def test_eval_step_sums_match_jax():
    mj, mt = _configs()
    params = _params(mj)
    batch = _batch(seed=3)
    s, c = jsteps.make_eval_step(mj, 0, jnp.float32, from_features=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tc = tsteps.make_eval_step(mt, 0, torch.float32, from_features=True)(
        params_from_jax(params), _torch_batch(batch))
    np.testing.assert_allclose(ts.item(), float(s), rtol=1e-5)
    assert tc.item() == float(c) == (batch["target_tokens"] != 0).sum()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", ["vit", "clip", "blip"])
def test_state_dict_export_matches_jax(family):
    vis = dict(VIS, family=family)
    jcfg, tcfg = jvis.VisionConfig(**vis), tvis.VisionConfig(**vis)
    params = _host(jvis.init_vision_params(jax.random.PRNGKey(1), jcfg))
    want = jvis.hf_vision_state_dict_from_params(params, jcfg, "encoder.")
    got = tvis.hf_vision_state_dict_from_params(params_from_jax(params), tcfg,
                                                "encoder.")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    dparams = _host(jdec.init_decoder_params(jax.random.PRNGKey(2),
                                             jdec.DecoderConfig(**DEC)))
    want = jdec.torch_state_dict_from_params(dparams, "decoder.")
    got = tdec.torch_state_dict_from_params(params_from_jax(dparams),
                                            "decoder.")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_written_by_port_load_in_jax(tmp_path):
    mj, mt = _configs()
    params = params_from_jax(_params(mj))
    path = str(tmp_path / "m.safetensors")
    tckpt.save_safetensors(path, params, mt)
    _assert_trees_close(params, jckpt.load_safetensors(path, mj), rtol=0,
                        atol=0)
    jax.tree.map(torch.testing.assert_close, tckpt.load_safetensors(path, mt),
                 params)


def test_checkpoint_filename_matches_jax():
    cfg = Config()
    name = tckpt.checkpoint_filename(cfg, epoch=9, val_loss=2.5425)
    assert name == jckpt.checkpoint_filename(cfg, epoch=9, val_loss=2.5425)
    assert tckpt.parse_checkpoint_filename(name + ".safetensors") == (10, 2.5425)
    assert tckpt.parse_checkpoint_filename("other.safetensors") is None


def test_resume_repeats_an_uninterrupted_run(tmp_path):
    """2 steps, save, restore, 1 step == 3 steps, with the fused dropout
    active: each step's masks depend on (seed, step) only."""
    mj, mt = _configs(dropout=0.1)
    trainable, _ = tmodel.split_trainable(params_from_jax(_params(mj)))
    opt, _ = tsteps.make_optimizer(CFG, steps_per_epoch=3)
    step = tsteps.make_train_step(mt, opt, 0, torch.float32,
                                  from_features=True, fused_dropout=True)
    batches = [_torch_batch(_batch(seed=i)) for i in range(3)]
    straight = tsteps.init_train_state(trainable, opt)
    for b in batches:
        straight, loss = step(straight, {}, b, 7)
    state = tsteps.init_train_state(trainable, opt)
    for b in batches[:2]:
        state, _ = step(state, {}, b, 7)
    tckpt.save_train_state(str(tmp_path), state, epoch=1, best_val_loss=1.5,
                           cfg=Config())
    restored, start, best = tckpt.restore_train_state(
        str(tmp_path), tsteps.init_train_state(trainable, opt))
    assert (restored.step, start, best) == (2, 2, 1.5)
    meta = json.load(open(tmp_path / "train_state_meta.json"))
    assert set(meta) == {"epoch", "best_val_loss", "config"}
    resumed, loss2 = step(restored, {}, batches[2], 7)
    assert loss2.item() == loss.item() and resumed.step == 3
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 resumed.params, straight.params)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 resumed.opt_state.nu, straight.opt_state.nu)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_dropout_is_determined_by_seed_and_step(fused):
    mj, mt = _configs(dropout=0.3)
    trainable, _ = tmodel.split_trainable(params_from_jax(_params(mj)))
    opt, _ = tsteps.make_optimizer(CFG)
    step = tsteps.make_train_step(mt, opt, 0, torch.float32,
                                  from_features=True, fused_dropout=fused)
    state = tsteps.init_train_state(trainable, opt)
    batch = _torch_batch(_batch())
    losses = [step(state, {}, batch, seed)[1].item() for seed in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]
    later = step(state._replace(step=1), {}, batch, 3)[1].item()
    assert later != losses[0]
    # dropout off at eval: the eval step equals the loss of a
    # deterministic forward
    with torch.no_grad():
        logits = tmodel.forward_from_features(
            {**state.params}, mt, batch["features"],
            batch["decoder_input_tokens"])
    s, c = tsteps.make_eval_step(mt, 0, torch.float32, from_features=True)(
        state.params, batch)
    torch.testing.assert_close(
        s / c, tsteps.masked_cross_entropy(logits, batch["target_tokens"], 0))


def test_fused_dropout_kernel_and_plain_paths_agree_on_cpu():
    """use_kernel selects the wrapper or the plain autograd version of the
    same hash-mask attention: on the CPU both are the plain version."""
    r = np.random.default_rng(5)
    p = params_from_jax({w: r.normal(size=(128, 128)).astype(np.float32) * 0.1
                         for w in ("wq", "wk", "wv", "wo")})
    p.update({b: torch.zeros(128) for b in ("bq", "bk", "bv", "bo")})
    x = torch.from_numpy(r.normal(size=(2, 9, 128)).astype(np.float32))
    outs = [multihead_attention(
        p, x, x, 2, causal=True, pad_add=torch.zeros(2, 9), dropout_rate=0.2,
        generator=DropoutGenerators.for_step(1, 0, "cpu"),
        deterministic=False, fused_dropout=True, use_kernel=use_kernel)
        for use_kernel in (True, False)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="dense mask"):
        multihead_attention(p, x, x, 2, mask=torch.zeros(1, 1, 9, 9),
                            dropout_rate=0.2,
                            generator=DropoutGenerators.for_step(1, 0, "cpu"),
                            deterministic=False, fused_dropout=True)


# ----------------------------------------------------------------------
def test_collate_and_split_match_jax():
    items = [{"image_path": f"p{i}", "caption_tokens":
              np.arange(i, i + 6, dtype=np.int32)} for i in range(3)]
    want = jdata.collate(items, 0, 5)
    got = tdata.collate(items, 0, 5)
    for k in ("decoder_input_tokens", "target_tokens", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(tdata.split_indices(50, 0.9, 42),
                    jdata.split_indices(50, 0.9, 42)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """The corpus of tests/test_train.py: 8 images, 2 captions each."""
    from PIL import Image

    d = tmp_path_factory.mktemp("traindata")
    cfg = Config(
        DATA_DIR=str(d) + "/", MAX_SEQ_LEN=16, VOCAB_SIZE=300, BATCH_SIZE=4,
        NUM_EPOCHS=2, DECODER_EMBED_DIM=32, DECODER_LAYERS=1, DECODER_HEADS=2,
        DECODER_FF_DIM=48, DECODER_DROPOUT=0.0, LEARNING_RATE=3e-3,
        NUM_WORKERS=1, COMPUTE_DTYPE="float32",
        ENCODER_MODEL_NAME="tiny/test-vit", IMAGE_PROCESSOR_NAME="tiny/test-vit",
        HF_UPLOAD_BEST_CHECKPOINTS=False,
    )
    os.makedirs(cfg.IMAGE_DIR)
    caps = {}
    for i in range(8):
        name = f"im{i}.jpg"
        Image.new("RGB", (40, 40), (i * 30 % 255, 60, 90)).save(
            os.path.join(cfg.IMAGE_DIR, name))
        caps[name] = [f"a photo number {i} with things",
                      f"another view of item {i}"]
    with open(cfg.CAPTIONS_FILE, "w") as f:
        json.dump(caps, f)
    return cfg


def _tiny_train(cfg, monkeypatch, **kw):
    monkeypatch.setitem(tvis.PRESETS, "tiny/test-vit", tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56)))
    from mit_tpu_torch.train.loop import train

    return train(cfg, auto_prepare=False, wandb_enabled=False, device="cpu",
                 **kw)


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "in_graph"])
def test_train_loop_on_tiny_corpus(tiny_corpus, monkeypatch, cache):
    cfg = tiny_corpus.replace(CACHE_ENCODER_FEATURES=cache)
    summary = _tiny_train(cfg, monkeypatch)
    e1, e2 = summary["epochs"]
    assert e2["train_loss"] < e1["train_loss"]
    assert summary["best_checkpoint"] and os.path.exists(
        summary["best_checkpoint"])
    assert os.path.exists(os.path.join(cfg.OUTPUT_DIR, "latest",
                                       "train_state.pt"))


def test_train_loop_resumes_and_refuses_what_is_not_ported(tiny_corpus,
                                                           monkeypatch):
    cfg = tiny_corpus.replace(DECODER_DROPOUT=0.1, NUM_EPOCHS=1)
    first = _tiny_train(cfg, monkeypatch, fused_dropout=True,
                        max_steps_per_epoch=2)
    assert np.isfinite(first["epochs"][0]["train_loss"])
    resumed = _tiny_train(
        cfg.replace(NUM_EPOCHS=2, RESUME_CHECKPOINT_PATH=os.path.join(
            cfg.OUTPUT_DIR, "latest")), monkeypatch, fused_dropout=True,
        max_steps_per_epoch=2)
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    # the mesh is ported (tests/test_torch_parallel.py); a mesh shape that
    # the world's processes do not fill is refused, as JAX's create_mesh
    # refuses one its devices do not fill
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{cfg.OUTPUT_DIR}/pg", rank=0,
        world_size=1)
    try:
        with pytest.raises(ValueError, match="does not match 1 available"):
            _tiny_train(cfg.replace(MESH_SHAPE=(2, 1)), monkeypatch)
    finally:
        torch.distributed.destroy_process_group()
    # pretrained loading is ported: a required encoder that resolves nowhere
    # (no local file, no cached repo, no download) raises, as in JAX's loop
    monkeypatch.delenv("MIT_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(ValueError, match="tiny/test-vit"):
        _tiny_train(cfg.replace(PRETRAINED_ENCODER="required"), monkeypatch)


def test_cli_refuses_to_train_without_cuda(monkeypatch):
    from mit_tpu_torch.train import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--no_prepare", "--no_wandb"])
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])


class _FakeWandbRun:
    def __init__(self):
        self.logged, self.artifacts, self.finished = [], [], False

    def log(self, d):
        self.logged.append(d)

    def log_artifact(self, art):
        self.artifacts.append(art)

    def finish(self):
        self.finished = True


class _FakeArtifact:
    def __init__(self, name, type, description=""):
        self.name, self.type, self.description = name, type, description
        self.files = []

    def add_file(self, path):
        self.files.append(path)


def test_train_loop_logs_a_model_artifact_per_best_checkpoint(tiny_corpus,
                                                              monkeypatch):
    """A wandb run receives one model artifact for every new best
    checkpoint, as the JAX loop logs them; a failing log_artifact does not
    stop training."""
    import sys
    import types

    from mit_tpu_torch.train import loop

    run = _FakeWandbRun()
    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(Artifact=_FakeArtifact))
    monkeypatch.setattr(loop, "setup_wandb", lambda cfg: run)
    monkeypatch.setitem(tvis.PRESETS, "tiny/test-vit", tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56)))
    saved = []
    real_save = loop.ckpt.save_safetensors
    monkeypatch.setattr(loop.ckpt, "save_safetensors",
                        lambda path, *a, **k: (saved.append(path),
                                               real_save(path, *a, **k))[1])
    summary = loop.train(tiny_corpus, auto_prepare=False, wandb_enabled=True,
                         device="cpu")
    assert saved and len(run.artifacts) == len(saved)
    assert [a.files for a in run.artifacts] == [[p] for p in saved]
    assert all(a.type == "model" and "val loss" in a.description
               for a in run.artifacts)
    assert run.artifacts[-1].files == [summary["best_checkpoint"]]
    assert run.finished and any("epoch_val_loss" in d for d in run.logged)

    def refuse(art):
        raise RuntimeError("no tracking today")

    run2 = _FakeWandbRun()
    run2.log_artifact = refuse
    monkeypatch.setattr(loop, "setup_wandb", lambda cfg: run2)
    again = loop.train(tiny_corpus.replace(NUM_EPOCHS=1), auto_prepare=False,
                       wandb_enabled=True, device="cpu")
    assert again["best_checkpoint"] and run2.finished


@pytest.mark.parametrize("error", [OSError("disk full"),
                                   RuntimeError("serialization failed")],
                         ids=["oserror", "runtimeerror"])
def test_train_loop_survives_a_failed_train_state_save(tiny_corpus,
                                                       monkeypatch, error):
    """The periodic train-state save is an autosave: whatever it raises is
    reported and training goes on, as in the JAX loop."""
    from mit_tpu_torch.train import loop

    def refuse(*a, **k):
        raise error

    monkeypatch.setattr(loop.ckpt, "save_train_state", refuse)
    summary = _tiny_train(tiny_corpus, monkeypatch)
    assert len(summary["epochs"]) == 2 and summary["best_checkpoint"]
