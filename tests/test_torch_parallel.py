"""The device mesh's training path (``mit_tpu_torch.parallel``) on the CPU:
``gloo`` process groups of 2 and 4 processes, each started as this file
run as a script (``--worker``) with ``file://`` init in ``tmp_path``.
Every spawn is joined within ``TIMEOUT`` seconds, and a spawn that does not
end fails its test instead of hanging it. Several checks share a spawn.

At the JAX package's mesh-test sizes (``tests/test_parallel.py``, f32), one
train step at meshes (2, 1), (1, 2) and (2, 2) equals the port's
single-device step: the loss within 1e-6 relative, every parameter within
rtol 1e-5 / atol 1e-6 (JAX's bound), at dropout 0 and 0.1, fused and
unfused, with the clip binding and not, from features and from pixels
(the float encoder split over "model" where the mesh has a model axis, the
int8 encoder whole on every rank).
Adam's first step is ``lr · g / (|g| + eps)`` with eps 1e-9, so where the
gradient Adam sees is under ``ILL_CONDITIONED`` (a key bias, whose exact
gradient is zero, and any element that lands near zero) the last bits of
``g`` move the step by up to the learning rate. So the gradients Adam saw
are compared first, every element within rtol 1e-5 / ``GRAD_ATOL``; those
ill-conditioned elements' steps are then held to the difference that the
two gradients make in Adam's step, and the rest of the parameters to
rtol 1e-5 / atol 1e-6. The tests count those elements. The batch's two halves hold different counts of PAD
targets, so a mean of the ranks' means would miss the global token mean
(asserted).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from mit_tpu_torch.config import Config  # noqa: E402
from mit_tpu_torch.models import decoder as tdec  # noqa: E402
from mit_tpu_torch.models import model as tmodel  # noqa: E402
from mit_tpu_torch.models import vision as tvis  # noqa: E402
from mit_tpu_torch.models.convert import params_from_jax  # noqa: E402
from mit_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mit_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from mit_tpu_torch.train import steps as tsteps  # noqa: E402

TIMEOUT = 120                   # seconds a spawn may take, all ranks joined

# tests/test_parallel.py's sizes
VIS = dict(family="vit", image_size=32, patch_size=16, hidden_size=48,
           num_layers=1, num_heads=8, intermediate_size=64, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
DEC = dict(vocab_size=64, embed_dim=32, num_heads=8, num_layers=2, ff_dim=64,
           max_seq_len=12, dropout=0.0, pad_idx=0)
LR = 1e-2
ILL_CONDITIONED = 1e-7      # |g| under which Adam's first step is lr · noise
GRAD_ATOL = 2e-8            # on the gradients Adam saw (TP's noise: 1.6e-8)
FEW = 8                     # ill-conditioned elements besides the key biases
# (dropout, fused dropout, clip, from features); the gradient's norm is
# about 1.5 here, so a clip of 0.5 binds and one of 5.0 does not
CASES = [(0.0, False, 5.0, True), (0.1, False, 0.5, True),
         (0.1, True, 0.5, True), (0.1, True, 0.0, True),
         (0.1, True, 0.5, False), (0.0, False, 5.0, False)]
PIXELS_AT_0 = CASES[5]      # the encoder in the step, dropout 0
INT8_CASE = (0.1, True, 0.5, False)     # with the int8 encoder
# a tiny 4-head encoder of each family, for the split encoder at (1, 2) and
# (1, 4) (tests/test_torch_models.py's sizes, with 4 heads)
VIT4 = dict(family="vit", image_size=32, patch_size=8, hidden_size=32,
            num_layers=2, num_heads=4, intermediate_size=48,
            hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
            ln_pre=False, ln_post=True)
FAMILIES = {"vit": VIT4,
            "clip": dict(VIT4, family="clip", hidden_act="quick_gelu",
                         layer_norm_eps=1e-5, patch_bias=False, ln_pre=True,
                         ln_post=False),
            "blip": dict(VIT4, family="blip", layer_norm_eps=1e-5)}
ENCODER_TOL = 2e-5          # f32, rtol and atol, split encoder vs one device


def mcfg(dropout=0.0):
    return tmodel.ModelConfig("tiny", tvis.VisionConfig(**VIS),
                              tdec.DecoderConfig(**dict(DEC, dropout=dropout)))


def batch(b=8, t=11, seed=0):
    """Rows 0-3 end after 3 targets, rows 4-7 run the whole length: the
    halves hold 12 and 44 targets."""
    r = np.random.default_rng(seed)
    toks = r.integers(4, 64, (b, t + 1)).astype(np.int64)
    toks[:, 0] = 2
    toks[: b // 2, 4:] = 0
    return {"features": torch.from_numpy(
                r.normal(size=(b, 1, 48)).astype(np.float32)),
            "images": torch.from_numpy(
                r.normal(size=(b, 3, 32, 32)).astype(np.float32)),
            "decoder_input_tokens": torch.from_numpy(toks[:, :-1]),
            "target_tokens": torch.from_numpy(toks[:, 1:])}


def model_params(dropout=0.0, seed=0):
    return tmodel.init_model_params(torch.Generator().manual_seed(seed),
                                    mcfg(dropout))


def host(tree):
    return tsteps.tree_map(lambda x: x.detach().cpu().numpy().copy(), tree)


# ----------------------------------------------------------------------
# checks, run in every rank of a spawn
# ----------------------------------------------------------------------
def one_step(mesh, case, params, b, int8=False):
    """(state after one step, loss) at ``mesh`` (None: one device), whole.
    From pixels, the encoder is this rank's as ``train()`` gives it
    (``shard_encoder``); ``int8`` quantizes it first."""
    rate, fused, clip, from_features = case
    cfg = Config(GRAD_CLIP_VALUE=clip, LEARNING_RATE=LR)
    opt, _ = tsteps.make_optimizer(cfg)
    trainable, frozen = tmodel.split_trainable(params)
    step = tsteps.make_train_step(mcfg(rate), opt, 0, torch.float32,
                                  from_features=from_features,
                                  fused_dropout=fused, mesh=mesh)
    state = tsteps.init_train_state(trainable, opt)
    frozen = {} if from_features else frozen
    if int8:
        frozen = {"encoder": tvis.quantize_vision_params(frozen["encoder"],
                                                         mcfg().vision)}
    if mesh is not None:
        tp = mesh.shape["model"] > 1
        state = pmesh.shard_train_state(state, mesh, tp=tp)
        b = pmesh.shard_batch(b, mesh)
        if frozen:
            frozen = {"encoder": pmesh.shard_encoder(
                frozen["encoder"], mcfg().vision, mesh)}
    state, loss = step(state, frozen, b, 7)
    if mesh is not None:
        state = pmesh.gather_train_state(state, mesh, tp=tp)
    return state, loss.item()


def check_steps(rank, world, shapes):
    """Each case at each mesh shape and on one device."""
    out = {}
    params, b = model_params(), batch()
    for shape in shapes:
        mesh = pmesh.init_distributed_mesh(tuple(shape), "cpu")
        for case in CASES:
            ref, ref_loss = one_step(None, case, model_params(case[0]), b)
            got, loss = one_step(mesh, case, model_params(case[0]), b)
            bound = None
            if case[2]:
                free, _ = one_step(None, case[:2] + (0.0,) + case[3:],
                                   model_params(case[0]), b)
                bound = not all(np.array_equal(x, y) for x, y in zip(
                    tsteps.tree_leaves(host(free.params)),
                    tsteps.tree_leaves(host(ref.params))))
            out[(tuple(shape), case)] = dict(
                ref=host(ref.params), got=host(got.params), ref_loss=ref_loss,
                loss=loss, clip_bound=bound, mu=host(ref.opt_state.mu),
                got_mu=host(got.opt_state.mu))
        ref, ref_loss = one_step(None, INT8_CASE, model_params(0.1), b,
                                 int8=True)
        got, loss = one_step(mesh, INT8_CASE, model_params(0.1), b, int8=True)
        enc = pmesh.shard_encoder(tvis.quantize_vision_params(
            params["encoder"], mcfg().vision), mcfg().vision, mesh)
        out[(tuple(shape), "int8")] = dict(
            ref=host(ref.params), got=host(got.params), ref_loss=ref_loss,
            loss=loss, mu=host(ref.opt_state.mu),
            got_mu=host(got.opt_state.mu),
            qkv=tuple(enc["layers"]["attn"]["qkv"].w8.shape))
        float_enc = pmesh.shard_encoder(params["encoder"], mcfg().vision, mesh)
        out[(tuple(shape), "wq")] = tuple(
            float_enc["layers"]["attn"]["wq"].shape)
    out["params"] = host(params)
    return out if rank == 0 else None


def check_tp_encoder(rank, world, weights):
    """Each family's encoder of ``weights`` (drawn by the JAX package) at
    (1, world): whole on one device and split over "model", CLS-only and
    not; and this rank's widths."""
    mesh = pmesh.init_distributed_mesh((1, world), "cpu")
    trees = torch.load(weights, weights_only=False)
    px = torch.from_numpy(trees["pixels"])
    out = {}
    for family, vis in FAMILIES.items():
        cfg = tvis.VisionConfig(**vis)
        whole = params_from_jax(trees[family])
        local = pmesh.shard_encoder(whole, cfg, mesh)
        for cls_only in (False, True):
            one = tvis.vision_forward(whole, cfg, px, cls_only=cls_only)
            split = tvis.vision_forward(local, cfg, px, cls_only=cls_only,
                                        shard=mesh.step_shard(px.shape[0]))
            out[(family, cls_only)] = (one.numpy(), split.numpy())
        out[(family, "widths")] = (local["layers"]["attn"]["wq"].shape[-1],
                                   local["layers"]["fc1"].shape[-1],
                                   local["layers"]["fc2"].shape[-2],
                                   local["layers"]["attn"]["bo"].shape[-1])
    return out


def check_tp_forward(rank, world):
    """A tensor-parallel decoder forward at (1, world) and the replicated
    one, and the ranks' shards joined back."""
    mesh = pmesh.init_distributed_mesh((1, world), "cpu")
    dcfg = tdec.DecoderConfig(**DEC)
    params = tdec.init_decoder_params(torch.Generator().manual_seed(3), dcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, 64, (4, 10)))
    memory = torch.from_numpy(
        np.random.default_rng(1).normal(size=(4, 1, 32)).astype(np.float32))
    ref = tdec.decoder_forward(params, dcfg, toks, memory)
    specs = pmesh.decoder_param_specs(tp=True)
    local = pmesh.shard_tree(params, specs, mesh)
    out = tdec.decoder_forward(local, dcfg, toks, memory,
                               shard=mesh.step_shard(4))
    back = pmesh.gather_tree(local, specs, mesh)
    same = all(torch.equal(x, y) for x, y in zip(
        tsteps.tree_leaves(back), tsteps.tree_leaves(
            tsteps.tree_map(lambda x, y: x, params, back))))
    return {"err": (out - ref).abs().max().item(), "round_trip": same,
            "heads": local["layers"]["self"]["wq"].shape[-1]}


def check_round_trips(rank, world, shape):
    """``shard_tree``, ``gather_tree`` and ``replicate`` at ``shape``: this
    rank's shard of the TP specs' decoder tree, and the tree back."""
    mesh = pmesh.init_distributed_mesh(tuple(shape), "cpu")
    params = tdec.init_decoder_params(torch.Generator().manual_seed(1),
                                      tdec.DecoderConfig(**DEC))
    specs = pmesh.decoder_param_specs(tp=True)
    mine = pmesh.shard_tree(params, specs, mesh)
    j, n = mesh.index("model"), DEC["embed_dim"] // mesh.shape["model"]

    def same(tree):
        eq = tsteps.tree_map(lambda a, b: torch.equal(a, b), params, tree)
        return all(tsteps.tree_leaves(eq))

    return {"coords": tuple(mesh.coords),
            "wq": tuple(mine["layers"]["self"]["wq"].shape),
            "w2": tuple(mine["layers"]["ffn"]["w2"].shape),
            "bq": torch.equal(mine["layers"]["self"]["bq"],
                              params["layers"]["self"]["bq"][:, j * n:
                                                             (j + 1) * n]),
            "embedding": torch.equal(mine["token_embedding"],
                                     params["token_embedding"]),
            "round_trip": same(pmesh.gather_tree(mine, specs, mesh)),
            "replicated": same(pmesh.replicate(params, mesh))}


def check_saves_and_resume(rank, world, workdir):
    """A save under the mesh is the single-device save byte for byte, and
    a run interrupted by a save and a resume repeats an uninterrupted one."""
    mesh = pmesh.init_distributed_mesh((-1, 2) if world % 2 == 0 else (1, 1),
                                       "cpu")
    tp = mesh.shape["model"] > 1
    cfg = Config(GRAD_CLIP_VALUE=1.0, LEARNING_RATE=LR)
    opt, _ = tsteps.make_optimizer(cfg)
    params = model_params(0.1)
    trainable, _ = tmodel.split_trainable(params)
    step = tsteps.make_train_step(mcfg(0.1), opt, 0, torch.float32,
                                  from_features=True, fused_dropout=True,
                                  mesh=mesh)
    single = tsteps.init_train_state(trainable, opt)
    state = pmesh.shard_train_state(single, mesh, tp=tp)
    out = {}
    files = {"mesh": os.path.join(workdir, "mesh"),
             "single": os.path.join(workdir, "single")}
    whole = pmesh.gather_train_state(state, mesh, tp=tp)
    if rank == 0:
        for name, st in (("mesh", whole), ("single", single)):
            tckpt.save_train_state(files[name], st, 0, 1.5, cfg)
            tckpt.save_safetensors(os.path.join(files[name], "w.safetensors"),
                                   {**st.params, **tmodel.split_trainable(
                                       params)[1]}, mcfg())
        out["safetensors_equal"] = open(
            os.path.join(files["mesh"], "w.safetensors"), "rb").read() == open(
            os.path.join(files["single"], "w.safetensors"), "rb").read()
        a, b = (torch.load(os.path.join(files[n], tckpt.STATE_FILE),
                           weights_only=True) for n in ("mesh", "single"))
        tensors = lambda t: tsteps.tree_leaves(
            {"p": t["params"], "mu": t["opt_state"]["mu"],
             "nu": t["opt_state"]["nu"]})
        out["state_equal"] = (
            (a["step"], a["opt_state"]["count"])
            == (b["step"], b["opt_state"]["count"])
            and all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b))))
    # two steps straight, against one step, a save, a restore and a step
    batches = [pmesh.shard_batch(batch(seed=i), mesh) for i in (1, 2)]
    straight = state
    for bt in batches:
        straight, _ = step(straight, {}, bt, 11)
    half, _ = step(state, {}, batches[0], 11)
    saved = pmesh.gather_train_state(half, mesh, tp=tp)
    if rank == 0:
        tckpt.save_train_state(os.path.join(workdir, "half"), saved, 0, 2.0,
                               cfg)
    dist.barrier()
    restored, epoch, best = tckpt.restore_train_state(
        os.path.join(workdir, "half"), single)
    resumed = pmesh.shard_train_state(restored, mesh, tp=tp)
    resumed, _ = step(resumed, {}, batches[1], 11)
    out["resume_equal"] = all(torch.equal(x, y) for x, y in zip(
        tsteps.tree_leaves(straight.params), tsteps.tree_leaves(
            resumed.params))) and resumed.step == straight.step == 2
    out["resume_meta"] = (epoch, best)
    return out


def check_refusals(rank, world, data_dir):
    """``train()``'s ValueErrors: the batch, the mesh's shape, and an
    encoder in the step whose heads do not split over the model axis."""
    from mit_tpu_torch.train.loop import train

    tvis.PRESETS["tiny/test-vit"] = tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56, num_heads=2))
    tvis.PRESETS["tiny/test-vit-3"] = tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56, num_heads=3))
    cfg = tiny_config(data_dir)
    out = {}
    for key, c, exc in (
            ("batch", cfg.replace(MESH_SHAPE=(2, 1), BATCH_SIZE=3), ValueError),
            ("shape", cfg.replace(MESH_SHAPE=(3, 1)), ValueError),
            ("encoder_heads", cfg.replace(
                MESH_SHAPE=(1, 2), CACHE_ENCODER_FEATURES=False,
                ENCODER_MODEL_NAME="tiny/test-vit-3",
                IMAGE_PROCESSOR_NAME="tiny/test-vit-3"), ValueError)):
        try:
            train(c, auto_prepare=False, wandb_enabled=False, device="cpu")
            out[key] = None
        except exc as e:
            out[key] = str(e)
    return out


def check_train_loop(rank, world, data_dir, single_dir, shape, cache):
    """``train()`` under the mesh on the tiny corpus in ``data_dir``: its
    summary, and its losses against ``train()`` on one device on a copy of
    the corpus in ``single_dir`` (rank 0, afterwards). ``cache`` False puts
    the encoder in the step."""
    from mit_tpu_torch.train.loop import train

    tvis.PRESETS["tiny/test-vit"] = tvis.VisionConfig(
        **dict(VIS, image_size=224, patch_size=56, num_heads=2))
    config = lambda d: tiny_config(d).replace(CACHE_ENCODER_FEATURES=cache)
    summary = train(config(data_dir).replace(MESH_SHAPE=tuple(shape)),
                    auto_prepare=False, wandb_enabled=False, device="cpu",
                    fused_dropout=True)
    if rank != 0:
        return None
    single = train(config(single_dir), auto_prepare=False,
                   wandb_enabled=False, device="cpu", fused_dropout=True)
    return {"mesh": summary, "single": single}


def tiny_config(data_dir):
    """``tests/test_torch_train.py``'s tiny corpus config, batch 4."""
    return Config(
        DATA_DIR=os.path.join(data_dir, ""), MAX_SEQ_LEN=16, VOCAB_SIZE=300,
        BATCH_SIZE=4, NUM_EPOCHS=2, DECODER_EMBED_DIM=32, DECODER_LAYERS=1,
        DECODER_HEADS=2, DECODER_FF_DIM=48, DECODER_DROPOUT=0.1,
        LEARNING_RATE=3e-3, NUM_WORKERS=1, COMPUTE_DTYPE="float32",
        ENCODER_MODEL_NAME="tiny/test-vit", IMAGE_PROCESSOR_NAME="tiny/test-vit",
        HF_UPLOAD_BEST_CHECKPOINTS=False, PRETRAINED_ENCODER="off")


CHECKS = {f.__name__: f for f in (check_steps, check_tp_forward,
                                  check_tp_encoder, check_round_trips,
                                  check_saves_and_resume, check_refusals,
                                  check_train_loop)}


# ----------------------------------------------------------------------
# the spawn
# ----------------------------------------------------------------------
def run_ranks(check, world, tmp_path, **kw):
    """``check`` in ``world`` processes over gloo; each rank's result.
    Fails the test if a rank fails or the spawn outlives ``TIMEOUT``."""
    tag = f"{check}_{world}_{time.monotonic_ns()}"
    init = tmp_path / f"{tag}.init"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"{tag}.{r}.pt"
        log = open(tmp_path / f"{tag}.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--worker", check, str(r), str(world),
             str(init), str(out), json.dumps(kw)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
        outs.append(out)
    deadline = time.monotonic() + TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{check} in {world} processes did not end in {TIMEOUT} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            text = (tmp_path / f"{tag}.{r}.log").read_text()
            pytest.fail(f"rank {r} of {check} exited {p.returncode}:\n"
                        f"{text[-4000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def _close(got, ref, mu, got_mu, rtol=1e-5, atol=1e-6):
    """The parameters after one step, from the gradients each side's Adam
    saw (``mu / (1 − β1)``, its first moment after one step): the gradients
    within rtol / ``GRAD_ATOL`` everywhere; then the key biases (an exact
    gradient of 0: rounding noise, or 0, on either side) and the elements
    whose reference gradient is not 0 but under ``ILL_CONDITIONED``, within
    ``lr · |u(g) − u(g_ref)|`` + atol, ``u(g) = g / (|g| + eps)`` being
    Adam's first step; the rest within rtol / atol. → the count of the
    ill-conditioned elements that are not key biases."""
    cfg = Config()
    b1, eps = cfg.ADAM_BETA1, cfg.ADAM_EPS
    step = lambda g: g / (np.abs(g) + eps)
    n = 0
    for path, a, b, m in _leaves_with_paths(got, ref, mu):
        g_ref = m / (1 - b1)
        g = _at(got_mu, path) / (1 - b1)
        np.testing.assert_allclose(g, g_ref, rtol=rtol, atol=GRAD_ATOL,
                                   err_msg=f"gradient {path}")
        ill = (m != 0) & (np.abs(g_ref) < ILL_CONDITIONED)
        if path.endswith("/bk"):
            ill = np.ones_like(ill)
        else:
            n += int(ill.sum())
        moved = LR * np.abs(step(g) - step(g_ref))
        assert np.all(np.abs(a - b)[ill] <= moved[ill] + atol), path
        np.testing.assert_allclose(a[~ill], b[~ill], rtol=rtol, atol=atol,
                                   err_msg=path)
    return n


def _at(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def _adam_mu(state):
    """The first moment in an optax state (the ``adamw`` part's)."""
    if hasattr(state, "mu"):
        return state.mu
    if isinstance(state, (tuple, list)):
        for part in state:
            mu = _adam_mu(part)
            if mu is not None:
                return mu
    return None


def _leaves_with_paths(got, ref, mu, path=""):
    if isinstance(got, dict):
        for k in got:
            yield from _leaves_with_paths(got[k], ref[k], mu[k], f"{path}/{k}")
    else:
        yield path, got, ref, mu


@pytest.mark.parametrize("world,shapes", [(2, [(2, 1), (1, 2)]),
                                          (4, [(2, 2)])],
                         ids=["dp_and_tp", "dp_x_tp"])
def test_mesh_step_equals_the_single_device_step(tmp_path, world, shapes):
    res = run_ranks("check_steps", world, tmp_path, shapes=shapes)[0]
    for shape in shapes:
        for case in CASES:
            r = res[(shape, case)]
            np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
            if case[2]:
                assert r["clip_bound"] == (case[2] == 0.5), case
            # the key biases and 0 to 4 more elements a case, not the tree
            ill = _close(r["got"], r["ref"], r["mu"], r["got_mu"])
            assert ill <= FEW, (shape, case, ill)
        # the float encoder split over "model", the int8 one whole on every
        # rank, and its step the single-device step
        assert res[(shape, "wq")][-1] == VIS["hidden_size"] // shape[1]
        r = res[(shape, "int8")]
        assert 3 * VIS["hidden_size"] in r["qkv"], r["qkv"]
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
        assert _close(r["got"], r["ref"], r["mu"], r["got_mu"]) <= FEW
    # the halves hold 12 and 44 targets: the mean of their own means misses
    # the global token mean by far more than the bound above
    b, params = batch(), model_params()
    halves = []
    for i in (0, 4):
        assert (b["target_tokens"][i:i + 4] != 0).sum().item() == \
            (12 if i == 0 else 44)
        logits = tmodel.forward_from_features(
            params, mcfg(), b["features"][i:i + 4],
            b["decoder_input_tokens"][i:i + 4])
        halves.append(tsteps.masked_cross_entropy(
            logits, b["target_tokens"][i:i + 4], 0).item())
    loss = res[(shapes[0], CASES[0])]["ref_loss"]
    assert abs(np.mean(halves) - loss) > 1e-3 * loss


def test_mesh_step_at_dropout_0_matches_the_jax_step(tmp_path):
    """At (2, 1) and (1, 2), dropout 0: the mesh step against the JAX
    package's single-device step on the same weights, within
    ``tests/test_torch_train.py``'s 1e-5."""
    import jax
    import jax.numpy as jnp

    from mit_tpu.config import Config as JConfig
    from mit_tpu.models import decoder as jdec
    from mit_tpu.models import model as jmodel
    from mit_tpu.models import vision as jvis
    from mit_tpu.train import steps as jsteps

    res = run_ranks("check_steps", 2, tmp_path, shapes=[(2, 1), (1, 2)])[0]
    mj = jmodel.ModelConfig("tiny", jvis.VisionConfig(**VIS),
                            jdec.DecoderConfig(**DEC), "cls")
    trainable, frozen = jmodel.split_trainable(res["params"])
    b = {k: jnp.asarray(v.numpy()) for k, v in batch().items()}
    # from features, and from pixels with the encoder in the step (split
    # over "model" at (1, 2))
    for case, enc in ((CASES[0], {}), (PIXELS_AT_0, frozen)):
        jopt, _ = jsteps.make_optimizer(JConfig(GRAD_CLIP_VALUE=case[2],
                                                LEARNING_RATE=LR))
        jstep = jsteps.make_train_step(mj, jopt, 0, jnp.float32,
                                       from_features=case[3], donate=False)
        js = jsteps.init_train_state(jax.tree.map(jnp.asarray, trainable),
                                     jopt)
        js, jloss = jstep(js, jax.tree.map(jnp.asarray, enc), b,
                          jax.random.PRNGKey(0))
        want = jax.tree.map(np.asarray, js.params)
        for shape in ((2, 1), (1, 2)):
            r = res[(shape, case)]
            np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
            assert _close(r["got"], jax.tree.map(np.array, want),
                          jax.tree.map(np.array, _adam_mu(js.opt_state)),
                          r["got_mu"], rtol=1e-5, atol=1e-5) <= FEW


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "1x4"])
def test_tp_encoder_matches_one_device_and_jax(tmp_path, world):
    """Each family's encoder split over "model" at (1, world), CLS-only and
    not: equal to the port's encoder on one device and to the JAX
    package's ``vision_forward`` (plain attention) on the same weights,
    within ``ENCODER_TOL`` in f32; a rank holds 1/world of the heads' and
    FFN's columns and the whole out-projection bias."""
    import jax
    import jax.numpy as jnp

    from mit_tpu.models import vision as jvis

    r = np.random.default_rng(5)
    trees = {"pixels": r.normal(size=(3, 3, 32, 32)).astype(np.float32)}
    for i, (family, vis) in enumerate(FAMILIES.items()):
        tree = jax.tree.map(np.asarray, jvis.init_vision_params(
            jax.random.PRNGKey(i), jvis.VisionConfig(**vis)))
        # non-trivial biases and LN parameters, so each is exercised
        trees[family] = jax.tree.map(
            lambda a: a + r.normal(size=a.shape).astype(np.float32) * 0.05,
            tree)
    path = tmp_path / "weights.pt"
    torch.save(trees, path)
    ranks = run_ranks("check_tp_encoder", world, tmp_path, weights=str(path))
    for family, vis in FAMILIES.items():
        d, f = vis["hidden_size"], vis["intermediate_size"]
        for res in ranks:
            assert res[(family, "widths")] == (d // world, f // world,
                                               f // world, d)
        for cls_only in (False, True):
            want = np.asarray(jvis.vision_forward(
                jax.tree.map(jnp.asarray, trees[family]),
                jvis.VisionConfig(**vis), jnp.asarray(trees["pixels"]),
                use_pallas=False, cls_only=cls_only))
            for res in ranks:
                one, split = res[(family, cls_only)]
                assert split.shape == want.shape == (
                    3, 1 if cls_only else 17, d)
                np.testing.assert_allclose(split, one, rtol=ENCODER_TOL,
                                           atol=ENCODER_TOL)
                np.testing.assert_allclose(split, want, rtol=ENCODER_TOL,
                                           atol=ENCODER_TOL)
                np.testing.assert_allclose(one, want, rtol=ENCODER_TOL,
                                           atol=ENCODER_TOL)


def test_tp_decoder_forward_matches_the_replicated_one(tmp_path):
    for r in run_ranks("check_tp_forward", 2, tmp_path):
        assert r["err"] <= 2e-5 and r["round_trip"]
        assert r["heads"] == DEC["embed_dim"] // 2


def test_mesh_saves_and_resumes_as_one_device(tmp_path):
    r0 = run_ranks("check_saves_and_resume", 4, tmp_path,
                   workdir=str(tmp_path))[0]
    assert r0["safetensors_equal"] and r0["state_equal"]
    assert r0["resume_equal"] and r0["resume_meta"] == (1, 2.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_torch_train.py``'s tiny corpus: 8 images, 2 captions."""
    from PIL import Image

    d = tmp_path_factory.mktemp("meshdata")
    os.makedirs(d / "images")
    caps = {}
    for i in range(8):
        name = f"im{i}.jpg"
        Image.new("RGB", (40, 40), (i * 30 % 255, 60, 90)).save(
            d / "images" / name)
        caps[name] = [f"a photo number {i} with things",
                      f"another view of item {i}"]
    (d / "captions.json").write_text(json.dumps(caps))
    return str(d)


def test_train_refuses_what_the_mesh_cannot_take(tmp_path, corpus):
    for r in run_ranks("check_refusals", 2, tmp_path, data_dir=corpus):
        assert "divisible by the mesh data axis (2)" in r["batch"]
        assert "does not match 2 available devices" in r["shape"]
        assert "encoder's 3 heads" in r["encoder_heads"]
        assert "model axis (2)" in r["encoder_heads"]


@pytest.mark.parametrize("shape,cache", [((2, 1), True), ((1, 2), True),
                                         ((1, 2), False)],
                         ids=["dp", "tp", "tp_encoder"])
def test_train_loop_under_the_mesh_repeats_one_device(tmp_path, corpus,
                                                      shape, cache):
    """``train()`` at dropout 0.1 with fused dropout: the same epoch losses
    as on one device, within 1e-5, and the JAX loop's summary keys; without
    the feature cache the encoder runs in the step, split over "model"."""
    import shutil

    for d in ("mesh", "single"):
        shutil.copytree(corpus, tmp_path / d)
    r = run_ranks("check_train_loop", 2, tmp_path,
                  data_dir=str(tmp_path / "mesh"),
                  single_dir=str(tmp_path / "single"), shape=list(shape),
                  cache=cache)[0]
    mesh, single = r["mesh"], r["single"]
    assert mesh["mesh"] == {"data": shape[0], "model": shape[1]}
    assert mesh["param_devices"] == 2
    assert os.path.exists(mesh["best_checkpoint"])
    for a, b in zip(mesh["epochs"], single["epochs"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=1e-5)


if __name__ == "__main__" and sys.argv[1] == "--worker":
    name, rank, world, init, out, kw = sys.argv[2:8]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        result = CHECKS[name](rank, world, **json.loads(kw))
    finally:
        dist.destroy_process_group()
    torch.save(result, out)
