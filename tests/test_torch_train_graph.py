"""The train step replayed from a CUDA graph (``train/steps.py``
``TrainStep``) against the same step run eagerly.

Torch only (no JAX), so the card's tests run without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph.py

Tests marked ``cuda`` capture and replay real graphs on the card and hold
them bit for bit to the eager step. On the CPU the step runs eagerly, and
the tests check the parts of the graphed path that need no capture: the
seeds and scalars it stages, the optimizer's update from them in place,
and the copies of the state in and out.
"""

import numpy as np
import pytest
import torch

from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.ops import attention as tattn
from mit_tpu_torch.ops import dropout_attention as tdrop
from mit_tpu_torch.train import steps as tsteps

VIS = dict(family="vit", image_size=32, patch_size=16, hidden_size=48,
           num_layers=1, num_heads=2, intermediate_size=64, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
# six layers of two 64-wide heads: six fused calls a forward, as the
# 6 x 512 decoder makes
DEC = dict(vocab_size=64, embed_dim=128, num_heads=2, num_layers=6,
           ff_dim=160, max_seq_len=12, dropout=0.1, pad_idx=0)


class _Cfg:
    GRAD_CLIP_VALUE, LEARNING_RATE, WEIGHT_DECAY = 1.0, 3e-3, 0.01
    ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
    WARMUP_STEPS, NUM_EPOCHS = 2, 1


def _model(vis=VIS, **dec):
    return tmodel.ModelConfig("tiny", tvis.VisionConfig(**vis),
                              tdec.DecoderConfig(**dict(DEC, **dec)), "cls")


def _setup(mcfg, device, steps_per_epoch=5):
    params = tmodel.init_model_params(torch.Generator().manual_seed(0), mcfg,
                                      device)
    trainable, frozen = tmodel.split_trainable(params)
    opt, _ = tsteps.make_optimizer(_Cfg, steps_per_epoch)
    return trainable, frozen, opt


def _batch(mcfg, b, device, seed=0, features_dtype=torch.float32):
    """Features (B, 1, H_enc) and tokens of T = max_seq_len - 1; row 0 padded
    after 6 tokens."""
    r = np.random.default_rng(seed)
    t = mcfg.decoder.max_seq_len - 1
    toks = r.integers(4, mcfg.decoder.vocab_size, (b, t + 1))
    toks[:, 0] = 2
    toks[0, 6:] = 0
    return {"features": torch.from_numpy(r.normal(
                size=(b, 1, mcfg.vision.hidden_size)).astype(np.float32)).to(
                device, features_dtype),
            "decoder_input_tokens": torch.from_numpy(toks[:, :-1]).to(device),
            "target_tokens": torch.from_numpy(toks[:, 1:]).to(device)}


def _leaves(state):
    return (tsteps.tree_leaves(state.params)
            + tsteps.tree_leaves(state.opt_state.mu)
            + tsteps.tree_leaves(state.opt_state.nu))


def _assert_same(a, b):
    """Two (state, loss) pairs equal bit for bit."""
    (sa, la), (sb, lb) = a, b
    assert (sa.step, sa.opt_state.count) == (sb.step, sb.opt_state.count)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(sa), _leaves(sb)))


def _run(step, state, batches, n, seed=7, frozen=None):
    out = []
    for i in range(n):
        state, loss = step(state, frozen or {}, batches[i % len(batches)],
                           seed)
        out.append((state, loss))
    return out


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,step", [(7, 0), (7, 1), (0, 5),
                                       (2**31 + 11, 123456)])
def test_staged_seeds_are_the_eager_forwards_draws(monkeypatch, seed, step):
    """The seeds a graphed step stages are, in order, those the eager
    forward's fused calls draw from the host generator of (seed, step)."""
    mcfg = _model()
    trainable, _, _ = _setup(mcfg, "cpu")
    batch = _batch(mcfg, 3, "cpu")
    drawn = []

    def recording(q, k, v, pad_add, seed, *args):
        drawn.append(seed)
        return tdrop.flash_attention_dropout(q, k, v, pad_add, seed, *args)

    monkeypatch.setattr(tattn, "flash_attention_dropout", recording)
    tmodel.forward_from_features(
        trainable, mcfg, batch["features"], batch["decoder_input_tokens"],
        False, tattn.DropoutGenerators.for_step(seed, step, "cpu"),
        torch.float32, True, True)
    assert len(drawn) == mcfg.decoder.num_layers == 6
    assert all(isinstance(x, int) for x in drawn)
    assert drawn == tattn.DropoutGenerators.kernel_seeds(seed, step, 6)


@pytest.mark.parametrize("kw", [{}, dict(remat=True),
                                dict(use_kernel=False)],
                         ids=["kernels", "remat", "plain"])
def test_step_stays_eager_on_the_cpu(kw):
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, "cpu")
    step = tsteps.make_train_step(mcfg, opt, 0, torch.float32,
                                  from_features=True, fused_dropout=True, **kw)
    batches = [_batch(mcfg, 3, "cpu", seed=i) for i in range(2)]
    state = tsteps.init_train_state(trainable, opt)
    _assert_same(_run(step, state, batches, 2)[-1],
                 _run(step.eager, state, batches, 2)[-1])
    assert (step.graph_captures, step.graph_replays, step.eager_steps) == \
        (0, 0, 2)


@pytest.mark.parametrize("shape", [(2, 2, 9, 9), (2, 2, 24, 32)],
                         ids=["hd9", "hd32"])
def test_plain_dropout_refuses_a_seed_tensor(shape):
    """The plain versions take an int seed; a seed tensor, which only the
    kernels read, is refused, not read back or hashed differently."""
    b, h, t, hd = shape
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.normal(size=(b, h, t, hd)).astype(
        np.float32)) for _ in range(3))
    pad = torch.zeros(b, t)
    tensor = torch.tensor(5, dtype=torch.int32)
    assert tdrop.flash_attention_dropout_plain(q, k, v, pad, 5).shape == \
        q.shape
    for attend in (tdrop.flash_attention_dropout_plain,
                   tdrop.flash_attention_dropout):     # plain on the CPU
        with pytest.raises(ValueError, match="kernels alone"):
            attend(q, k, v, pad, tensor)
    with pytest.raises(ValueError, match="kernels alone"):
        tdrop.dump_dropout_mask(b, h, t, t, tensor, 0.3)
    with pytest.raises(ValueError, match="0-dim int32"):
        tdrop.flash_attention_dropout(q, k, v, pad, torch.tensor([5]))


def test_seed_slots_hand_out_the_buffers_views_in_order():
    buffer = torch.tensor([11, 22, 33], dtype=torch.int32)
    slots = tattn.SeedSlots(buffer)
    views = [slots.take() for _ in range(3)]
    assert slots.taken == 3
    assert all(x.dim() == 0 and x.dtype == torch.int32 for x in views)
    buffer.copy_(torch.tensor([4, 5, 6], dtype=torch.int32))
    assert [int(x) for x in views] == [4, 5, 6]    # read when used
    fresh = tattn.SeedSlots(device="cpu")
    assert [int(fresh.take()) for _ in range(2)] == [0, 0]
    assert fresh.taken == 2


@pytest.mark.parametrize("seed,step,count", [(7, 0, 0), (7, 3, 1),
                                             (2**31 + 11, 40, 39)])
def test_staged_words_are_the_steps_seeds_and_scalars(seed, step, count):
    """The words a graphed step stages: the eager forward's six seeds, then
    the f32 bits of the update's step size and bias corrections."""
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, "cpu")
    state = tsteps.init_train_state(trainable, opt)
    state = tsteps.TrainState(step, state.params, state.opt_state._replace(
        count=count))
    words = tsteps.staged_words(opt, seed, state, 6)
    assert words.dtype == np.int32 and words.shape == (9,)
    assert words[:6].tolist() == tattn.DropoutGenerators.kernel_seeds(
        seed, step, 6)
    scalars = words[6:].view(np.float32)
    f32 = np.float32
    assert scalars.tolist() == [
        -f32(opt.schedule(count)), f32(1) - f32(0.9) ** (count + 1),
        f32(1) - f32(0.999) ** (count + 1)]


@pytest.mark.parametrize("count", [0, 1, 4])
def test_update_from_staged_scalars_in_place_is_the_update(count):
    """``Optimizer.update`` reading the staged scalars from 0-dim f32
    tensors and writing params, mu and nu in place equals the update that
    makes them from ``count``, bit for bit."""
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, "cpu")
    g = torch.Generator().manual_seed(count)
    rand = lambda p: torch.randn(p.shape, generator=g)
    grads = tsteps.tree_map(rand, trainable)
    state = tsteps.OptState(count, tsteps.tree_map(rand, trainable),
                            tsteps.tree_map(lambda p: rand(p).abs(),
                                            trainable))
    want_p, want_s = opt.update(grads, state, trainable)
    clone = lambda t: tsteps.tree_map(torch.clone, t)
    params, held = clone(trainable), tsteps.OptState(count, clone(state.mu),
                                                     clone(state.nu))
    staged = torch.from_numpy(tsteps.staged_words(
        opt, 7, tsteps.TrainState(0, params, held), 0))
    got_p, got_s = opt.update(grads, held, params,
                              scalars=tuple(staged.view(torch.float32)),
                              in_place=True)
    assert got_s.count == want_s.count == count + 1
    for got, want, into in ((got_p, want_p, params), (got_s.mu, want_s.mu,
                                                      held.mu),
                            (got_s.nu, want_s.nu, held.nu)):
        for x, y, z in zip(*map(tsteps.tree_leaves, (got, want, into))):
            assert x is z and torch.equal(x, y)


def _graph_step(mcfg, opt):
    return tsteps.make_train_step(mcfg, opt, 0, torch.float32,
                                  from_features=True, fused_dropout=True)


def test_copy_in_skips_the_state_it_returned_last():
    """The static buffers take a state's values, except the state the step
    returned last, whose values they already hold."""
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, "cpu")
    step = _graph_step(mcfg, opt)
    state = tsteps.init_train_state(trainable, opt)
    step._hold(state)
    assert all(map(torch.equal, step._static, _leaves(state)))
    assert not any(x is y for x, y in zip(step._static, _leaves(state)))
    for x in step._static:                   # what a replay writes
        x.add_(1.0)
    returned, _ = step._release(state, torch.zeros(()))
    for x in step._static:
        x.mul_(2.0)       # not the values of ``returned`` any more
    step._hold(returned)                     # skipped: the buffers hold it
    assert not any(map(torch.equal, step._static, _leaves(returned)))
    step._hold(state)                        # another state is copied in
    assert all(map(torch.equal, step._static, _leaves(state)))


def test_copies_out_are_never_written_again():
    """A released state and loss are fresh tensors: step and count move on
    by one, and later writes to the buffers leave them as they were."""
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, "cpu")
    step = _graph_step(mcfg, opt)
    state = tsteps.init_train_state(trainable, opt)
    step._hold(state)
    loss = torch.tensor(2.5)
    returned, out = step._release(state, loss)
    assert (returned.step, returned.opt_state.count) == (1, 1)
    assert all(map(torch.equal, tsteps.tree_leaves(returned.params),
                   tsteps.tree_leaves(state.params)))
    kept = [x.clone() for x in _leaves(returned)]
    for x in step._static + [loss]:
        x.add_(1.0)
    assert all(map(torch.equal, _leaves(returned), kept))
    assert float(out) == 2.5
    assert not any(x.data_ptr() == y.data_ptr()
                   for x in _leaves(returned) for y in step._static)


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
VIT_B = dict(family="vit", image_size=224, patch_size=16, hidden_size=768,
             num_layers=12, num_heads=12, intermediate_size=3072,
             hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
             ln_pre=False, ln_post=True)
# the decoder of the benchmark's training cell: 6 x 512, 8 heads, T 99
DEC_6X512 = dict(vocab_size=10000, embed_dim=512, num_heads=8, ff_dim=2048,
                 max_seq_len=100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,b,fused", [
    ("6x512", 32, True), ("6x512", 32, False), ("tiny", 3, True)])
def test_graphed_step_equals_eager_on_card(cuda, shape, b, fused):
    """Five bf16 steps from bf16 features, dropout 0.1: loss, params, mu and
    nu of the graphed step equal the eager step's bit for bit."""
    mcfg = _model(VIT_B, **DEC_6X512) if shape == "6x512" else _model()
    trainable, _, opt = _setup(mcfg, cuda)
    step = tsteps.make_train_step(mcfg, opt, 0, torch.bfloat16,
                                  from_features=True, fused_dropout=fused)
    batches = [_batch(mcfg, b, cuda, seed=i, features_dtype=torch.bfloat16)
               for i in range(2)]
    state = tsteps.init_train_state(trainable, opt)
    graphed = _run(step, state, batches, 5)
    eager = _run(step.eager, state, batches, 5)
    torch.cuda.synchronize()
    for got, want in zip(graphed, eager):
        _assert_same(got, want)
    assert (step.graph_captures, step.graph_replays, step.eager_steps) == \
        (1, 5, 0)


@pytest.mark.cuda
def test_graphed_step_keeps_the_states_it_returned_on_card(cuda):
    mcfg = _model(VIT_B, **DEC_6X512)
    trainable, _, opt = _setup(mcfg, cuda)
    step = tsteps.make_train_step(mcfg, opt, 0, torch.bfloat16,
                                  from_features=True, fused_dropout=True)
    batches = [_batch(mcfg, 32, cuda, seed=i, features_dtype=torch.bfloat16)
               for i in range(2)]
    first, loss = step(tsteps.init_train_state(trainable, opt), {},
                       batches[0], 7)
    kept = [x.clone() for x in _leaves(first)] + [loss.clone()]
    _run(step, first, batches, 3)
    torch.cuda.synchronize()
    assert all(map(torch.equal, _leaves(first) + [loss], kept))


@pytest.mark.cuda
def test_graphed_step_resumes_on_card(cuda, tmp_path):
    """2 steps, save, restore, 1 step through the graphed step == 3 steps
    straight."""
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.train import checkpoint as tckpt

    mcfg = _model(VIT_B, **DEC_6X512)
    trainable, _, opt = _setup(mcfg, cuda)
    batches = [_batch(mcfg, 32, cuda, seed=i, features_dtype=torch.bfloat16)
               for i in range(3)]
    make = lambda: tsteps.make_train_step(mcfg, opt, 0, torch.bfloat16,
                                          from_features=True,
                                          fused_dropout=True)
    straight = _run(make(), tsteps.init_train_state(trainable, opt), batches,
                    3)
    state = _run(make(), tsteps.init_train_state(trainable, opt), batches,
                 2)[-1][0]
    tckpt.save_train_state(str(tmp_path), state, epoch=1, best_val_loss=1.5,
                           cfg=Config())
    restored, _, _ = tckpt.restore_train_state(
        str(tmp_path), tsteps.init_train_state(trainable, opt))
    step = make()
    resumed = step(restored, {}, batches[2], 7)
    torch.cuda.synchronize()
    _assert_same(resumed, straight[-1])
    assert step.graph_captures == 1


@pytest.mark.cuda
def test_graph_counters_on_card(cuda):
    """The first batch shape captures the graph and replays it; another
    shape runs eagerly, and the first replays again; remat and the plain
    path count as eager steps; every result equals the eager step's."""
    mcfg = _model()
    trainable, _, opt = _setup(mcfg, cuda)
    state = tsteps.init_train_state(trainable, opt)
    make = lambda **kw: tsteps.make_train_step(
        mcfg, opt, 0, torch.bfloat16, from_features=True, fused_dropout=True,
        **kw)
    step = make()
    for b in (3, 3, 2, 3):
        batch = _batch(mcfg, b, cuda, seed=b)
        _assert_same(step(state, {}, batch, 7), step.eager(state, {}, batch,
                                                            7))
    assert (step.graph_captures, step.graph_replays, step.eager_steps) == \
        (1, 3, 1)
    for kw in (dict(remat=True), dict(use_kernel=False)):
        other = make(**kw)
        other(state, {}, _batch(mcfg, 3, cuda), 7)
        assert (other.graph_captures, other.graph_replays,
                other.eager_steps) == (0, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["float", "int8"])
def test_graphed_step_from_pixels_equals_eager_on_card(cuda, quant):
    """From pixels with the frozen ViT-B/16 encoder (float, or int8 with
    its own kernels) in the step: three graphed bf16 steps equal the eager
    ones bit for bit."""
    mcfg = _model(VIT_B, **DEC_6X512)
    trainable, frozen, opt = _setup(mcfg, cuda)
    if quant == "int8":
        frozen = {"encoder": tvis.quantize_vision_params(frozen["encoder"],
                                                         mcfg.vision)}
    step = tsteps.make_train_step(mcfg, opt, 0, torch.bfloat16,
                                  fused_dropout=True)
    r = np.random.default_rng(5)
    batches = []
    for i in range(2):
        batch = _batch(mcfg, 4, cuda, seed=i)
        batch["images"] = torch.from_numpy(r.normal(
            size=(4, 3, 224, 224)).astype(np.float32)).to(cuda)
        batches.append(batch)
    state = tsteps.init_train_state(trainable, opt)
    graphed = _run(step, state, batches, 3, frozen=frozen)
    eager = _run(step.eager, state, batches, 3, frozen=frozen)
    torch.cuda.synchronize()
    for got, want in zip(graphed, eager):
        _assert_same(got, want)
    assert (step.graph_captures, step.graph_replays) == (1, 3)
