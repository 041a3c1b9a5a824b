"""Training and eval steps (port of ``mit_tpu/train/steps.py``).

One step: forward (frozen encoder in-graph, or cached encoder features) →
PAD-masked cross entropy → gradients of the trainable projection and
decoder → the PAD embedding row's gradient zeroed → global-norm clip →
AdamW with the warmup/decay schedule. The optimizer is written out here and
held to optax's update (``optax.chain(clip_by_global_norm, adamw)``), which
differs from ``torch.optim.AdamW`` plus ``clip_grad_norm_``:

- the clip multiplies by ``max_norm / norm`` (as ``(g / norm) * max_norm``)
  only when ``norm >= max_norm``, with no 1e-6 added to the norm;
- the learning rate is the schedule's value at the update count before the
  update, so the first warmup step has lr 0;
- weight decay applies to every leaf, the PAD row of the embedding too;
- the bias corrections use the count after the update, ``count + 1``.

Steps are functional, as in JAX: a step returns a new :class:`TrainState`
and leaves its argument intact. The loss stays on the device; nothing in a
step reads a value back to the host. Each step's dropout streams are a
function of (seed, step) (:meth:`DropoutGenerators.for_step`).

On one CUDA device (no mesh, no remat, the kernels) the step replays its
body from a CUDA graph, captured in its first call for the signature of
the batch (shapes, dtypes, device) and the frozen tensors; a call of
another signature, like any other call, runs the body eagerly. The
graph reads its inputs from static buffers that each call fills first: the
state (unless it is the state the step returned last, which they already
hold), the batch, the fused kernel's seeds (drawn on the host as the eager
forward draws them), the optimizer's step size and bias corrections (the
same f32 values), and the device generator, reseeded so that the replay
draws the eager step's Bernoulli masks. The graph updates the state in
place; each call returns copies, so a state it returned is never written
again. Graphed and eager steps are equal bit for bit.

Under a device mesh (``mesh``, the distributed form of
``parallel.mesh``) a step runs this rank's rows of the batch and its shard
of the parameters, and equals the single-device step:

- the loss is the global token mean: each rank backpropagates its summed
  NLL over the global count of non-PAD targets (one sum over "data"), and
  the gradients are then summed over "data" (one flat buffer);
- the clip's global norm counts each leaf sharded over "model" once over
  "model" (one sum of its squares) and each replicated leaf once;
- dropout draws the single-device masks (``ops/attention.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mit_tpu_torch.models.model import (
    ModelConfig,
    forward_from_features,
    merge_params,
    model_forward,
)
from mit_tpu_torch.ops.attention import DropoutGenerators, SeedSlots
from mit_tpu_torch.parallel.collectives import all_reduce_sum
from mit_tpu_torch.utils.cuda_graphs import GraphHolder, capture
from mit_tpu_torch.utils.profiling import span


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """Mean cross entropy over non-PAD targets (``nn.CrossEntropyLoss(
    ignore_index=PAD)``): their summed NLL over their count (at least 1)."""
    total, count = _nll_sums(logits, targets, pad_id)
    return total / torch.clamp(count, min=1.0)


def _nll_sums(logits, targets, pad_id):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    mask = (targets != pad_id).float()
    return (nll * mask).sum(), mask.sum()


# ----------------------------------------------------------------------
def _linear_schedule(init: float, end: float, steps: int):
    """``optax.linear_schedule`` in float32."""
    f32 = np.float32

    def schedule(count: int) -> np.float32:
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        return f32(init - end) * frac + f32(end)

    return schedule


def make_schedule(cfg, steps_per_epoch: Optional[int] = None) -> Callable:
    """The learning rate at an update count: linear 0 → lr over
    ``WARMUP_STEPS``, then linear lr → 0 at the last step of
    ``NUM_EPOCHS`` (``optax.join_schedules``); constant without warmup."""
    lr = cfg.LEARNING_RATE
    if not (cfg.WARMUP_STEPS > 0 and steps_per_epoch):
        return lambda count: np.float32(lr)
    warm = cfg.WARMUP_STEPS
    total = steps_per_epoch * cfg.NUM_EPOCHS
    up = _linear_schedule(0.0, lr, warm)
    down = _linear_schedule(lr, 0.0, max(1, total - warm))
    return lambda count: up(count) if count < warm else down(count - warm)


class OptState(NamedTuple):
    count: int          # updates applied
    mu: dict            # first moments, f32, the params' tree
    nu: dict            # second moments


class Optimizer(NamedTuple):
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay))``; ``clip`` 0 or None skips the clip."""

    schedule: Callable
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip: Optional[float]

    def init(self, params: dict) -> OptState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return OptState(0, tree_map(zeros, params), tree_map(zeros, params))

    def scalars(self, count: int) -> tuple:
        """(step size, first and second bias corrections) of the update
        after ``count`` updates, as f32: the schedule's rate at ``count``,
        negated, and ``1 - b ** (count + 1)``."""
        f32 = np.float32
        return (-f32(self.schedule(count)),
                f32(1) - f32(self.b1) ** (count + 1),
                f32(1) - f32(self.b2) ** (count + 1))

    def update(self, grads: dict, state: OptState, params: dict, norm=None,
               scalars=None, in_place: bool = False):
        """(params', state') from the step's gradients; ``norm``, when given,
        is their global norm (a mesh rank holds only some of them).

        ``scalars``: :meth:`scalars` as 0-dim f32 device tensors, read when
        the update runs (a CUDA graph's inputs); None makes them here from
        ``state.count``. ``in_place`` writes params', mu' and nu' into the
        tensors of ``params`` and ``state``."""
        g = tree_leaves(grads)
        if self.clip:
            if norm is None:
                norm = torch.sqrt(sum((x.float() * x.float()).sum()
                                      for x in g))
            trigger = norm < self.clip
            g = [torch.where(trigger, x, (x / norm) * self.clip) for x in g]
        if scalars is None:
            step_size, bc1, bc2 = self.scalars(state.count)
            fill = lambda c: torch.full((), float(c), dtype=torch.float32,
                                        device=g[0].device)
            # f32 values exactly; a Python scalar multiplies in f32
            step_size, bc1, bc2 = float(step_size), fill(bc1), fill(bc2)
        else:
            step_size, bc1, bc2 = scalars
        mu, nu, new = [], [], []
        for x, m, v, p in zip(g, tree_leaves(state.mu), tree_leaves(state.nu),
                              tree_leaves(params)):
            into = (m, v, p) if in_place else (None, None, None)
            m = torch.add((1 - self.b1) * x, self.b1 * m, out=into[0])
            v = torch.add((1 - self.b2) * (x * x), self.b2 * v, out=into[1])
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            new.append(torch.add(p, step_size * u, out=into[2]))
            mu.append(m)
            nu.append(v)
        return (tree_unflatten(params, new),
                OptState(state.count + 1, tree_unflatten(params, mu),
                         tree_unflatten(params, nu)))


def make_optimizer(cfg, steps_per_epoch: Optional[int] = None):
    """(optimizer, schedule) from a ``mit_tpu_torch.config.Config``, as
    ``mit_tpu.train.steps.make_optimizer``."""
    schedule = make_schedule(cfg, steps_per_epoch)
    clip = cfg.GRAD_CLIP_VALUE if cfg.GRAD_CLIP_VALUE and \
        cfg.GRAD_CLIP_VALUE > 0 else None
    return Optimizer(schedule, cfg.ADAM_BETA1, cfg.ADAM_BETA2, cfg.ADAM_EPS,
                     cfg.WEIGHT_DECAY, clip), schedule


class TrainState(NamedTuple):
    step: int                   # updates applied, on the host
    params: dict                # trainable subtree (projection + decoder)
    opt_state: OptState


def init_train_state(trainable_params: dict, optimizer: Optimizer) -> TrainState:
    params = tree_map(lambda p: p.detach().clone().float(), trainable_params)
    return TrainState(0, params, optimizer.init(params))


def _zero_pad_row_grad(grads: dict, pad_idx: int) -> dict:
    """Freeze the PAD embedding row, torch ``padding_idx`` semantics: its
    gradient is zeroed before the clip."""
    grads["decoder"]["token_embedding"][pad_idx] = 0.0
    return grads


def make_train_step(
    mcfg: ModelConfig,
    optimizer: Optimizer,
    pad_id: int,
    compute_dtype=torch.bfloat16,
    from_features: bool = False,
    fused_dropout: bool = False,
    use_kernel: bool = True,
    remat: bool = False,
    mesh=None,
):
    """``step(state, frozen, batch, seed) -> (state', loss)``.

    ``batch`` holds ``images`` (or ``features``), ``decoder_input_tokens``
    and ``target_tokens`` on the device; ``frozen`` is the encoder subtree
    ({} when training from features); ``seed`` an int, the run's dropout
    seed. ``fused_dropout`` sends the decoder self-attention's dropout
    through the hash-mask kernels. ``use_kernel=False`` runs every kernel's
    plain version instead, for comparison on the card. ``remat``
    recomputes each decoder layer in the backward (the same loss and
    gradients, less activation memory); as in the JAX package, no config
    field and no ``train()`` argument turns it on.

    ``mesh``: a distributed ``parallel.mesh.Mesh``; ``state`` then holds
    this rank's shard (``shard_train_state``), ``frozen`` this rank's shard
    of the float encoder (``shard_tree`` with ``vision_param_specs(tp=
    True)``, which then runs split over "model") or the replicated int8 one,
    ``batch`` this rank's rows (``shard_batch``), and the returned loss is
    the global one.

    The step is a :class:`TrainStep`: a batch on a CUDA device replays a
    CUDA graph where neither ``mesh`` nor ``remat`` is set and
    ``use_kernel`` is (the module's docstring); ``step.eager`` is the same
    step run eagerly, and ``step.graph_captures``, ``.graph_replays`` and
    ``.eager_steps`` count the calls by the way they ran.
    """
    if mcfg.language_model != "decoder":
        raise NotImplementedError(
            "make_train_step trains the 'decoder' language model only, not "
            f"{mcfg.language_model!r}")
    forward = forward_from_features if from_features else model_forward
    inputs = "features" if from_features else "images"
    data_group = (mesh.group("data") if mesh is not None
                  and mesh.shape["data"] > 1 else None)

    def body(state: TrainState, frozen: dict, batch: dict, streams: Callable,
             scalars=None, in_place: bool = False):
        """The step from the dropout streams that ``streams()`` makes;
        ``scalars`` and ``in_place`` as :meth:`Optimizer.update`'s."""
        with span("mit.train.forward"):
            gens = streams()
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state.params)
            shard = (mesh.step_shard(batch["decoder_input_tokens"].shape[0])
                     if mesh is not None else None)
            logits = forward(
                merge_params(params, frozen), mcfg, batch[inputs],
                batch["decoder_input_tokens"], False, gens, compute_dtype,
                use_kernel, fused_dropout, remat, shard,
            )
            if mesh is None:
                loss = objective = masked_cross_entropy(
                    logits, batch["target_tokens"], pad_id)
            else:
                total, count = _nll_sums(logits, batch["target_tokens"],
                                         pad_id)
                sums = torch.stack([total.detach(), count])
                if data_group is not None:
                    all_reduce_sum(sums, data_group)
                denom = torch.clamp(sums[1], min=1.0)
                objective, loss = total / denom, sums[0] / denom
        with span("mit.train.backward"):
            leaves = tree_leaves(params)
            grads = list(torch.autograd.grad(objective, leaves,
                                             allow_unused=True,
                                             materialize_grads=True))
            if data_group is not None:
                grads = _sum_over(grads, data_group)
            grads = _zero_pad_row_grad(tree_unflatten(params, grads),
                                       mcfg.decoder.pad_idx)
        with span("mit.train.optimizer"), torch.no_grad():
            norm = (_global_norm(grads, mesh) if mesh is not None
                    and optimizer.clip else None)
            new, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params, norm, scalars,
                                              in_place)
        return TrainState(state.step + 1, new, opt_state), loss.detach()

    def eager(state: TrainState, frozen: dict, batch: dict, seed: int):
        device = batch["decoder_input_tokens"].device
        return body(state, frozen, batch, lambda: DropoutGenerators.for_step(
            seed, state.step, device))

    return TrainStep(eager, body, optimizer,
                     (inputs, "decoder_input_tokens", "target_tokens"),
                     graphs=mesh is None and not remat and use_kernel)


def _state_leaves(state: TrainState) -> list:
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu))


def _state_of(state: TrainState, leaves: list, step: int,
              count: int) -> TrainState:
    """A state of ``state``'s trees over ``leaves`` (params, mu, nu)."""
    n = len(leaves) // 3
    tree = lambda i: tree_unflatten(state.params, leaves[i * n:(i + 1) * n])
    return TrainState(step, tree(0), OptState(count, tree(1), tree(2)))


def staged_words(optimizer: Optimizer, seed: int, state: TrainState,
                 seeds: int) -> np.ndarray:
    """The int32 words a graphed step stages for ``state``'s step: the
    ``seeds`` fused calls' seeds (:meth:`DropoutGenerators.kernel_seeds`),
    then the bits of the f32 step size and bias corrections
    (:meth:`Optimizer.scalars`)."""
    return np.concatenate([
        np.asarray(DropoutGenerators.kernel_seeds(seed, state.step, seeds),
                   np.int32),
        np.asarray(optimizer.scalars(state.opt_state.count),
                   np.float32).view(np.int32)])


class _Graph(NamedTuple):
    """The captured step and the buffers it reads besides the state."""

    graph: torch.cuda.CUDAGraph
    loss: torch.Tensor          # the loss the replay writes
    batch: dict                 # the batch, by key
    staged: torch.Tensor        # int32: :func:`staged_words`
    seeds: int                  # fused calls, each reading one seed
    generator: torch.Generator  # the device stream of the Bernoulli masks
    frozen: list                # the frozen leaves it read, kept alive


class TrainStep(GraphHolder):
    """The train step that :func:`make_train_step` returns: a CUDA graph
    of the step's body, captured for the signature of its first call and
    replayed for every call of that signature where the step allows it,
    ``eager`` otherwise (the rule of :mod:`mit_tpu_torch.utils.cuda_graphs`;
    ``eager_steps`` counts the calls that ran ``eager``)."""

    def __init__(self, eager: Callable, body: Callable, optimizer: Optimizer,
                 keys: tuple, graphs: bool):
        super().__init__()
        self.eager = eager
        self._body, self._optimizer, self._keys = body, optimizer, keys
        self._graphs_allowed = graphs
        self._static = None     # the state's leaves: params, mu, nu
        self._static_state = None  # the state whose values they hold

    def __call__(self, state: TrainState, frozen: dict, batch: dict,
                 seed: int):
        device = batch[self._keys[1]].device
        graph = self.held_for(
            self._signature(frozen, batch, device),
            lambda: self._capture_graph(state, frozen, batch, device))
        if graph is None:
            self.eager_steps += 1
            return self.eager(state, frozen, batch, seed)
        with span("mit.train.stage"):
            self._hold(state)
            for k, buf in graph.batch.items():
                buf.copy_(batch[k], non_blocking=True)
            graph.generator.manual_seed(
                DropoutGenerators.step_seeds(seed, state.step)[0])
            # fresh pinned memory each call: the copy runs after the host
            # has moved on
            graph.staged.copy_(torch.from_numpy(staged_words(
                self._optimizer, seed, state, graph.seeds)).pin_memory(),
                non_blocking=True)
        with span("mit.train.replay"):
            self.replay(graph.graph)
            return self._release(state, graph.loss)

    def _signature(self, frozen: dict, batch: dict, device):
        """The graph's key for this call, None where it runs eagerly."""
        if not (self._graphs_allowed and device.type == "cuda") or any(
                batch[k].device != device for k in self._keys):
            return None
        return (tuple((tuple(batch[k].shape), batch[k].dtype)
                      for k in self._keys), device,
                tuple(map(id, tree_leaves(frozen))))

    def _hold(self, state: TrainState) -> None:
        """The static buffers take ``state``'s values, unless they hold
        them already."""
        if state is self._static_state:
            return
        leaves = _state_leaves(state)
        if self._static is None:
            self._static = [torch.empty_like(x) for x in leaves]
        torch._foreach_copy_(self._static, leaves)
        self._static_state = state

    def _release(self, state: TrainState, loss: torch.Tensor) -> tuple:
        """(the state after ``state``, the loss) as fresh copies of the
        static buffers, which a later replay leaves alone; the buffers
        hold it."""
        copies = [torch.empty_like(x) for x in self._static]
        torch._foreach_copy_(copies, self._static)
        self._static_state = _state_of(state, copies, state.step + 1,
                                       state.opt_state.count + 1)
        return self._static_state, loss.clone()

    def _capture_graph(self, state: TrainState, frozen: dict, batch: dict,
                       device) -> _Graph:
        """Capture the body over the static state, a copy of the batch, the
        seeds' slots and the scalars, updating the state in place. Its
        warm-up counts the fused calls' seeds and updates nothing in place;
        the words they and the scalars are staged in are made after it."""
        self._hold(state)
        static = _state_of(state, self._static, state.step,
                           state.opt_state.count)
        inputs = {k: batch[k].clone() for k in self._keys}
        generator = torch.Generator(device=device)
        counted = SeedSlots(device=device)
        staged = []

        def run():
            if not staged:          # the warm-up
                loss = self._body(static, frozen, inputs, lambda:
                                  DropoutGenerators(generator, None,
                                                    counted))[1]
                staged.append(torch.zeros(counted.taken + 3,
                                          dtype=torch.int32, device=device))
                return loss
            slots = SeedSlots(staged[0][:counted.taken])
            scalars = tuple(staged[0][counted.taken:].view(torch.float32))
            return self._body(static, frozen, inputs, lambda:
                              DropoutGenerators(generator, None, slots),
                              scalars, True)[1]

        graph, loss = capture(run, device, generator=generator)
        self.graph_captures += 1
        return _Graph(graph, loss, inputs, staged[0], counted.taken,
                      generator, tree_leaves(frozen))


def _sum_over(tensors: list, group) -> list:
    """The tensors summed over ``group``, through one flat buffer."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = all_reduce_sum(_flatten_dense_tensors(tensors), group)
    return list(_unflatten_dense_tensors(flat, tensors))


def _global_norm(grads: dict, mesh) -> torch.Tensor:
    """The norm of the whole gradient from a rank's shard of it: the squares
    of the leaves split over "model" summed over "model", the replicated
    leaves' counted once."""
    from mit_tpu_torch.parallel.mesh import model_param_specs

    split, whole = [], []
    tree_map(lambda g, s: (split if "model" in s else whole).append(
        (g.float() * g.float()).sum()),
        grads, model_param_specs(grads, mesh.shape["model"] > 1))
    sq = sum(whole)
    if split:
        sq = sq + all_reduce_sum(sum(split), mesh.group("model"))
    return torch.sqrt(sq)


def make_eval_step(
    mcfg: ModelConfig,
    pad_id: int,
    compute_dtype=torch.bfloat16,
    from_features: bool = False,
    use_kernel: bool = True,
    mesh=None,
):
    """``step(params, batch) -> (sum_nll, token_count)``, both on the
    device, for a token-weighted epoch mean. Under ``mesh`` (distributed)
    ``params`` are this rank's shard (the encoder's as in
    :func:`make_train_step`), ``batch`` its rows, and the sums this rank's:
    the caller sums them over "data"."""
    forward = forward_from_features if from_features else model_forward
    inputs = "features" if from_features else "images"

    @torch.no_grad()
    def step(params: dict, batch: dict):
        tokens = batch["decoder_input_tokens"]
        shard = (mesh.step_shard(tokens.shape[0]) if mesh is not None
                 else None)
        logits = forward(params, mcfg, batch[inputs], tokens,
                         compute_dtype=compute_dtype, use_kernel=use_kernel,
                         shard=shard)
        return _nll_sums(logits, batch["target_tokens"], pad_id)

    return step
