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
from mit_tpu_torch.ops.attention import DropoutGenerators


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

    def update(self, grads: dict, state: OptState, params: dict):
        """(params', state') from the step's gradients."""
        g = tree_leaves(grads)
        if self.clip:
            norm = torch.sqrt(sum((x.float() * x.float()).sum() for x in g))
            trigger = norm < self.clip
            g = [torch.where(trigger, x, (x / norm) * self.clip) for x in g]
        f32 = np.float32
        count = state.count + 1
        bias_correction = lambda b: torch.full(
            (), float(f32(1) - f32(b) ** count), dtype=torch.float32,
            device=g[0].device)
        bc1, bc2 = bias_correction(self.b1), bias_correction(self.b2)
        step_size = -float(self.schedule(state.count))    # f32, exactly
        mu, nu, new = [], [], []
        for x, m, v, p in zip(g, tree_leaves(state.mu), tree_leaves(state.nu),
                              tree_leaves(params)):
            m = (1 - self.b1) * x + self.b1 * m
            v = (1 - self.b2) * (x * x) + self.b2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            new.append(p + step_size * u)
            mu.append(m)
            nu.append(v)
        return (tree_unflatten(params, new),
                OptState(count, tree_unflatten(params, mu),
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
):
    """``step(state, frozen, batch, seed) -> (state', loss)``.

    ``batch`` holds ``images`` (or ``features``), ``decoder_input_tokens``
    and ``target_tokens`` on the device; ``frozen`` is the encoder subtree
    ({} when training from features); ``seed`` an int, the run's dropout
    seed. ``fused_dropout`` sends the decoder self-attention's dropout
    through the hash-mask kernels. ``use_kernel=False`` runs every kernel's
    plain version instead, for comparison on the card.
    """
    forward = forward_from_features if from_features else model_forward
    inputs = "features" if from_features else "images"

    def step(state: TrainState, frozen: dict, batch: dict, seed: int):
        device = batch["decoder_input_tokens"].device
        gens = DropoutGenerators.for_step(seed, state.step, device)
        params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        logits = forward(
            merge_params(params, frozen), mcfg, batch[inputs],
            batch["decoder_input_tokens"], False, gens, compute_dtype,
            use_kernel, fused_dropout,
        )
        loss = masked_cross_entropy(logits, batch["target_tokens"], pad_id)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = _zero_pad_row_grad(tree_unflatten(params, list(grads)),
                                   mcfg.decoder.pad_idx)
        with torch.no_grad():
            new, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        return TrainState(state.step + 1, new, opt_state), loss.detach()

    return step


def make_eval_step(
    mcfg: ModelConfig,
    pad_id: int,
    compute_dtype=torch.bfloat16,
    from_features: bool = False,
    use_kernel: bool = True,
):
    """``step(params, batch) -> (sum_nll, token_count)``, both on the
    device, for a token-weighted epoch mean."""
    forward = forward_from_features if from_features else model_forward
    inputs = "features" if from_features else "images"

    @torch.no_grad()
    def step(params: dict, batch: dict):
        logits = forward(params, mcfg, batch[inputs],
                         batch["decoder_input_tokens"],
                         compute_dtype=compute_dtype, use_kernel=use_kernel)
        return _nll_sums(logits, batch["target_tokens"], pad_id)

    return step
