"""Device mesh and sharding rules (port of ``mit_tpu/parallel/mesh.py``).

A logical ("data", "model") mesh, with the JAX package's strategies:

- **DP**: the batch splits over "data", every rank holds all parameters,
  and the gradients are summed over "data";
- **TP**: the decoder's attention heads and FFN hidden columns split over
  "model", Megatron's way (column-parallel ``wq/wk/wv/w1`` and their biases,
  row-parallel ``wo/w2``), so each sublayer ends in one sum over "model".
  A frozen float encoder in the step splits the same way
  (:func:`vision_param_specs`); an int8 one is replicated.

What differs from JAX. There, one program runs over every device and
GSPMD inserts the collectives from sharding annotations. Here training
runs one process a device (``torchrun``), each process holds its own
shard, and the collectives are written out (``parallel/collectives.py``): the
gradient sum over "data", the two Megatron operators over "model", the
loss's global token count and the clip's global norm. The groups come from
``torch.distributed.device_mesh.init_device_mesh`` with the axis names
("data", "model"). So a mesh comes in two forms:

- **distributed** (:func:`init_distributed_mesh`): this process's rank,
  coordinates, device and the two process groups. Training runs on it, and
  the tree and batch functions (:func:`shard_tree`, :func:`gather_tree`,
  :func:`shard_batch`, :func:`replicate`, the train-state pair) take only
  this form: each gives this rank's part;
- **single-process** (:func:`create_mesh`): an explicit (data, model) array
  of ``torch.device`` and nothing else. The service drives its "data"
  devices from one process this way, and shards its slots itself.

A spec is a tuple with one entry a dimension: "model" where that dimension
splits over the model axis, "data" over the data axis, None where it does
not split (the JAX package's ``PartitionSpec``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

AXES = ("data", "model")


def P(*axes) -> tuple:
    """A spec: the mesh axis, or None, for each dimension."""
    return tuple(axes)


class Mesh:
    """A ("data", "model") mesh.

    ``devices`` is the (data, model) array of ``torch.device`` of the
    single-process form; the distributed form holds ``ranks`` (the global
    rank at each coordinate), this process's ``coords``, ``device`` and the
    ``torch.distributed`` group of each axis (``group(axis)``)."""

    def __init__(self, devices=None, ranks=None, coords=None, device=None,
                 groups=None):
        grid = devices if devices is not None else ranks
        self.devices = devices
        self.ranks = ranks
        self.coords = coords
        self.device = device
        self._groups = groups or {}
        d, m = np.shape(grid)
        self.shape = {"data": d, "model": m}

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        """This process's index along ``axis`` (distributed form)."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        """The process group of ``axis`` that holds this process."""
        return self._groups[axis]

    def step_shard(self, local_batch: int):
        """The :class:`~mit_tpu_torch.parallel.collectives.Shard` of this
        rank's part of a step over ``local_batch`` rows (distributed form)."""
        from mit_tpu_torch.parallel.collectives import Shard

        d, m = self.shape["data"], self.shape["model"]
        return Shard(local_batch * d, self.index("data") * local_batch, m,
                     self.index("model"), self.group("model") if m > 1 else None)


def resolve_shape(mesh_shape: Tuple[int, int], n: int) -> Tuple[int, int]:
    """(data, model) over ``n`` devices; ``-1`` infers that axis from the
    device count, as a reshape does."""
    d, m = mesh_shape
    if d == -1 and m == -1:
        raise ValueError("At most one mesh axis may be -1.")
    if d == -1:
        d = n // m
    if m == -1:
        m = n // d
    if d * m != n:
        raise ValueError(
            f"Mesh shape {(d, m)} does not match {n} available devices."
        )
    return d, m


def create_mesh(mesh_shape: Tuple[int, int] = (-1, 1), devices=None) -> Mesh:
    """The single-process form over ``devices`` (default: every CUDA device,
    else the CPU): the (data, model) array of devices."""
    if devices is None:
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(n)] if n
                   else [torch.device("cpu")])
    devices = [torch.device(x) for x in devices]
    d, m = resolve_shape(mesh_shape, len(devices))
    arr = np.empty((d, m), dtype=object)
    for i, dev in enumerate(devices):
        arr[i // m, i % m] = dev
    return Mesh(devices=arr)


def rank_device(device=None) -> torch.device:
    """This process's device: ``device`` when given (it then holds for
    every rank), else ``cuda:LOCAL_RANK``, which must exist."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no CUDA device ({n} visible); pass a "
            "device (--device) to put every rank on it")
    return torch.device("cuda", local)


def default_backend(device) -> str:
    """``nccl`` for CUDA devices, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed_mesh(mesh_shape: Tuple[int, int], device,
                          backend: Optional[str] = None,
                          init_method: Optional[str] = None,
                          rank: Optional[int] = None,
                          world_size: Optional[int] = None) -> Mesh:
    """The distributed form for this process, on ``device``.

    Initializes the default process group with ``backend`` (default
    :func:`default_backend`) unless it is up; ``init_method``, ``rank`` and
    ``world_size`` default to the environment ``torchrun`` sets. A backend
    that fails to initialize raises: nothing falls back to another."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(backend or default_backend(device), **kw)
    d, m = resolve_shape(mesh_shape, dist.get_world_size())
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, (d, m), mesh_dim_names=AXES)
    return Mesh(ranks=dm.mesh.cpu().numpy(), coords=tuple(dm.get_coordinate()),
                device=device, groups={a: dm.get_group(a) for a in AXES})


# ----------------------------------------------------------------------
# PartitionSpec rules
# ----------------------------------------------------------------------
def decoder_param_specs(tp: bool) -> dict:
    """Specs of the decoder tree (``models/decoder.py``'s layout). With
    ``tp``: heads column-parallel (``wq/wk/wv`` and their biases), the out
    projection row-parallel; FFN ``w1/b1`` column-, ``w2`` row-parallel.
    The embedding and the vocab projection stay replicated."""
    mp = "model" if tp else None
    attn = {
        "wq": P(None, None, mp), "wk": P(None, None, mp), "wv": P(None, None, mp),
        "bq": P(None, mp), "bk": P(None, mp), "bv": P(None, mp),
        "wo": P(None, mp, None), "bo": P(None, None),
    }
    ln = {"scale": P(None, None), "bias": P(None, None)}
    return {
        "token_embedding": P(None, None),
        "layers": {
            "self": dict(attn),
            "cross": dict(attn),
            "ffn": {
                "w1": P(None, None, mp), "b1": P(None, mp),
                "w2": P(None, mp, None), "b2": P(None, None),
            },
            "ln1": dict(ln), "ln2": dict(ln), "ln3": dict(ln),
        },
        "fc_out_w": P(None, None),
        "fc_out_b": P(None),
    }


def vision_param_specs(params: dict, tp: bool) -> dict:
    """Specs of the frozen float encoder: with ``tp`` attention and FFN
    split like the decoder's (column-parallel ``wq/wk/wv/fc1`` and their
    biases, row-parallel ``wo/fc2``), otherwise all replicated; the JAX
    package's rule. The training loop splits the encoder in the step by it
    under a model axis over 1 (:func:`check_vision_split` first), and
    replicates an int8 tree, whose leaves it does not describe."""
    mp = "model" if tp else None

    def spec_for(name, leaf):
        nd = leaf.dim()
        if tp and name in ("wq", "wk", "wv", "fc1", "bq", "bk", "bv", "b1"):
            return P(*([None] * (nd - 1)), mp)
        if tp and name in ("wo", "fc2"):
            return P(*([None] * (nd - 2)), mp, None)
        return P(*([None] * nd))

    def go(tree):
        return {k: go(v) if isinstance(v, dict) else spec_for(k, v)
                for k, v in tree.items()}

    return go(params)


def check_vision_split(vcfg, m: int) -> None:
    """Raise ``ValueError`` unless the encoder of ``vcfg`` splits over a
    model axis of ``m``: its heads and its FFN columns, ``m`` equal pieces
    each."""
    if vcfg.num_heads % m or vcfg.intermediate_size % m:
        raise ValueError(
            f"the encoder's {vcfg.num_heads} heads and "
            f"{vcfg.intermediate_size} FFN columns must split evenly over "
            f"the mesh model axis ({m}) to run it tensor-parallel")


def shard_encoder(encoder: dict, vcfg, mesh: Mesh) -> dict:
    """This rank's frozen encoder for a step with the encoder in it: a
    float tree split over "model" by ``vision_param_specs(tp=True)`` when
    the model axis is over 1 (after :func:`check_vision_split`); an int8
    tree, or any tree when the axis is 1, whole on the rank's device (an
    int8 tree as it is: its leaves are ``QuantizedLinear`` triples, which
    the specs do not describe)."""
    m = mesh.shape["model"]
    if "patch" in encoder:
        return encoder
    if m == 1:
        return replicate(encoder, mesh)
    check_vision_split(vcfg, m)
    return shard_tree(encoder, vision_param_specs(encoder, tp=True), mesh)


def model_param_specs(params: dict, tp: bool = False) -> dict:
    """Specs of the whole model tree (or of its trainable part)."""
    specs = {}
    if "encoder" in params:
        specs["encoder"] = vision_param_specs(params["encoder"], tp)
    specs["decoder"] = decoder_param_specs(tp)
    if "projection" in params:
        specs["projection"] = {"w": P(None, None), "b": P(None)}
    return specs


BATCH_SPECS = {
    "images": P("data"),
    "features": P("data"),
    "decoder_input_tokens": P("data"),
    "target_tokens": P("data"),
}


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_leaf(x, spec: tuple, index: int, count: int, axis: str = "model"):
    """Piece ``index`` of ``count`` of ``x`` (a tensor or a numpy array)
    along the dimension ``spec`` gives ``axis`` (``x`` itself where none
    does)."""
    if axis not in spec or count == 1:
        return x
    dim = spec.index(axis)
    if x.shape[dim] % count:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                         f"into {count} over {axis!r}")
    n = x.shape[dim] // count
    return x[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def _distributed(mesh: Mesh, what: str) -> None:
    if not mesh.distributed:
        raise ValueError(f"{what} takes the distributed mesh of "
                         "init_distributed_mesh")


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's shard of every leaf, on its device."""
    _distributed(mesh, "shard_tree")
    j, m = mesh.index("model"), mesh.shape["model"]
    return _map(lambda x, s: shard_leaf(x, s, j, m).to(mesh.device)
                .contiguous(), tree, specs)


def gather_tree(tree, specs, mesh: Mesh, device=None):
    """The inverse of :func:`shard_tree`, a collective over "model" (every
    rank calls it and gets the whole tree), on ``device`` (default the
    rank's)."""
    from mit_tpu_torch.parallel.collectives import all_gather_cat

    _distributed(mesh, "gather_tree")
    m, g = mesh.shape["model"], mesh.group("model")
    device = device or mesh.device
    return _map(lambda x, s: (all_gather_cat(x, s.index("model"), g)
                              if "model" in s and m > 1 else x).to(device),
                tree, specs)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's rows of the ``BATCH_SPECS`` keys (other keys pass
    through)."""
    _distributed(mesh, "shard_batch")
    i, d = mesh.index("data"), mesh.shape["data"]
    return {k: (shard_leaf(v, BATCH_SPECS[k], i, d, "data")
                if k in BATCH_SPECS else v) for k, v in batch.items()}


def replicate(tree, mesh: Mesh):
    """Every leaf whole, on this rank's device."""
    return shard_tree(tree, _map(lambda x, s: P(), tree, tree), mesh)


def shard_train_state(state, mesh: Mesh, mcfg=None, tp: bool = False):
    """A ``TrainState`` sharded as its parameters: the parameters by rule,
    Adam's moments like their parameters, the counters as they are
    (host ints)."""
    from mit_tpu_torch.train.steps import OptState, TrainState

    specs = {k: v for k, v in model_param_specs(state.params, tp).items()
             if k in state.params}
    sh = lambda t: shard_tree(t, specs, mesh)
    return TrainState(state.step, sh(state.params),
                      OptState(state.opt_state.count, sh(state.opt_state.mu),
                               sh(state.opt_state.nu)))


def gather_train_state(state, mesh: Mesh, tp: bool = False, device=None):
    """The inverse of :func:`shard_train_state` (a collective over "model"):
    the whole state, as a single device holds it."""
    from mit_tpu_torch.train.steps import OptState, TrainState

    specs = {k: v for k, v in model_param_specs(state.params, tp).items()
             if k in state.params}
    g = lambda t: gather_tree(t, specs, mesh, device)
    return TrainState(state.step, g(state.params),
                      OptState(state.opt_state.count, g(state.opt_state.mu),
                               g(state.opt_state.nu)))


def param_devices(params: dict, mesh: Mesh) -> int:
    """How many of the mesh's devices hold a piece of every parameter leaf
    (the JAX loop's ``param_devices``: all of them, whether a leaf is
    replicated or split); a collective over the whole mesh."""
    import torch.distributed as dist

    from mit_tpu_torch.train.steps import tree_leaves

    held = torch.tensor([float(all(x.numel() > 0
                                   for x in tree_leaves(params)))],
                        device=mesh.device)
    dist.all_reduce(held)
    return int(held.item())
