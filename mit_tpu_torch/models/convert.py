"""Parameter trees: JAX param pytree → the port's parameters, and per-layer
views.

The port stores parameters in the JAX package's own tree layout (nested
dicts, (in, out) matrices, layer parameters stacked on a leading axis), so
the conversion is leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None, dtype=torch.float32):
    """Nested dicts of array leaves → the same dicts of torch tensors.

    Leaves are anything ``np.asarray`` takes: numpy arrays, JAX arrays
    already pulled to the host (``jax.tree.map(np.asarray, params)``), CPU
    tensors. An int8 encoder tree (``QuantizedLinear`` leaves) is not a dict
    of arrays and raises ``TypeError``.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        raise TypeError(
            f"cannot convert {type(tree).__name__}: the port takes float "
            "parameters only"
        )
    # a copy: the source may be a read-only view (a JAX buffer, a file)
    return torch.tensor(np.asarray(tree, dtype=np.float32), dtype=dtype,
                        device=device)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a tree of layer-stacked parameters (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}
