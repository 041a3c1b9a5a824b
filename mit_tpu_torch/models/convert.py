"""Parameter trees: JAX param pytree → the port's parameters and back, and
per-layer views.

The port stores parameters in the JAX package's own tree layout (nested
dicts, (in, out) matrices, layer parameters stacked on a leading axis), so
the conversion is leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from mit_tpu_torch.ops.quant import QuantizedLinear, kernel_layout


def params_from_jax(tree, device=None, dtype=torch.float32):
    """Nested dicts of array leaves → the same dicts of torch tensors.

    Leaves are anything ``np.asarray`` takes: numpy arrays, JAX arrays
    already pulled to the host (``jax.tree.map(np.asarray, params)``), CPU
    tensors. ``QuantizedLinear`` leaves of an int8 encoder tree
    (``quantize_vision_params``) become the port's ``QuantizedLinear``: the
    int8 codes stay int8 (stored K-contiguous, as the int8 GEMM kernel
    reads them), scale and bias become f32 whatever ``dtype`` says.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        if getattr(tree, "_fields", None) != QuantizedLinear._fields:
            raise TypeError(f"cannot convert {type(tree).__name__}")
        w8, scale, bias = tree
        f32 = lambda a: params_from_jax(a, device, torch.float32)
        return QuantizedLinear(
            kernel_layout(torch.tensor(np.asarray(w8, np.int8), device=device)),
            f32(scale), None if bias is None else f32(bias),
        )
    # a copy: the source may be a read-only view (a JAX buffer, a file)
    return torch.tensor(np.asarray(tree, dtype=np.float32), dtype=dtype,
                        device=device)


def params_to_jax(tree):
    """The reverse of :func:`params_from_jax` for float trees: nested dicts
    of tensors → the same dicts of float32 numpy arrays on the host, the JAX
    package's layout leaf by leaf."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"cannot convert {type(tree).__name__}")
    return tree.detach().to("cpu", torch.float32).numpy()


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a tree of layer-stacked parameters (views)."""
    out = {}
    for k, v in stacked.items():
        if isinstance(v, dict):
            out[k] = layer_params(v, i)
        elif isinstance(v, QuantizedLinear):
            out[k] = v.layer(i)
        else:
            out[k] = v[i]
    return out
