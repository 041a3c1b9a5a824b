"""mit_tpu_torch — the PyTorch/CUDA port of mit_tpu for NVIDIA Hopper.

A second package beside the JAX package ``mit_tpu``, which stays the
reference: every module here mirrors the ``mit_tpu`` module of the same name
and is tested against it on the same weights and inputs. The port imports
``torch`` and never ``jax``. It uses ``mit_tpu``'s JAX-free modules
(``mit_tpu.config``, ``mit_tpu.text``, ``mit_tpu.utils.safetensors_io``)
where it needs them, and imports them lazily, inside the functions that
need them, so that the captioning path runs where only torch and numpy are
installed.

At its public functions the port keeps the JAX layouts: (in, out) weight
matrices, (B, T, D) activations with heads as column blocks, NCHW pixels,
and parameters as nested dicts of tensors (layer parameters stacked on a
leading axis), so that ``models.convert.params_from_jax`` carries weights
over leaf by leaf.

Every Pallas kernel on a ported path is a kernel written by hand for
``sm_90a`` (``csrc/``, built by ``kernels``). Each wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel, or raises, for
CUDA tensors.

Package layout:
    ops       masks, positional table, attention, flash_attention_btd
    models    vision tower, decoder, assembly, weight conversion
    data      host preprocessing
    train     checkpoint loading
    decode    KV-cached greedy decoding, captioning API and CLI
    kernels   nvcc build + ctypes binding of csrc/*.cu
"""

__version__ = "0.1.0"
