"""mit_tpu_torch — the PyTorch/CUDA port of mit_tpu for NVIDIA Hopper.

A second package beside the JAX package ``mit_tpu``, which stays the
reference: every module here mirrors the ``mit_tpu`` module of the same name
and is tested against it on the same weights and inputs. The port imports
``torch`` and never ``jax``, and nothing of ``mit_tpu``: it keeps its own
copies of the JAX-free modules it needs (``config``, ``text``,
``data.prepare``). The tokenizer (the ``regex`` package) and Pillow are
imported inside the functions that need a tokenizer or an image file, so
that the captioning and training paths over pixel tensors and token ids run
where only torch and numpy are installed.

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
    config    the typed configuration (the JAX package's, knob for knob)
    ops       masks, positional table, attention, flash_attention_btd and
              flash_attention, dropout attention, the int8 encoder's ops,
              the fused decode layer
    models    vision tower, decoder, assembly, weight conversion
    text      byte-level BPE tokenizer and its trainer
    data      host preprocessing, dataset, batching, dataset preparation
    train     train and eval steps, optimizer, feature cache, loop, CLI,
              checkpoints
    decode    KV-cached decode step (unfused and fused; CLS and full
              memory), greedy, beam search, sampling, the continuously
              batched CaptionService, captioning API and CLI
    eval      corpus BLEU-4 and CIDEr-D (copies of the JAX package's)
    kernels   nvcc build + ctypes binding of csrc/*.cu
"""

__version__ = "0.1.0"
