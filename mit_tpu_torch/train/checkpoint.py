"""Reference-layout safetensors checkpoints, load side (port of
``mit_tpu/train/checkpoint.py:58-93``).

The checkpoint holds ``encoder.*`` (HF vision naming), ``projection.*`` and
``decoder.*`` (torch naming), exactly as ``mit_tpu.train.checkpoint.
save_safetensors`` writes it. Saving and the train state come with the
training port.
"""

from __future__ import annotations

import numpy as np

from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import params_from_torch_state_dict
from mit_tpu_torch.models.model import ModelConfig
from mit_tpu_torch.models.vision import detect_hf_prefix, params_from_hf_vision


def params_from_reference_state_dict(sd: dict, mcfg: ModelConfig,
                                     device=None) -> dict:
    """A reference-format state dict → the port's parameters on ``device``."""
    params = {
        "encoder": params_from_hf_vision(
            sd, mcfg.vision, detect_hf_prefix(sd, mcfg.vision), device
        ),
        "decoder": params_from_torch_state_dict(
            sd, mcfg.decoder, "decoder.", device
        ),
    }
    if mcfg.needs_projection:
        params["projection"] = params_from_jax({
            "w": np.asarray(sd["projection.weight"], np.float32).T,
            "b": sd["projection.bias"],
        }, device)
    return params


def load_safetensors(path: str, mcfg: ModelConfig, device=None) -> dict:
    """Read a checkpoint with the JAX package's pure-Python safetensors
    reader (imported here: the package is JAX-free but need not be loaded
    unless a checkpoint is read)."""
    from mit_tpu.utils.safetensors_io import load_file

    return params_from_reference_state_dict(load_file(path), mcfg, device)
