"""Image features of one image (port of ``mit_tpu/models/encoder_tools.py``,
the reference's ``encoder.py``): :func:`encode_image` gives the whole
``last_hidden_state`` of a PIL image, :func:`get_encoder_output_dim` the
encoder's width. The batched feature path is ``train/features.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mit_tpu_torch.config import CONFIG
from mit_tpu_torch.data.preprocess import HostPreprocessor
from mit_tpu_torch.models.vision import (
    config_for_encoder,
    init_vision_params,
    vision_forward,
)

# (VisionConfig, params, HostPreprocessor) by encoder name, as the JAX
# package keys its cache
_cache = {}


def _get(encoder_name: str, params: Optional[dict], device):
    if encoder_name not in _cache:
        vcfg = config_for_encoder(encoder_name)
        if params is None:
            params = init_vision_params(torch.Generator().manual_seed(0), vcfg,
                                        device)
        pre = HostPreprocessor(encoder_name, image_size=vcfg.image_size)
        _cache[encoder_name] = (vcfg, params, pre)
    return _cache[encoder_name]


def get_encoder_output_dim(encoder_name: Optional[str] = None, cfg=None) -> int:
    """Hidden size of the encoder ``encoder_name`` (default: the config's)."""
    name = encoder_name or (cfg or CONFIG).ENCODER_MODEL_NAME
    return config_for_encoder(name).hidden_size


def encode_image(image, encoder_name: Optional[str] = None,
                 params: Optional[dict] = None, cfg=None,
                 device="cuda") -> np.ndarray:
    """PIL image → the encoder's full sequence (1, N+1, D) as f32 numpy.

    ``params`` are the tower's weights (the pretrained loaders give them);
    without them a random tower from seed 0 is drawn on ``device``. The
    first call for a name fixes its weights, as in the JAX package. The
    pixels go to the weights' device.
    """
    name = encoder_name or (cfg or CONFIG).ENCODER_MODEL_NAME
    vcfg, params, pre = _get(name, params, device)
    pixels = torch.from_numpy(pre(image)[None]).to(params["cls"].device)
    with torch.no_grad():
        return vision_forward(params, vcfg, pixels).cpu().numpy()
