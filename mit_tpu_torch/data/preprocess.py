"""Image preprocessing (port of ``mit_tpu/data/preprocess.py``): a host
path and a device path.

- host: PIL resize/crop with the HF processor recipe of each encoder family
  (ViT: 224² bilinear, mean/std 0.5; CLIP: shortest edge 224 bicubic +
  centre crop, OpenAI mean/std; BLIP: 384² bicubic, OpenAI mean/std). PIL
  is imported at the first call, so the package imports where Pillow is
  absent.
- device: :func:`device_preprocess`, a batch of uint8 images resized,
  rescaled and normalized on the tensor's device, for inputs that arrive at
  a known shape (serving, benchmarks).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mit_tpu_torch.utils.profiling import span

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


class PreprocessSpec(NamedTuple):
    """Per-encoder-family preprocessing recipe (HF processor defaults)."""

    target: Tuple[int, int]             # (H, W) after resize (+crop for clip)
    mode: str                           # "fixed" | "shortest_edge_crop"
    resample: str                       # "bilinear" | "bicubic"
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


SPECS = {
    "vit": PreprocessSpec((224, 224), "fixed", "bilinear", (0.5,) * 3, (0.5,) * 3),
    "clip": PreprocessSpec(
        (224, 224), "shortest_edge_crop", "bicubic", OPENAI_MEAN, OPENAI_STD
    ),
    "blip": PreprocessSpec((384, 384), "fixed", "bicubic", OPENAI_MEAN, OPENAI_STD),
}


def spec_for_encoder(name: str) -> PreprocessSpec:
    low = name.lower()
    if "blip" in low:
        return SPECS["blip"]
    if "clip" in low:
        return SPECS["clip"]
    return SPECS["vit"]


class HostPreprocessor:
    """``__call__(pil_image) -> np.float32 (3, H, W)`` (NCHW, as HF)."""

    def __init__(self, encoder_name: str, image_size: int = None):
        """``image_size`` overrides the recipe's square side when the vision
        tower's input size differs from the family default."""
        self.spec = spec_for_encoder(encoder_name)
        if image_size is not None and image_size != self.spec.target[0]:
            self.spec = self.spec._replace(target=(image_size, image_size))

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        if image.mode != "RGB":
            image = image.convert("RGB")
        spec = self.spec
        resample = (
            Image.Resampling.BILINEAR
            if spec.resample == "bilinear"
            else Image.Resampling.BICUBIC
        )
        th, tw = spec.target
        if spec.mode == "fixed":
            arr = np.asarray(image.resize((tw, th), resample=resample),
                             dtype=np.float32)
        else:  # shortest-edge resize (long side scaled) + centre crop
            w, h = image.size
            scale = th / min(w, h)
            nw, nh = (th, int(h * scale)) if w <= h else (int(w * scale), th)
            arr = np.asarray(image.resize((nw, nh), resample=resample),
                             dtype=np.float32)
            top, left = (nh - th) // 2, (nw - tw) // 2
            arr = arr[top : top + th, left : left + tw]
        arr = arr / 255.0
        arr = (arr - np.asarray(spec.mean, np.float32)) / np.asarray(
            spec.std, np.float32
        )
        return arr.transpose(2, 0, 1).astype(np.float32)  # HWC -> CHW


def device_preprocess(images_u8: torch.Tensor, encoder_name: str,
                      image_size: int = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 → normalized (B, 3, h, w) f32 on the same device.

    A square resize straight to the family's target, no crop, with
    antialiasing (bilinear for ViT, bicubic for CLIP and BLIP: the Keys
    cubic at a = -0.5 with renormalized weights, as ``jax.image.resize``
    computes it), then /255 and the family's mean and std.
    ``image_size``, as in :class:`HostPreprocessor`, overrides the target
    where the tower's input size is not the family default.
    """
    spec = spec_for_encoder(encoder_name)
    target = spec.target if image_size is None else (image_size, image_size)
    with span("mit.preprocess"):
        x = images_u8.permute(0, 3, 1, 2).to(torch.float32)
        x = F.interpolate(x, size=target, mode=spec.resample, antialias=True,
                          align_corners=False)
        stat = lambda v: torch.tensor(v, dtype=torch.float32,
                                      device=x.device).view(1, 3, 1, 1)
        # the resize keeps the input's channels-last strides; callers get NCHW
        return ((x / 255.0 - stat(spec.mean)) / stat(spec.std)).contiguous()
