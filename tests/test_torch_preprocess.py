"""Port parity: ``device_preprocess`` (uint8 NHWC → resize with
antialiasing → /255 → mean/std → NCHW f32) against the JAX package's
``jax.image.resize`` version on the CPU, per encoder family, within 1e-4 of
the normalized output (about 3e-5 on the 0..255 scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mit_tpu.data import preprocess as jpre
from mit_tpu_torch.data import preprocess as tpre

NAMES = {"vit": "google/vit-base-patch16-224-in21k",
         "clip": "openai/clip-vit-large-patch14",
         "blip": "Salesforce/blip-image-captioning-base"}
# (batch, H, W): downscale, upscale, non-square both ways, a tiny source, a
# large one, and each family's own target (identity)
SHAPES = [(1, 480, 640), (3, 100, 80), (1, 300, 500), (3, 2000, 300),
          (1, 7, 9), (1, 1200, 1600), (3, "target", "target")]


def _images(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("family", list(NAMES))
def test_device_preprocess_matches_jax(family, shape):
    name = NAMES[family]
    b, h, w = shape
    if h == "target":
        h, w = tpre.spec_for_encoder(name).target
    u8 = _images(b, h, w, seed=h * w)
    want = np.asarray(jpre.device_preprocess(jnp.asarray(u8), name))
    ours = tpre.device_preprocess(torch.from_numpy(u8), name)
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    assert ours.shape == want.shape == (b, 3, *jpre.spec_for_encoder(name).target)
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", list(NAMES))
def test_device_preprocess_image_size_is_the_recipe_at_another_target(family):
    """``image_size`` resizes to (image_size, image_size) with the family's
    recipe: JAX's jitted body at that target."""
    name = NAMES[family]
    spec = jpre.spec_for_encoder(name)
    u8 = _images(2, 90, 70, seed=1)
    want = np.asarray(jpre._device_preprocess(
        jnp.asarray(u8), (32, 32), spec.resample, spec.mean, spec.std))
    ours = tpre.device_preprocess(torch.from_numpy(u8), name, image_size=32)
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-4)
    assert tpre.spec_for_encoder(name) == tuple(spec)
