"""ctypes binding of the C++ JPEG decode and preprocess pipeline (port of
``mit_tpu/data/native_loader.py``).

For JPEG files it stands in for :class:`HostPreprocessor`: decode,
PIL-compatible antialiased resize (with CLIP's shortest edge and centre
crop), rescale and normalize happen in one native call with the GIL
released, so the loader's worker threads run in parallel. The library is
``native/image_loader.cpp``, built at first use by
:mod:`mit_tpu_torch.kernels.host`. Non-JPEG files go to PIL; a JPEG that
does not decode raises ``ValueError`` (the dataset then gives its dummy
item); a library that does not build makes the constructor raise (the
dataset then decodes with PIL).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from mit_tpu_torch.data.preprocess import HostPreprocessor, spec_for_encoder

_F32P = ctypes.POINTER(ctypes.c_float)
_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        from mit_tpu_torch.kernels import host

        lib = host.load("image_loader")
        lib.img_preprocess_jpeg.restype = ctypes.c_int32
        lib.img_preprocess_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _F32P, _F32P, _F32P,
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    """True where the JPEG library builds and loads."""
    try:
        _get_lib()
        return True
    except Exception:
        return False


class NativeImageLoader:
    """C++ JPEG preprocessing of an encoder family's recipe, with PIL for
    other files."""

    def __init__(self, encoder_name: str, image_size: Optional[int] = None):
        self.spec = spec_for_encoder(encoder_name)
        if image_size is not None and image_size != self.spec.target[0]:
            self.spec = self.spec._replace(target=(image_size, image_size))
        self._fallback = HostPreprocessor(encoder_name, image_size)
        self._mean = (ctypes.c_float * 3)(*self.spec.mean)
        self._std = (ctypes.c_float * 3)(*self.spec.std)
        self._resample = 0 if self.spec.resample == "bilinear" else 1
        self._mode = 0 if self.spec.mode == "fixed" else 1
        self._lib = _get_lib()

    def load_jpeg_bytes(self, data: bytes) -> np.ndarray:
        """JPEG bytes → normalized (3, H, W) f32; ``ValueError`` when the
        bytes do not decode."""
        th, tw = self.spec.target
        out = np.empty((3, th, tw), np.float32)
        rc = self._lib.img_preprocess_jpeg(
            data, len(data), th, tw, self._resample, self._mode,
            self._mean, self._std, out.ctypes.data_as(_F32P),
        )
        if rc != 0:
            raise ValueError(f"JPEG decode failed (code {rc})")
        return out

    def load_path(self, path: str) -> np.ndarray:
        """A ``.jpg`` / ``.jpeg`` file through the library, any other file
        through PIL."""
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                return self.load_jpeg_bytes(f.read())
        from PIL import Image

        with Image.open(path) as im:
            return self._fallback(im)
