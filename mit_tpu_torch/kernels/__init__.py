"""Build and bind the hand-written CUDA kernels in ``mit_tpu_torch/csrc``.

The ``.cu`` sources expose plain C entry points. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into one shared library under
``mit_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source builds anew) and loaded with ``ctypes``. Pointers and the
stream travel as integers: ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``. Every entry point returns the
launch's ``cudaGetLastError()``; :func:`check` raises when it is not 0.

Nothing here runs at import time: a CPU-only process imports this module
and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v reports registers, shared memory and spills per kernel; the
# report is kept beside the library as <library>.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> argtypes of every C entry point the library exports
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    "mit_flash_attention_btd_f32": [_P] * 5 + [_I] * 6 + [_P],
    "mit_flash_attention_btd_bf16": [_P] * 5 + [_I] * 6 + [_P],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found: the kernels need nvcc (set CUDA_HOME)"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmit_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
