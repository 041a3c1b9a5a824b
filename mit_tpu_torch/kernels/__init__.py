"""Build and bind the hand-written CUDA kernels in ``mit_tpu_torch/csrc``.

The ``.cu`` sources expose plain C entry points. At first use each source
is compiled with ``nvcc`` for ``sm_90a``, all of them at once in parallel,
and the objects are linked into one shared library under
``mit_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source builds anew), which is loaded with ``ctypes``. Pointers and the
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
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v reports registers, shared memory and spills per kernel; the
# report is kept beside the library as <library>.log. No --use_fast_math:
# the int8 quantizers' divides and square roots must stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> argtypes of every C entry point the library exports
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_LL = ctypes.c_longlong
ENTRY_POINTS = {
    # the attention entries take the head width (64, or 72 to 128 by 8)
    "mit_flash_attention_btd_f32": [_P] * 5 + [_I] * 7 + [_P],
    "mit_flash_attention_btd_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "mit_flash_attention_fusedqkv": [_P] * 2 + [_I] * 7 + [_P],
    "mit_flash_attention_bhtd": [_P] * 5 + [_I] * 10 + [_P],
    "mit_fused_decode_layer": [_P] * 25 + [_I] * 8 + [_LL, _F, _P],
    "mit_quantize_rows_f32": [_P] * 5 + [_I, _I, _F, _P],
    "mit_quantize_rows_bf16": [_P] * 5 + [_I, _I, _F, _P],
    "mit_int8_gemm": [_P] * 7 + [_I] * 6 + [_P],
    "mit_int8_mlp_fused": [_P] * 10 + [_I] * 7 + [_F, _P],
    # shared memory a block and clusters the card holds at once
    "mit_int8_mlp_fused_info": [_I, _I, _P, _P],
    # the dropout entries take the seed by value and a device pointer to it
    # (null: the value), and end in the cell map (b_offset, h_total,
    # h_offset)
    "mit_flash_attention_dropout_fwd":
        [_P] * 5 + [_I] * 6 + [_U, _P, _U, _F] + [_I] * 3 + [_P],
    "mit_flash_attention_dropout_bwd":
        [_P] * 8 + [_I] * 6 + [_U, _P, _U, _F] + [_I] * 3 + [_P],
    "mit_dump_dropout_mask":
        [_P] + [_I] * 4 + [_U, _P, _U] + [_I] * 3 + [_P],
    # the shapes the tiled attention kernels do not take
    "mit_attention_any_shape": [_P] * 5 + [_I] * 13 + [_P],
    "mit_dropout_attention_any_shape_fwd":
        [_P] * 5 + [_I] * 7 + [_U, _P, _U, _F] + [_I] * 3 + [_P],
    "mit_dropout_attention_any_shape_bwd":
        [_P] * 9 + [_I] * 7 + [_U, _P, _U, _F] + [_I] * 3 + [_P],
    # the grouped SwiGLU experts: x, token, offsets, three weights, the
    # hidden and the output; D, F, E, routes, row tiles; the stream
    "mit_moe_experts": [_P] * 8 + [_I] * 5 + [_P],
    # the float encoder's elementwise passes: x, a, bias, LayerNorm scale
    # and shift, y, h; M, D, the row strides of x and a, dtype, eps; the
    # stream. Then a, bias, out; M, F, act, dtype; the stream
    "mit_add_layer_norm": [_P] * 7 + [_I] * 2 + [_LL] * 2 + [_I, _F, _P],
    "mit_bias_act": [_P] * 3 + [_I] * 4 + [_P],
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
    for src in sorted(CSRC.glob("*.cu*")):        # sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmit_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is built:
    one ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = tmp / f"{src.stem}.o", tmp / f"{src.stem}.log"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, proc, obj, log))
        failed = [(cmd, proc.wait(), log) for cmd, proc, _, log in jobs]
        failed = [(cmd, rc, log) for cmd, rc, log in failed if rc != 0]
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log.read_text()}"
                for cmd, rc, log in failed
            ))
        lib = tmp / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(lib), *(str(j[2]) for j in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_name(out.name + ".log").write_text(
            "".join(j[3].read_text() for j in jobs))
        os.replace(lib, out)   # atomic: a concurrent build sees all or nothing
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.

    The first call records ``lib.built``, ``{"nvcc": bool, "seconds": s}``:
    whether this process ran ``nvcc`` for the library and the seconds the
    build took (0 where it found the library built), and
    ``lib.load_seconds``, the time to build or find it, load and bind it.
    Both are None until then."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            found = library_path().exists()
            path = build()
            built_s = 0.0 if found else time.perf_counter() - t0
            so = ctypes.CDLL(str(path))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
            lib.built = {"nvcc": not found, "seconds": built_s}
            lib.load_seconds = time.perf_counter() - t0
    return _lib


lib.built = None
lib.load_seconds = None


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as an entry point takes it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def ptr(x: Optional[torch.Tensor]):
    """x's device address, or None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


def require_cuda(x: torch.Tensor, name: str) -> None:
    """Raise unless x is a CUDA tensor that records no gradient: the
    forward-only wrappers' refusal."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{name} is forward-only; run it under torch.no_grad() or "
            "torch.inference_mode()"
        )
