"""Build and load the host (CPU) libraries of ``native/``: the C++ JPEG
loader (``image_loader.cpp``, linked with libjpeg) and the byte-level BPE
core (``bpe_core.cpp``).

At first use a source is compiled with ``g++`` and the flags of
``native/Makefile`` (no ``make`` is needed) into ``mit_tpu_torch/_build/``,
named by a hash of the source and the flags, so an edited source builds
anew and ``native/`` is only read. A build writes a temporary file and
moves it into place with ``os.replace``, so processes that build at once
each see a whole library. A library that does not build raises from
:func:`load` (the callers then fall back to PIL or the Python BPE, as the
JAX package's do), and the failure is kept, so a process tries the compiler
once per library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

NATIVE = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
# name -> (source in native/, libraries to link)
LIBRARIES = {
    "image_loader": ("image_loader.cpp", ("-ljpeg",)),
    "bpe_core": ("bpe_core.cpp", ()),
}

_loaded: dict = {}
_failed: dict = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where the library ``name`` for the current source and flags lives."""
    source, libs = LIBRARIES[name]
    digest = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    digest.update((NATIVE / source).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile the library ``name`` unless it is built; raise on failure
    with the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH: the host libraries need a C++ "
                           "compiler")
    source, libs = LIBRARIES[name]
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(NATIVE / source), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            why = next((line for line in proc.stderr.splitlines()
                        if "error" in line), proc.stderr.strip())
            raise RuntimeError(f"g++ failed ({proc.returncode}): {why}\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built on first call. A failure is raised again
    on every later call without another build."""
    with _lock:
        if name in _failed:
            raise _failed[name]
        if name not in _loaded:
            try:
                _loaded[name] = ctypes.CDLL(str(build(name)))
            except Exception as e:
                _failed[name] = e
                raise
    return _loaded[name]


def status() -> dict:
    """{name: "built" or the reason it did not build} for every library."""
    out = {}
    for name in LIBRARIES:
        try:
            load(name)
            out[name] = "built"
        except Exception as e:
            out[name] = f"{type(e).__name__}: {e}".strip()
    return out
