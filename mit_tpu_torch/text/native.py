"""ctypes binding of the C++ byte-level BPE encoder (port of
``mit_tpu/text/native.py``).

The loaded vocab and merges are turned from byte-level *unicode* strings
back into raw *bytes* (the GPT-2 alphabet is a bijection on bytes, so the
merges act the same on either) and handed to ``native/bpe_core.cpp``,
built at first use by :mod:`mit_tpu_torch.kernels.host`. Pre-tokenization
(the GPT-2 regex) stays in Python's ``regex`` module; the merge loop of
each word runs in C++. Its ids equal :meth:`ByteLevelBPE.encode_ids`'s.

``Tokenizer.use_native()`` returns False when the library does not build,
and the tokenizer keeps the Python BPE.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List

from mit_tpu_torch.text.bpe import ByteLevelBPE, _GPT2_PAT, unicode_to_bytes


def _to_bytes(token: str) -> bytes:
    """Byte-level unicode token string → raw bytes (the inverse alphabet)."""
    u2b = unicode_to_bytes()
    out = bytearray()
    for ch in token:
        b = u2b.get(ch)
        if b is None:
            out.extend(ch.encode("utf-8"))      # special tokens such as <PAD>
        else:
            out.append(b)
    return bytes(out)


def _load():
    from mit_tpu_torch.kernels import host

    lib = host.load("bpe_core")
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.bpe_encode_words.restype = ctypes.c_int32
    lib.bpe_encode_words.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeBPE:
    """The C++ encoder over one :class:`ByteLevelBPE`'s vocab and merges."""

    def __init__(self, bpe: ByteLevelBPE):
        self._lib = _load()
        tokens_blob = bytearray()
        for tok, tid in bpe.vocab.items():
            raw = _to_bytes(tok)
            tokens_blob += struct.pack("<I", len(raw)) + raw + struct.pack("<i", tid)
        merges_blob = bytearray()
        ordered = sorted(bpe.merge_ranks.items(), key=lambda kv: kv[1])
        for (a, b), _ in ordered:
            ra, rb = _to_bytes(a), _to_bytes(b)
            merges_blob += struct.pack("<I", len(ra)) + ra
            merges_blob += struct.pack("<I", len(rb)) + rb
        unk = bpe.vocab.get("<UNK>", -1)
        self._handle = self._lib.bpe_create(
            bytes(tokens_blob), len(bpe.vocab), bytes(merges_blob),
            len(ordered), unk,
        )
        if not self._handle:
            raise RuntimeError("bpe_create failed")

    def encode_ids(self, text: str) -> List[int]:
        """Token ids of ``text``, without special tokens."""
        words = [m.group().encode("utf-8") for m in _GPT2_PAT.finditer(text)]
        if not words:
            return []
        blob = bytearray()
        for w in words:
            blob += struct.pack("<I", len(w)) + w
        max_out = len(blob) + 8          # at most one id per byte
        out = (ctypes.c_int32 * max_out)()
        n = self._lib.bpe_encode_words(self._handle, bytes(blob), len(words),
                                       out, max_out)
        if n < 0:
            raise RuntimeError("bpe_encode_words: output buffer too small")
        return list(out[:n])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.bpe_free(self._handle)
        except Exception:
            pass
