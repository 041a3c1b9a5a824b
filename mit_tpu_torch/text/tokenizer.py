"""Public tokenizer API, mirroring the reference's surface.

Reference: tokenizer.py:181-352 — ``train_tokenizer``, ``get_tokenizer``,
``encode_text``, ``decode_ids``, ``get_tokenizer_vocab_size``,
``get_token_id``, plus BertProcessing-style START/END insertion, fixed-length
padding and truncation.

Design changes vs the reference:
- the whole stack is first-party: encode/decode run through the byte-level
  BPE in :mod:`mit_tpu_torch.text.bpe` (with a C++ fast path), and *training*
  runs through :mod:`mit_tpu_torch.text.train_bpe` — no Rust crate anywhere. The
  emitted ``vocab.json``/``merges.txt`` are bit-identical to the HF
  ``tokenizers`` output on the same corpus (tests/test_train_bpe.py).
- Special-token IDs are read from the trained vocab at load time — the single
  source of truth (the reference hardcodes them in config.py:116-119, which
  disagrees with its own training order, tokenizer.py:202-208).
"""

from __future__ import annotations

import os
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np

from mit_tpu_torch.config import CONFIG, Config
from mit_tpu_torch.text.bpe import ByteLevelBPE


class Tokenizer:
    """Byte-level BPE tokenizer with START/END post-processing and padding.

    Encoding semantics match ``ByteLevelBPETokenizer`` with a
    ``BertProcessing`` post-processor, ``enable_truncation(max_length=L)`` and
    ``enable_padding(length=L)`` (reference tokenizer.py:281-315):
    content is truncated to ``L - 2``, wrapped in START/END, then padded with
    PAD up to ``L``.
    """

    def __init__(self, bpe: ByteLevelBPE, cfg: Config = CONFIG):
        self.bpe = bpe
        self.cfg = cfg
        self.pad_token = cfg.PAD_TOKEN
        self.start_token = cfg.START_TOKEN
        self.end_token = cfg.END_TOKEN
        self.unk_token = cfg.UNK_TOKEN

        def _require(tok: str) -> int:
            tid = bpe.token_to_id(tok)
            if tid is None:
                raise ValueError(
                    f"Special token {tok!r} not found in tokenizer vocabulary."
                )
            return tid

        self.pad_id = _require(self.pad_token)
        self.start_id = _require(self.start_token)
        self.end_id = _require(self.end_token)
        self.unk_id = _require(self.unk_token)
        self.max_len = cfg.MAX_SEQ_LEN
        self._native = None  # lazily attached C++ encoder

    # ------------------------------------------------------------------
    @classmethod
    def from_files(
        cls, vocab_path: str, merges_path: str, cfg: Config = CONFIG
    ) -> "Tokenizer":
        if not os.path.exists(vocab_path) or not os.path.exists(merges_path):
            raise FileNotFoundError(
                f"Tokenizer vocabulary file ('{vocab_path}') or merges file "
                f"('{merges_path}') not found. Train the tokenizer first "
                f"(train.py does this automatically)."
            )
        tok = cls(ByteLevelBPE.from_files(vocab_path, merges_path), cfg)
        tok.use_native()  # attach the C++ encode path when buildable
        return tok

    # ------------------------------------------------------------------
    def get_vocab_size(self) -> int:
        return self.bpe.vocab_size

    def token_to_id(self, token: str) -> Optional[int]:
        return self.bpe.token_to_id(token)

    # ------------------------------------------------------------------
    def encode(
        self,
        text: str,
        add_special_tokens: bool = True,
        pad: bool = True,
    ) -> List[int]:
        """Encode text → IDs with START/END, truncation, optional padding."""
        native = self._native
        if native is not None:
            content = native.encode_ids(text)
        else:
            content = self.bpe.encode_ids(text, unk_id=self.unk_id)
        if add_special_tokens:
            content = content[: self.max_len - 2]
            ids = [self.start_id] + content + [self.end_id]
        else:
            ids = content[: self.max_len]
        if pad and len(ids) < self.max_len:
            ids = ids + [self.pad_id] * (self.max_len - len(ids))
        return ids

    def encode_batch(self, texts: Iterable[str]) -> np.ndarray:
        """Batch encode to a fixed-shape (N, MAX_SEQ_LEN) int32 array."""
        rows = [self.encode(t) for t in texts]
        return np.asarray(rows, dtype=np.int32)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        skip = (
            {self.pad_id, self.start_id, self.end_id, self.unk_id}
            if skip_special_tokens
            else None
        )
        return self.bpe.decode_ids(ids, skip_ids=skip)

    # ------------------------------------------------------------------
    def use_native(self) -> bool:
        """Attach the C++ encode path (:mod:`mit_tpu_torch.text.native`)
        where its library builds; else keep the pure-Python BPE. Either
        gives the same ids."""
        try:
            from mit_tpu_torch.text.native import NativeBPE

            self._native = NativeBPE(self.bpe)
            return True
        except Exception:
            self._native = None
            return False


# ----------------------------------------------------------------------
# Training (first-party trainer — text/train_bpe.py — emitting the HF
# interchange format; bit-identity with the HF library trainer is enforced
# in tests/test_train_bpe.py). Reference: tokenizer.py:181-241.
# ----------------------------------------------------------------------
def train_tokenizer(
    captions_iterator: Iterator[str],
    vocab_size: int,
    vocab_path: str,
    merges_path: str,
    cfg: Config = CONFIG,
) -> Tokenizer:
    """Train a byte-level BPE tokenizer and save vocab.json + merges.txt.

    Matches reference tokenizer.py:193-209: ``min_frequency=2`` and special
    tokens registered in the order [PAD, UNK, START, END].
    """
    from mit_tpu_torch.text.train_bpe import train_bpe_files

    train_bpe_files(
        captions_iterator,
        vocab_size,
        vocab_path,
        merges_path,
        special_tokens=[
            cfg.PAD_TOKEN, cfg.UNK_TOKEN, cfg.START_TOKEN, cfg.END_TOKEN,
        ],
        min_frequency=2,
    )

    global _tokenizer_instance
    with _lock:
        _tokenizer_instance = Tokenizer.from_files(vocab_path, merges_path, cfg)
        return _tokenizer_instance


# ----------------------------------------------------------------------
# Module-level singleton, mirroring reference tokenizer.py:176-179, 244-319.
# ----------------------------------------------------------------------
_tokenizer_instance: Optional[Tokenizer] = None
_lock = threading.Lock()


def get_tokenizer(cfg: Config = CONFIG, force_reload: bool = False) -> Tokenizer:
    global _tokenizer_instance
    with _lock:
        if _tokenizer_instance is not None and not force_reload:
            return _tokenizer_instance
        _tokenizer_instance = Tokenizer.from_files(
            cfg.VOCAB_PATH, cfg.MERGES_PATH, cfg
        )
        return _tokenizer_instance


def encode_text(text: str) -> List[int]:
    return get_tokenizer().encode(text)


def decode_ids(token_ids: List[int], skip_special_tokens: bool = True) -> str:
    return get_tokenizer().decode(token_ids, skip_special_tokens)


def get_tokenizer_vocab_size() -> int:
    return get_tokenizer().get_vocab_size()


def get_token_id(token: str) -> Optional[int]:
    tok = get_tokenizer()
    tid = tok.token_to_id(token)
    if tid is None:
        return tok.unk_id
    return tid
