"""Byte-level BPE encoder/decoder, HF-`tokenizers`-format compatible.

First-party re-implementation of the encode/decode path the reference gets
from the Rust ``tokenizers`` crate (reference tokenizer.py:173-352). Reads and
writes the same ``vocab.json`` + ``merges.txt`` files and is verified
bit-identical against ``ByteLevelBPETokenizer`` in the test suite
(tests/test_tokenizer.py).

Pipeline (mirrors ByteLevelBPETokenizer semantics):
  1. pre-tokenize with the GPT-2 regex,
  2. map raw bytes to the byte-level unicode alphabet,
  3. greedily apply merge rules by rank within each pre-token,
  4. look up token IDs in the vocab.

A C++ fast path (native/bpe_core.cpp, loaded via ctypes) accelerates batch
encoding for the serving path; this module is the reference implementation
and the fallback.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import regex as _regex

# GPT-2 pre-tokenization pattern (the one ByteLevel uses).
_GPT2_PAT = _regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte → unicode-char map used by the ByteLevel alphabet.

    Printable bytes map to themselves; the rest are shifted to 256+ so every
    byte has a visible, non-whitespace character representation.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


class ByteLevelBPE:
    """Byte-level BPE codec over ``vocab.json`` + ``merges.txt`` files."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.merge_ranks: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merges)
        }
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = unicode_to_bytes()
        self._word_cache: Dict[str, List[int]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "ByteLevelBPE":
        with open(vocab_path, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def save(self, vocab_path: str, merges_path: str) -> None:
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False, separators=(",", ":"))
        ordered = sorted(self.merge_ranks.items(), key=lambda kv: kv[1])
        with open(merges_path, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in ordered:
                f.write(f"{a} {b}\n")

    # ------------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token_str(self, idx: int) -> Optional[str]:
        return self.id_to_token.get(idx)

    # ------------------------------------------------------------------
    def _bpe_word(self, word: str) -> List[str]:
        """Apply merge rules greedily (lowest rank first) to one pre-token.

        ``word`` is already in byte-level unicode alphabet space.
        """
        parts: List[str] = list(word)
        if len(parts) < 2:
            return parts
        ranks = self.merge_ranks
        while True:
            best_rank = None
            best_pair = None
            prev = parts[0]
            for cur in parts[1:]:
                r = ranks.get((prev, cur))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_pair = (prev, cur)
                prev = cur
            if best_pair is None:
                return parts
            a, b = best_pair
            merged: List[str] = []
            i = 0
            n = len(parts)
            while i < n:
                if i < n - 1 and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
            if len(parts) < 2:
                return parts

    def encode_ids(self, text: str, unk_id: Optional[int] = None) -> List[int]:
        """Encode raw text → token IDs (no special tokens/padding)."""
        out: List[int] = []
        be = self._byte_encoder
        vocab = self.vocab
        cache = self._word_cache
        for m in _GPT2_PAT.finditer(text):
            chunk = m.group()
            cached = cache.get(chunk)
            if cached is not None:
                out.extend(cached)
                continue
            word = "".join(be[b] for b in chunk.encode("utf-8"))
            ids: List[int] = []
            for tok in self._bpe_word(word):
                tid = vocab.get(tok)
                if tid is None:
                    if unk_id is not None:
                        ids.append(unk_id)
                else:
                    ids.append(tid)
            if len(cache) < 65536:
                cache[chunk] = ids
            out.extend(ids)
        return out

    def decode_tokens(self, tokens: Iterable[str]) -> str:
        """Token strings → text via the inverse byte map."""
        bd = self._byte_decoder
        buf = bytearray()
        for tok in tokens:
            for ch in tok:
                b = bd.get(ch)
                if b is None:
                    buf.extend(ch.encode("utf-8"))
                else:
                    buf.append(b)
        return buf.decode("utf-8", errors="replace")

    def decode_ids(self, ids: Iterable[int], skip_ids: Optional[set] = None) -> str:
        toks = []
        for i in ids:
            if skip_ids and i in skip_ids:
                continue
            t = self.id_to_token.get(int(i))
            if t is not None:
                toks.append(t)
        return self.decode_tokens(toks)
