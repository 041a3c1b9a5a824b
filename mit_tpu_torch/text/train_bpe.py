"""First-party byte-level BPE trainer, bit-identical to HF `tokenizers`.

Completes tokenizer independence: encode/decode already run first-party
(text/bpe.py, native C++ path); this module replaces the last delegation —
training (reference tokenizer.py:181-241 calls the Rust trainer).

Semantics reverse-engineered from the Rust implementation and locked in by
bit-identity tests (tests/test_train_bpe.py) on vocab.json AND merges.txt:

- pre-tokenize with the GPT-2 regex, map bytes through the ByteLevel
  alphabet, count pre-token ("word") frequencies;
- base vocabulary: special tokens in the given order, then the full
  256-character byte-level alphabet sorted by codepoint;
- repeatedly merge the most frequent adjacent symbol pair (pair occurrences
  counted per position, overlaps included, weighted by word frequency);
  ties break on the pair's (first token id, second token id) — NOT
  lexicographically on strings;
- stop when the vocab reaches ``vocab_size`` or no pair has count ≥
  ``min_frequency``.

The merge loop uses incremental pair-count maintenance with a lazy
max-heap, so training Flickr30k-scale corpora (~10k merges over ~2M words)
stays near-linear.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

from mit_tpu_torch.text.bpe import _GPT2_PAT, ByteLevelBPE, bytes_to_unicode


def _count_words(captions: Iterable[str]) -> Counter:
    be = bytes_to_unicode()
    wf: Counter = Counter()
    for text in captions:
        for m in _GPT2_PAT.finditer(text):
            wf["".join(be[b] for b in m.group().encode("utf-8"))] += 1
    return wf


def train_bpe(
    captions: Iterable[str],
    vocab_size: int,
    special_tokens: Sequence[str] = (),
    min_frequency: int = 2,
) -> ByteLevelBPE:
    """Train byte-level BPE; returns a ready codec (save via .save())."""
    word_freq = _count_words(captions)

    # base vocab: specials, then full byte-level alphabet by codepoint
    vocab: Dict[str, int] = {}
    for tok in special_tokens:
        if tok not in vocab:
            vocab[tok] = len(vocab)
    for ch in sorted(bytes_to_unicode().values()):
        if ch not in vocab:
            vocab[ch] = len(vocab)

    words: List[List[str]] = []
    freqs: List[int] = []
    for w, f in word_freq.items():
        words.append(list(w))
        freqs.append(f)

    # pair counts + which words contain each pair
    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[str, str], set] = {}
    for wi, syms in enumerate(words):
        f = freqs[wi]
        for a, b in zip(syms, syms[1:]):
            pair_counts[(a, b)] += f
            pair_words.setdefault((a, b), set()).add(wi)

    def heap_key(pair: Tuple[str, str], count: int):
        return (-count, vocab[pair[0]], vocab[pair[1]])

    heap = [
        (*heap_key(p, c), p) for p, c in pair_counts.items() if c >= min_frequency
    ]
    heapq.heapify(heap)

    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size and heap:
        negc, ida, idb, pair = heapq.heappop(heap)
        count = pair_counts.get(pair, 0)
        if count < min_frequency:
            continue
        if (-negc, ida, idb) != (count, vocab[pair[0]], vocab[pair[1]]):
            # stale entry — reinsert with the current count
            heapq.heappush(heap, (*heap_key(pair, count), pair))
            continue

        a, b = pair
        new_tok = a + b
        vocab[new_tok] = len(vocab)
        merges.append(pair)

        touched: set = set()
        for wi in list(pair_words.get(pair, ())):
            syms = words[wi]
            f = freqs[wi]
            out: List[str] = []
            i = 0
            n = len(syms)
            changed = False
            while i < n:
                if i + 1 < n and syms[i] == a and syms[i + 1] == b:
                    # decrement neighbors of the merged occurrence
                    if out:
                        _dec(pair_counts, (out[-1], a), f)
                        touched.add((out[-1], a))
                    if i + 2 < n:
                        nxt = syms[i + 2]
                        _dec(pair_counts, (b, nxt), f)
                        touched.add((b, nxt))
                    _dec(pair_counts, pair, f)
                    # increment new neighbors
                    if out:
                        pair_counts[(out[-1], new_tok)] += f
                        pair_words.setdefault((out[-1], new_tok), set()).add(wi)
                        touched.add((out[-1], new_tok))
                    out.append(new_tok)
                    i += 2
                    changed = True
                else:
                    if out and out[-1] == new_tok:
                        pair_counts[(new_tok, syms[i])] += f
                        pair_words.setdefault((new_tok, syms[i]), set()).add(wi)
                        touched.add((new_tok, syms[i]))
                    out.append(syms[i])
                    i += 1
            if changed:
                words[wi] = out
        pair_words.pop(pair, None)
        pair_counts.pop(pair, None)

        for p in touched:
            c = pair_counts.get(p, 0)
            if c >= min_frequency and p[0] in vocab and p[1] in vocab:
                heapq.heappush(heap, (*heap_key(p, c), p))

    return ByteLevelBPE(vocab, merges)


def _dec(counter: Counter, key, amount: int) -> None:
    counter[key] -= amount
    if counter[key] <= 0:
        counter.pop(key, None)


def train_bpe_files(
    captions: Iterable[str],
    vocab_size: int,
    vocab_path: str,
    merges_path: str,
    special_tokens: Sequence[str] = (),
    min_frequency: int = 2,
) -> ByteLevelBPE:
    """Train + save in the HF-compatible vocab.json/merges.txt layout."""
    bpe = train_bpe(captions, vocab_size, special_tokens, min_frequency)
    os.makedirs(os.path.dirname(vocab_path) or ".", exist_ok=True)
    bpe.save(vocab_path, merges_path)
    return bpe
