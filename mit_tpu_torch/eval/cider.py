"""Corpus CIDEr-D (Vedantam et al. 2015, arXiv:1411.5726); the port's copy
of ``mit_tpu/eval/cider.py``, held to it exactly by
``tests/test_torch_eval.py``.

The reference names CIDEr only as future work (reference
presentation_notes.txt:130-134); this implements it for real. CIDEr-D is
the consensus-based captioning metric: per n-gram size n ∈ 1..4, candidate
and reference sentences become TF·IDF vectors (IDF over the reference
corpus, one "document" per image), scored by cosine similarity with the
candidate's n-gram counts clipped to the reference's (repetition gaming
guard) and a Gaussian length penalty (σ = 6); the final score averages
over n and scales by 10 — the cococaption "CIDEr-D" convention.

Dependency-free, mirroring eval/bleu.py's structure.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

SIGMA = 6.0
MAX_N = 4


def _ngram_counts(tokens: Sequence[str], max_n: int = MAX_N) -> List[Counter]:
    """[Counter for n=1 .. max_n]."""
    return [
        Counter(
            tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
        )
        for n in range(1, max_n + 1)
    ]


def _document_frequencies(
    references: Sequence[Sequence[Sequence[str]]], max_n: int = MAX_N
) -> List[Dict[tuple, int]]:
    """df[n][gram] = number of images whose reference SET contains gram."""
    df: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    for refs in references:
        seen = [set() for _ in range(max_n)]
        for ref in refs:
            for n_idx, counts in enumerate(_ngram_counts(ref, max_n)):
                seen[n_idx].update(counts)
        for n_idx in range(max_n):
            for gram in seen[n_idx]:
                df[n_idx][gram] += 1
    return df


def _tfidf(counts: Counter, df: Dict[tuple, int], log_n_images: float):
    """gram → tf·idf, plus the vector's L2 norm and total token length."""
    vec = {}
    norm_sq = 0.0
    for gram, tf in counts.items():
        idf = max(0.0, log_n_images - math.log(max(1.0, df.get(gram, 0))))
        w = tf * idf
        vec[gram] = w
        norm_sq += w * w
    return vec, math.sqrt(norm_sq)


def corpus_cider_d(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = MAX_N,
    sigma: float = SIGMA,
) -> float:
    """Mean CIDEr-D over the corpus.

    hypotheses[i]: token list; references[i]: list of token lists for the
    same image. IDF statistics come from ``references`` itself (the
    standard protocol — the eval split is the corpus).
    """
    assert len(hypotheses) == len(references) and hypotheses
    n_images = len(references)
    log_n = math.log(max(1, n_images))
    df = _document_frequencies(references, max_n)

    total = 0.0
    for hyp, refs in zip(hypotheses, references):
        hyp_counts = _ngram_counts(hyp, max_n)
        score_n = [0.0] * max_n
        for ref in refs:
            ref_counts = _ngram_counts(ref, max_n)
            len_penalty = math.exp(
                -((len(hyp) - len(ref)) ** 2) / (2.0 * sigma * sigma)
            )
            for n_idx in range(max_n):
                hvec, hnorm = _tfidf(hyp_counts[n_idx], df[n_idx], log_n)
                rvec, rnorm = _tfidf(ref_counts[n_idx], df[n_idx], log_n)
                if hnorm == 0.0 or rnorm == 0.0:
                    continue
                # clipped cosine: candidate counts capped at the reference's
                sim = sum(
                    min(w, rvec[g]) * rvec[g]
                    for g, w in hvec.items()
                    if g in rvec
                )
                score_n[n_idx] += len_penalty * sim / (hnorm * rnorm)
        m = max(1, len(refs))
        total += 10.0 * sum(s / m for s in score_n) / max_n
    return total / n_images


def cider_d(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]]
) -> float:
    """String-level convenience: whitespace tokenization, lowercased
    (consistent with eval/bleu.py::bleu4)."""
    h = [hyp.lower().split() for hyp in hypotheses]
    r = [[ref.lower().split() for ref in refs] for refs in references]
    return corpus_cider_d(h, r)
