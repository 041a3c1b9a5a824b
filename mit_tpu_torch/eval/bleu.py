"""Corpus BLEU-4 (Papineni et al. 2002) with multiple references (the
port's copy of ``mit_tpu/eval/bleu.py``, held to it exactly by
``tests/test_torch_eval.py``).

A dependency-free corpus BLEU plus a batched evaluation over the
validation split, which takes the port's ``Captioner``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
) -> float:
    """Corpus-level BLEU with clipped modified precision + brevity penalty.

    hypotheses[i]: token list; references[i]: list of token lists.
    """
    assert len(hypotheses) == len(references)
    match = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp = list(hyp)
        hyp_len += len(hyp)
        # closest reference length (ties → shorter), per the original paper
        lens = sorted((abs(len(r) - len(hyp)), len(r)) for r in refs)
        ref_len += lens[0][1] if lens else 0
        for n in range(1, max_n + 1):
            hc = _ngrams(hyp, n)
            if not hc:
                continue
            max_ref = Counter()
            for r in refs:
                rc = _ngrams(list(r), n)
                for g, c in rc.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            match[n - 1] += sum(min(c, max_ref[g]) for g, c in hc.items())
            total[n - 1] += sum(hc.values())

    if min(total) == 0 or min(match) == 0:
        return 0.0
    log_prec = sum(math.log(m / t) for m, t in zip(match, total)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(1, hyp_len))
    return bp * math.exp(log_prec)


def bleu4(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]]
) -> float:
    """String-level convenience: whitespace tokenization, lowercased."""
    h = [hyp.lower().split() for hyp in hypotheses]
    r = [[ref.lower().split() for ref in refs] for refs in references]
    return corpus_bleu(h, r)


# ----------------------------------------------------------------------
def evaluate_captioner(
    captioner,
    image_paths: Sequence[str],
    references: Dict[str, List[str]],
    batch_size: int = 32,
    method: str = "greedy",
    max_images: int = 0,
) -> Dict[str, float]:
    """Caption unique images in batches and score corpus BLEU-4.

    ``references`` maps image path → list of ground-truth captions
    (the dataset's captions.json entries).
    """
    from PIL import Image

    unique = list(dict.fromkeys(image_paths))
    if max_images:
        unique = unique[:max_images]
    hyps: List[str] = []
    refs: List[List[str]] = []
    for i in range(0, len(unique), batch_size):
        chunk = unique[i : i + batch_size]
        images = []
        for p in chunk:
            with Image.open(p) as im:
                images.append(im.convert("RGB"))
        caps = captioner.caption_batch(images, method=method)
        for p, c in zip(chunk, caps):
            hyps.append(c)
            refs.append(references[p])
    from mit_tpu_torch.eval.cider import cider_d

    return {
        "bleu4": bleu4(hyps, refs),
        "cider_d": cider_d(hyps, refs),
        "num_images": len(unique),
        "mean_caption_len": (
            sum(len(h.split()) for h in hyps) / max(1, len(hyps))
        ),
    }
