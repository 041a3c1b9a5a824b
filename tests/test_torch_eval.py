"""Port parity: the caption-quality scorers of mit_tpu_torch (its own copies
of ``mit_tpu.eval``) give exactly the JAX package's scores on seeded
corpora: corpus BLEU-4 and CIDEr-D, token-level and string-level, with one
to five references an image, empty and repeated hypotheses among them."""

import numpy as np
import pytest

from mit_tpu.eval import bleu as jbleu
from mit_tpu.eval import cider as jcider
from mit_tpu_torch.eval import bleu as tbleu
from mit_tpu_torch.eval import cider as tcider

WORDS = ("a dog cat man woman runs sits on the grass red ball street blue "
         "shirt with two young plays in front of water").split()


def _corpus(seed, n=40):
    """n images: a hypothesis and 1-5 references each, drawn from a small
    vocabulary so that n-grams repeat across images."""
    r = np.random.default_rng(seed)
    sent = lambda lo, hi: [WORDS[i] for i in r.integers(0, len(WORDS),
                                                         r.integers(lo, hi))]
    hyps, refs = [], []
    for i in range(n):
        rs = [sent(3, 14) for _ in range(r.integers(1, 6))]
        h = list(rs[0][: r.integers(1, len(rs[0]) + 1)]) + sent(0, 5)
        if i % 9 == 4:
            h = []                               # an empty hypothesis
        elif i % 9 == 7:
            h = (h[:2] or ["a"]) * 4             # a repetitive one
        hyps.append(h)
        refs.append(rs)
    return hyps, refs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corpus_scores_equal_the_jax_package(seed):
    hyps, refs = _corpus(seed)
    for n in (1, 2, 4):
        assert tbleu.corpus_bleu(hyps, refs, n) == jbleu.corpus_bleu(hyps, refs, n)
    assert tcider.corpus_cider_d(hyps, refs) == jcider.corpus_cider_d(hyps, refs)
    assert tcider.corpus_cider_d(hyps, refs, 2, 3.0) == \
        jcider.corpus_cider_d(hyps, refs, 2, 3.0)
    score = tbleu.corpus_bleu(hyps, refs)
    assert 0.0 < score < 1.0 and tcider.corpus_cider_d(hyps, refs) > 0.0


@pytest.mark.parametrize("seed", [4, 5])
def test_string_scores_equal_the_jax_package(seed):
    hyps, refs = _corpus(seed, 25)
    up = lambda ws: " ".join(w.upper() if i % 3 == 0 else w
                             for i, w in enumerate(ws))
    h = [up(x) for x in hyps]
    r = [[up(x) for x in rs] for rs in refs]
    assert tbleu.bleu4(h, r) == jbleu.bleu4(h, r)
    assert tcider.cider_d(h, r) == jcider.cider_d(h, r)
    # a perfect corpus, and a disjoint one
    assert tbleu.bleu4(["a cat sat on the mat"], [["a cat sat on the mat"]]) \
        == jbleu.bleu4(["a cat sat on the mat"], [["a cat sat on the mat"]])
    assert tbleu.bleu4(["x y z w"], [["a b c d"]]) == 0.0
