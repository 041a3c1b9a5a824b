"""Port parity of the small helpers: ``combine_causal_and_padding``
(``ops/masks.py``), ``add_positional`` (``ops/positional.py``) and the
uncached greedy oracle (``decode/greedy.py``) against ``mit_tpu`` on the
CPU, on inputs from a numpy seed.

The masks and the positional add are bitwise equal to the JAX package's in
f32. The uncached greedy loop gives the tokens of the port's KV-cached
``greedy_generate`` and of the JAX package's ``greedy_generate_uncached``
on the same weights, with captions that end at two lengths (the END
logit's bias raised) beside captions that run to ``max_len``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import greedy as jgreedy
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu.ops import masks as jmasks
from mit_tpu.ops import positional as jpos
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.ops import masks as tmasks
from mit_tpu_torch.ops import positional as tpos

V, D, H, L, F, MAXLEN = 40, 32, 4, 2, 48, 12
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)


def _tokens(seed=0, b=3, t=7):
    """Token rows with PADs inside and at the end."""
    toks = np.random.default_rng(seed).integers(1, V, (b, t)).astype(np.int64)
    toks[0, 4:] = PAD
    toks[1, 2] = PAD
    return toks


@pytest.mark.parametrize("pad_idx", [0, 5])
def test_combine_causal_and_padding_matches_jax_bitwise(pad_idx):
    toks = _tokens()
    toks[2, 3] = 5
    want = np.asarray(jmasks.combine_causal_and_padding(
        toks.shape[1], jnp.asarray(toks), pad_idx))
    got = tmasks.combine_causal_and_padding(toks.shape[1],
                                            torch.from_numpy(toks), pad_idx)
    assert got.dtype == torch.float32 and got.shape == (3, 1, 7, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    # a key that is PAD is masked in every query row; a later key too
    keys = toks == pad_idx
    assert (got.numpy()[:, 0][np.broadcast_to(keys[:, None, :], (3, 7, 7))]
            <= tmasks.NEG_INF).all()


@pytest.mark.parametrize("t,d", [(5, 32), (12, 6)])
def test_add_positional_matches_jax_bitwise(t, d):
    x = np.random.default_rng(t).normal(size=(2, t, d)).astype(np.float32)
    jtable, ttable = jpos.sinusoid_table(16, d), tpos.sinusoid_table(16, d)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(jtable))
    want = np.asarray(jpos.add_positional(jnp.asarray(x), jtable))
    got = tpos.add_positional(torch.from_numpy(x), ttable)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # in x's dtype
    assert tpos.add_positional(torch.from_numpy(x).bfloat16(),
                               ttable).dtype == torch.bfloat16


@pytest.mark.parametrize("end_bias", [0.0, 0.5], ids=["to_max_len", "ends"])
def test_greedy_uncached_matches_cached_and_jax(end_bias):
    """The oracle's tokens are the cached loop's and the JAX oracle's."""
    params = jax.tree.map(np.asarray, init_decoder_params(
        jax.random.PRNGKey(3), JDecoderConfig(**KW)))
    params["fc_out_b"] = params["fc_out_b"].copy()
    params["fc_out_b"][END] += end_bias
    memory = np.random.default_rng(11).normal(size=(4, 1, D)).astype(
        np.float32)
    want = np.asarray(jgreedy.greedy_generate_uncached(
        params, JDecoderConfig(**KW), jnp.asarray(memory), START, END, PAD,
        MAXLEN))
    cfg, tp = DecoderConfig(**KW), params_from_jax(params)
    got = tgreedy.greedy_generate_uncached(tp, cfg, torch.from_numpy(memory),
                                           START, END, PAD, MAXLEN)
    cached, lengths = tgreedy.greedy_generate(tp, cfg,
                                              torch.from_numpy(memory),
                                              START, END, PAD, MAXLEN)
    assert got.dtype == torch.int64 and got.shape == (4, MAXLEN)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), cached.numpy())
    ended = (got == END).any(dim=1)
    if end_bias:
        # rows end at two lengths while the others run on; after END a row
        # holds PAD
        stops = [row.tolist().index(END) for row in got[ended]]
        assert len(set(stops)) == 2 and not ended.all(), got
        for row, stop in zip(got[ended], stops):
            assert (row[stop + 1:] == PAD).all()
    else:
        assert not ended.any() and (lengths == MAXLEN).all()
