"""Hand counts of the FLOP and byte arithmetic behind the ``*.mfu`` and
``*_roofline`` metrics, at small shapes written out term by term."""

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from capbench import arith  # noqa: E402

TINY = {
    "encoder": {"image_size": 8, "patch_size": 4, "hidden_size": 6,
                "intermediate_size": 10, "num_hidden_layers": 2},
    "decoder": {"embed_dim": 4, "ff_dim": 8, "num_layers": 2,
                "vocab_size": 12},
}


def test_encoder_per_image_cls_memory():
    # 4 patches of 3*4*4 = 48 values, T = 5 tokens, D 6, F 10, 2 layers
    patch = 2 * 4 * 48 * 6                       # 2304
    per_token = 2 * (4 * 36 + 2 * 60)            # 528
    attn = 4 * 5 * 5 * 6                         # 600
    full = 1 * (5 * per_token + attn)            # one full layer: 3240
    last = 2 * 5 * 2 * 36 + 2 * (2 * 36 + 2 * 60) + 4 * 5 * 6   # 720+384+120
    proj = 2 * 1 * 6 * 4                         # CLS row 6 → 4
    assert arith.encoder_flops_per_image(TINY) == patch + full + last + proj


@pytest.mark.parametrize("keys", [1, 3, 7])
def test_decoder_per_token_at_a_cache_length(keys):
    # per layer: QKV + out 4*D*D, FFN 2*D*F, attention 2 products over keys
    per_layer = 2 * (4 * 16 + 2 * 32) + 4 * keys * 4
    logits = 2 * 4 * 12
    assert arith.decoder_flops_per_token(TINY, keys) == 2 * per_layer + logits


def test_decoder_per_caption_sums_its_tokens():
    n = 5
    want = arith.decoder_flops_per_sequence(TINY) + sum(
        arith.decoder_flops_per_token(TINY, j + 1) for j in range(n))
    assert arith.decoder_flops_per_caption(TINY, n) == want
    assert arith.decoder_flops_per_sequence(TINY) == 2 * 2 * 2 * 16


def test_train_step_is_three_forwards():
    b, t = 3, 5
    fwd = b * t * (2 * 2 * (4 * 16 + 2 * 32) + 2 * 4 * 12)   # products
    fwd += 2 * 4 * b * t * t * 4                                # attention
    fwd += b * 2 * 2 * 2 * 16                                   # cross
    fwd += 2 * b * 6 * 4                                        # projection
    assert arith.train_flops_per_step(TINY, b, t) == 3 * fwd


def test_bound_picks_the_larger():
    by_bytes = arith.bound(3.35e9, 1.0, "bf16")
    assert by_bytes["bound_by"] == "bytes"
    assert math.isclose(by_bytes["bound_ms"], 1.0)
    by_ops = arith.bound(1.0, 989e9, "bf16")
    assert by_ops["bound_by"] == "operations"
    assert math.isclose(by_ops["bound_ms"], 1.0)


def test_attention_bound_counts():
    # (b, h, t, s, hd) = (2, 3, 5, 7, 4) in bf16
    nbytes = (2 * 2 * 3 * 5 * 4 + 2 * 2 * 3 * 7 * 4) * 2
    ops = 2 * 2 * 2 * 3 * 5 * 7 * 4
    got = arith.attention_bound(2, 3, 5, 7, "bfloat16", hd=4)
    want = max(nbytes / 3.35e12, ops / 989e12) * 1e3
    assert math.isclose(got["bound_ms"], want)


def test_dropout_attention_bwd_bound_counts():
    # reads q, k, v, the output gradient and the pad row; writes dq, dk, dv
    b, h, t, s, hd = 2, 3, 5, 7, 4
    nbytes = (4 * b * h * t * hd + 2 * b * h * s * hd) * 4 \
        + 2 * b * h * s * hd * 4 + b * s * 4
    ops = 5 * 2 * b * h * t * s * hd
    got = arith.dropout_attention_bwd_bound(b, h, t, s, "float32", hd=hd)
    want = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    assert math.isclose(got["bound_ms"], want)


def test_decode_layer_bound_counts():
    b, t, d, f = 3, 5, 8, 16
    weights = (4 * 64 + 2 * 128) * 2 + (72 + 24 + 16) * 4
    rows = 3 * (8 * 2 + 4 + 5 * 4 + 2 * 5 * 8 * 2 + 8 * 4 + 3 * 8 * 2)
    ops = 2 * 3 * (4 * 64 + 2 * 128) + 4 * 3 * 5 * 8
    got = arith.decode_layer_bound(b, t, "bfloat16", d, f)
    want = max((weights + rows) / 3.35e12, ops / 989e12) * 1e3
    assert math.isclose(got["bound_ms"], want)


def test_decode_layer_bound_over_live_rows_counts():
    keys, d, f = [1, 4, 2], 8, 16
    weights = (4 * 64 + 2 * 128) * 2 + (72 + 24 + 16) * 4
    rows = sum(8 * 2 + 4 + k * 4 + 2 * k * 8 * 2 + 8 * 4 + 3 * 8 * 2
               for k in keys)
    ops = sum(2 * (4 * 64 + 2 * 128) + 4 * k * 8 for k in keys)
    got = arith.decode_layer_bound_rows(keys, "bfloat16", d, f)
    want = max((weights + rows) / 3.35e12, ops / 989e12) * 1e3
    assert math.isclose(got["bound_ms"], want)
    # every row at one length is the whole-batch count
    assert math.isclose(arith.decode_layer_bound_rows([5] * 3, "bfloat16", d,
                                                      f)["bound_ms"],
                        arith.decode_layer_bound(3, 5, "bfloat16", d,
                                                 f)["bound_ms"])


def test_live_keys_of_a_window():
    """Four slots around a window of 3 micro-steps: slot 0 live throughout
    from position 5; slot 1 live from position 2 until its END (a caption
    of 5 tokens, END at position 4); slot 2 admitted in the window and
    still live; slot 3 idle. A request admitted and finished inside the
    window (3 tokens) held a slot that reads idle on both sides."""
    from capbench import core

    serve = core.traffic("serve_open_loop")
    before = ([5, 2, 0, 0], [True, True, False, False],
              [10, 11, None, None])
    after = ([8, 4, 3, 0], [True, False, True, False],
             [10, None, 12, None])
    got = serve.live_keys(before, after, {11: 5, 13: 3}, 3)
    # keys are position + 1 at each micro-step
    assert [sorted(k) for k in got] == [sorted([6, 3, 1, 1]),
                                        sorted([7, 4, 2, 2]),
                                        sorted([8, 3])]


def test_caption_lengths():
    assert arith.caption_length([2, 9, 9, 3, 0, 0], end_id=3) == 4
    assert arith.caption_length([2, 9, 9], end_id=3) == 3
    s = arith.length_summary([4, 2, 10, 6])
    assert (s["n"], s["mean"], s["min"], s["max"]) == (4, 5.5, 2, 10)
