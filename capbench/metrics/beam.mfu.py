"""Under beam search: model FLOPs of the batches completed in the profiled
stretch over its length and the card's bf16 peak (989 TFLOP/s, H100 SXM):
each image's encoder and projection (CLS memory) and each caption's decoder
tokens at their own number of keys (times the beams under beam search), from
the configuration's shapes (``capbench/arith.py``)."""

from capbench import arith

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s.beam"
UNIT = "%"


def read(r):
    flops = r.profiled.get("batch.flops", 0.0)
    if not r.window_s or flops <= 0:
        return None
    return 100.0 * flops / (r.window_s * arith.PEAK_BF16)
