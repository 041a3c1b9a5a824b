"""Model FLOPs of the batches completed in the profiled stretch over its
length and the card's bf16 peak (989 TFLOP/s, H100 SXM): each image's
vision tower over every token and the projector, each caption's prefill
and decode tokens at their own key counts (``capbench/arith_vlm.py``)."""

from capbench import arith_vlm

TRAFFIC = ("vlm_batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "%"


def read(r):
    flops = r.profiled.get("vlm.flops", 0.0)
    if not r.window_s or flops <= 0:
        return None
    return 100.0 * flops / (r.window_s * arith_vlm.PEAK_BF16)
