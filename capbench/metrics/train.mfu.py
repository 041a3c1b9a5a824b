"""Forward and backward FLOPs of the decoder and projection over the steps
issued in the profiled stretch (the device drained at both ends) over its
length and the card's bf16 peak (989 TFLOP/s, H100 SXM), from the batch's
shapes (``capbench/arith.py``)."""

from capbench import arith

TRAFFIC = ("train_steps",)
MOVES = "train_images_per_s"
UNIT = "%"


def read(r):
    flops = r.profiled.get("train.flops", 0.0)
    if not r.window_s or flops <= 0:
        return None
    return 100.0 * flops / (r.window_s * arith.PEAK_BF16)
