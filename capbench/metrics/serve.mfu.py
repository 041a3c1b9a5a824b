"""Model FLOPs of the profiled stretch over its length and the card's bf16
peak (989 TFLOP/s, H100 SXM): every image encoded in it (encoder and
projection, CLS memory) and every caption completed in it (its cross
constant and each token at its own number of keys), from the
configuration's shapes (``capbench/arith.py``)."""

from capbench import arith

TRAFFIC = ("serve_open_loop",)
MOVES = "latency_p95_ms"
UNIT = "%"


def read(r):
    if not r.window_s:
        return None
    flops = r.profiled.get("serve.encode_flops", 0.0) + \
        r.profiled.get("serve.decode_flops", 0.0)
    if flops <= 0:
        return None
    return 100.0 * flops / (r.window_s * arith.PEAK_BF16)
