"""The fused decode layer's share of its roofline on the service path: the
least time the decoder's layers could take over the windows of the
profiled stretch (for every micro-step and layer: the weights, and for
each slot live at that step its rows and its two caches up to its own
position, read once; bound by bytes at these shapes), counted by the
serving loop from the slots it saw live (``serve.decode_layer_bound_ms``),
over the profiler's device time of the kernels this file's patterns
match."""

TRAFFIC = ("serve_open_loop",)
MOVES = "latency_p95_ms"
UNIT = "%"
PATTERNS = ("decode_layer_kernel",)


def read(r):
    n, secs = r.matched(PATTERNS)
    bound_ms = r.profiled.get("serve.decode_layer_bound_ms", 0.0)
    if n == 0 or secs <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 / secs
