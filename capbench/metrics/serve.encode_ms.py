"""Host ms around the upload, ``device_preprocess`` and
``memory_from_pixels`` of each chunk of arrived images, synchronized at
both ends; the mean over every chunk of the traced run (the chunk sizes
are on an earlier line)."""

TRAFFIC = ("serve_open_loop",)
MOVES = "latency_p95_ms"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("serve.encode")
