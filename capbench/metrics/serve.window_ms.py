"""Host ms around ``CaptionService.step()`` (admissions and a window of
``steps_per_sync`` tokens, ending in its read-back), synchronized at both
ends; the mean over every window of the traced run."""

TRAFFIC = ("serve_open_loop",)
MOVES = "latency_p95_ms"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("serve.window")
