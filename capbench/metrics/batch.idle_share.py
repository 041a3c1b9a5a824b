"""Share of the profiled stretch of a batch window in which no kernel or
copy ran on the card (the union of the profiler's device intervals)."""

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "%"


def read(r):
    if not r.window_s or r.busy_s is None:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
