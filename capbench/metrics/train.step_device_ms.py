"""Device-busy ms a training step: the union of the profiler's kernel and
copy intervals in the profiled stretch over the steps issued in it (the
device drained at both ends)."""

TRAFFIC = ("train_steps",)
MOVES = "train_images_per_s"
UNIT = "ms"


def read(r):
    steps = r.profiled.get("train.steps", 0)
    if r.busy_s is None or steps <= 0:
        return None
    return 1e3 * r.busy_s / steps
