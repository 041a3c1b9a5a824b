"""Host ms around ``Captioner.generate_from_memory``, up to and including
its tokens on the host, synchronized at both ends; the mean over the
traced run's batches."""

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("batch.decode")
