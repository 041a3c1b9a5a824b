"""Under beam search: host ms around ``Captioner.memory_from_pixels`` (the
encoder and the projection) of a batch, synchronized at both ends; the mean
over the traced run's batches."""

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s.beam"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("batch.encode")
