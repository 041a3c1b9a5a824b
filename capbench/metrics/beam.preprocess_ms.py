"""Under beam search: host ms around the upload of a batch of uint8 images
from pageable host memory and ``device_preprocess``, synchronized at both
ends; the mean over the traced run's batches."""

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s.beam"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("batch.preprocess")
