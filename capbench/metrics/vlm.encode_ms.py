"""Host ms around the upload of a batch of uint8 images, ``device_preprocess``
and ``Captioner.memory_from_pixels`` (the vision tower and the projector),
synchronized at both ends; the mean over the traced run's batches."""

TRAFFIC = ("vlm_batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("vlm.encode")
