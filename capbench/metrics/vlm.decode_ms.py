"""Host ms around ``Captioner.generate_from_memory`` of a batch: the
prefill over image tokens and prompt, the decode steps and the tokens read
back, synchronized at both ends; the mean over the traced run's batches."""

TRAFFIC = ("vlm_batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "ms"


def read(r):
    return r.span_mean_ms("vlm.decode")
