"""Caption quality: corpus BLEU-4 and CIDEr-D (copies of ``mit_tpu.eval``,
which is pure Python; the port imports nothing of the JAX package)."""
