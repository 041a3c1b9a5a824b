"""The plain reference of the benchmark: float32 PyTorch written from the
models' published descriptions, with no kernel, cache or batching trick.
It imports nothing of the program under test (``mit_tpu_torch``) and
takes no tensor the program derived: it works every derived quantity out
again from the inputs the benchmark made."""
