"""Runbooks run as ``python -m mit_tpu_torch.tools.<name>``."""
