"""Decoding: KV-cached decode step (CLS and full memory), greedy, beam
search, sampling, the continuously batched service, captioning API and
CLI."""
