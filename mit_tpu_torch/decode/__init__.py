"""Decoding: KV-cached greedy decode, captioning API and CLI."""
