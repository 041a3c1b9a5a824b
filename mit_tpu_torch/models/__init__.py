"""Models: vision tower, decoder, assembly, weight conversion."""
