"""Utilities: profiling, step timing and replay from CUDA graphs."""
