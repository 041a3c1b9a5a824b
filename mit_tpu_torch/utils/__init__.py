"""Utilities: profiling and step timing."""
