"""Data: host-side image preprocessing."""
