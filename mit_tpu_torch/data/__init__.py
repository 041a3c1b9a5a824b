"""Data: image preprocessing (host and device), the dataset, preparation."""
