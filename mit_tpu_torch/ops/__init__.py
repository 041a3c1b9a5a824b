"""Compute primitives: masks, positional table, attention, flash_attention_btd."""
