"""Text subsystem: byte-level BPE tokenization.

Replaces the reference's dependency on the Rust `tokenizers` crate for the
hot encode/decode path (reference tokenizer.py:173, 324-352) with a
first-party byte-level BPE implementation (Python reference implementation +
C++ fast path) that reads/writes the same ``vocab.json``/``merges.txt``
format and produces bit-identical token IDs.
"""

from mit_tpu_torch.text.tokenizer import (
    Tokenizer,
    train_tokenizer,
    get_tokenizer,
    encode_text,
    decode_ids,
    get_tokenizer_vocab_size,
    get_token_id,
)

__all__ = [
    "Tokenizer",
    "train_tokenizer",
    "get_tokenizer",
    "encode_text",
    "decode_ids",
    "get_tokenizer_vocab_size",
    "get_token_id",
]
