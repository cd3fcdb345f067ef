"""Embedding model wrappers — the engine's "model families".

Reference: milli's huggingFace embedder runs candle BERT inference
in-process (vector/embedder/hf.rs); here a BERT, RoBERTa or XLM-RoBERTa
checkpoint directory is read, tokenized and run by the port's own modules
(checkpoint.py, wordpiece.py or unigram.py, bert.py) on the store's
device.
"""

from .hf_encoder import TextEncoder, encode_text

__all__ = ["TextEncoder", "encode_text"]
