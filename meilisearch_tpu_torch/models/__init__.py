"""Embedding model wrappers — the engine's "model families".

Reference: milli's huggingFace embedder runs candle BERT inference
in-process (vector/embedder/hf.rs); here a BERT, RoBERTa, XLM-RoBERTa,
DistilBERT, MPNet or ModernBERT checkpoint directory is read, tokenized
and run by the port's own modules (checkpoint.py; wordpiece.py,
unigram.py or bpe.py over unicode.py's tables; bert.py or modernbert.py)
on the store's device.
"""

from .hf_encoder import TextEncoder, encode_text

__all__ = ["TextEncoder", "encode_text"]
