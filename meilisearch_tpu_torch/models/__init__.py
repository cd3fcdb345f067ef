"""Embedding model wrappers — the engine's "model families".

Reference: milli's huggingFace embedder runs candle BERT inference
in-process (vector/embedder/hf.rs); here local inference runs through
transformers' torch models.
"""

from .hf_encoder import TextEncoder, encode_text

__all__ = ["TextEncoder", "encode_text"]
