"""Embedding model wrappers — the engine's "model families".

Reference: milli's huggingFace embedder runs candle BERT inference
in-process (vector/embedder/hf.rs); here a BERT, RoBERTa, XLM-RoBERTa,
CamemBERT, DistilBERT, MPNet, ELECTRA, ERNIE, BertGeneration, RemBERT,
Megatron-BERT, ALBERT, RoFormer, ModernBERT, DeBERTa-v2, Qwen3, Qwen2,
Llama, Mistral or Gemma 3 checkpoint directory is read, tokenized and run
by the port's own modules (checkpoint.py; wordpiece.py, unigram.py or
bpe.py over unicode.py's tables; bert.py, albert.py, roformer.py,
modernbert.py, deberta_v2.py, decoder.py or gemma3.py, over rope.py's
rotary tables and activations.py) on the store's device.
"""

from .hf_encoder import TextEncoder, encode_text

__all__ = ["TextEncoder", "encode_text"]
