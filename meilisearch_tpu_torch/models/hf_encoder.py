"""In-process text embedding.

Reference behavior: milli vector/embedder/hf.rs — a BERT-family checkpoint
pulled from the hub, tokenized, mean/CLS-pooled, optionally L2-normalized;
used for both indexing-time document embeddings and search-time query
embeddings (LRU-cached upstream). Zero-egress deployments can point
`model` at a local path.

This is the torch branch of the JAX package's encoder, on the CPU. Its
Flax branch (a jitted forward on the accelerator, K8) becomes a torch
forward on CUDA in a later slice of the port.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


class TextEncoder:
    def __init__(
        self,
        model_name: str,
        pooling: str = "useModel",  # useModel|forceMean|forceCls
        max_len: int = 512,
    ):
        self.model_name = model_name
        self.pooling = pooling
        self.max_len = max_len
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._tokenizer is not None:
            return
        from transformers import AutoModel, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        self._model = AutoModel.from_pretrained(self.model_name)
        self._model.eval()

    def encode(self, texts: list[str], normalize: bool = True) -> np.ndarray:
        self._load()
        tok = self._tokenizer(
            texts,
            return_tensors="pt",
            padding=True,
            truncation=True,
            max_length=self.max_len,
        )
        with torch.no_grad():
            hidden = self._model(**tok).last_hidden_state
            if self.pooling == "forceCls":
                emb = hidden[:, 0].numpy()
            else:
                mask = tok["attention_mask"][:, :, None].to(hidden.dtype)
                emb = ((hidden * mask).sum(1) / mask.sum(1).clamp(1e-9)).numpy()
        emb = emb.astype(np.float32)
        if normalize:
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            emb = emb / norms
        return emb


@lru_cache(maxsize=4)
def encoder(model_name: str, pooling: str) -> TextEncoder:
    return TextEncoder(model_name, pooling)


def encode_text(
    model_name: str, text: str, pooling: str = "useModel"
) -> Optional[np.ndarray]:
    return encoder(model_name, pooling).encode([text])[0]
