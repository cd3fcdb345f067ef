"""In-process text embedding on the store's device (K8).

Reference behavior: milli vector/embedder/hf.rs — a BERT-family checkpoint
pulled from the hub, tokenized, mean/CLS-pooled, optionally L2-normalized;
used for both indexing-time document embeddings and search-time query
embeddings (LRU-cached upstream). Zero-egress deployments point `model`
at a local path.

The JAX package runs transformers' Flax model under `jax.jit` (its
`FlaxTextEncoder`), or transformers' torch model on the CPU when the
checkpoint has no Flax weights. The port computes the same function with
its own pieces and no transformers: the checkpoint directory is read by
models/checkpoint.py, texts are tokenized on the host by
models/wordpiece.py or, for a Unigram tokenizer.json (XLM-R's vocabulary),
models/unigram.py, and models/bert.py's `BertModel` (BERT, RoBERTa and
XLM-RoBERTa) runs on the device
under `torch.inference_mode()`. Pooling is the JAX package's (`forceCls`:
the first token's state; otherwise the mean over the attention mask), and
the result is L2-normalized in numpy exactly as there. Only a local
checkpoint directory is read: nothing is downloaded.

`device=None` is the CPU, the host pass. On a CUDA device a failure
raises; nothing is retried on the CPU.
"""

from __future__ import annotations

import threading
import time
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..ops.chain_keys import LaunchCounter
from .checkpoint import build_model, build_tokenizer, load_checkpoint

# Texts per forward pass. 256 texts of 128 tokens give each linear layer
# 32,768 rows, enough to fill the card; at the 512-token limit, the largest
# live tensors of a bge-base pass, the (256, 12, 512, 512) float32 scores
# and their softmax, take 3.2 GB each. On a CUDA device the chunk shrinks
# until its worst case fits a quarter of the free memory.
CHUNK_TEXTS = 256
FORWARDS = LaunchCounter()  # encoder forward passes, any device


class TextEncoder:
    def __init__(
        self,
        model_name: str,
        pooling: str = "useModel",  # useModel|forceMean|forceCls
        device: Optional[torch.device] = None,
        max_len: int = 512,
    ):
        self.model_name = model_name
        self.pooling = pooling
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.max_len = max_len
        # texts, their real (unpadded) tokens, the wall seconds encoded and
        # the host seconds of it spent tokenizing
        self.texts = self.tokens = 0
        self.seconds = self.tokenize_seconds = 0.0
        self._model = None
        self._tokenizer = None
        self._lock = threading.Lock()

    def _load(self) -> None:
        with self._lock:
            if self._model is not None:
                return
            ckpt = load_checkpoint(self.model_name)
            self._tokenizer = build_tokenizer(ckpt)
            self._model = build_model(ckpt).to(self.device)

    def chunk_texts(self) -> int:
        """Texts per forward pass on this encoder's device."""
        if self.device.type != "cuda":
            return CHUNK_TEXTS
        c = self._model.config
        L, heads = self.max_len, c["num_attention_heads"]
        # per text at max_len: scores, their bias sum and softmax, and the
        # hidden, intermediate and projection activations, float32
        per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
        free, _total = torch.cuda.mem_get_info(self.device)
        return max(1, min(CHUNK_TEXTS, free // 4 // per_text))

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Pooled (B, hidden) float32 on the device for host-tokenized ids."""
        ids, mask = self._upload(input_ids), self._upload(attention_mask)
        with torch.inference_mode():
            FORWARDS.add()
            hidden = self._model(ids, mask)
            if self.pooling == "forceCls":
                return hidden[:, 0]
            m = mask[:, :, None].to(hidden.dtype)
            return (hidden * m).sum(1) / m.sum(1).clamp(min=1e-9)

    def encode(self, texts: list, normalize: bool = True) -> np.ndarray:
        t0 = time.perf_counter()
        self._load()
        hidden = self._model.config["hidden_size"]
        emb = np.empty((len(texts), hidden), np.float32)
        step = self.chunk_texts()
        tokens = 0
        tokenize_s = 0.0
        for s in range(0, len(texts), step):
            t = time.perf_counter()
            ids, mask = self._tokenizer(texts[s : s + step], self.max_len)
            tokenize_s += time.perf_counter() - t
            tokens += int(mask.sum())
            emb[s : s + len(ids)] = self.forward(ids, mask).float().cpu().numpy()
        with self._lock:
            self.texts += len(texts)
            self.tokens += tokens
            self.seconds += time.perf_counter() - t0
            self.tokenize_seconds += tokenize_s
        if normalize:
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            emb = emb / norms
        return emb


@lru_cache(maxsize=4)
def encoder(model_name: str, pooling: str, device: Optional[torch.device] = None) -> TextEncoder:
    return TextEncoder(model_name, pooling, device)


def encode_text(
    model_name: str, text: str, pooling: str = "useModel",
    device: Optional[torch.device] = None,
) -> Optional[np.ndarray]:
    return encoder(model_name, pooling, device).encode([text])[0]
