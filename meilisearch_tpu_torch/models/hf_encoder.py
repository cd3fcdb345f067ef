"""In-process text embedding on the store's device (K8).

Reference behavior: milli vector/embedder/hf.rs — an encoder (BERT's
families, Longformer, ALBERT, RoFormer, ModernBERT, DeBERTa-v2,
MobileBERT, SqueezeBERT, XLM, FlauBERT, XLNet) or decoder (Qwen3,
Qwen2, Llama, Mistral, Gemma, Phi-3, Gemma 2, Gemma 3, GPT-Neo, GPT-J,
BLOOM, GPT-NeoX, and the mixture-of-experts Mixtral, Qwen2-MoE and Qwen3-MoE)
checkpoint pulled from the hub, tokenized,
mean/CLS-pooled, optionally L2-normalized;
used for both indexing-time document embeddings and search-time query
embeddings (LRU-cached upstream). Zero-egress deployments point `model`
at a local path.

The JAX package runs transformers' Flax model under `jax.jit` (its
`FlaxTextEncoder`), or transformers' torch model on the CPU when the
checkpoint has no Flax weights. The port computes the same function with
its own pieces and no transformers: the checkpoint directory is read by
models/checkpoint.py, texts are tokenized on the host by
models/wordpiece.py, or, for XLM's and FlauBERT's vocab.json +
merges.txt, models/xlm_bpe.py (Moses, models/moses.py, then a `</w>`
BPE), or, for a Unigram tokenizer.json (XLM-R's, CamemBERT's,
DeBERTa-v3's, ALBERT's, RemBERT's, XLNet's and BigBird's vocabularies),
models/unigram.py, or, for
a BPE (RoBERTa's and Longformer's, ModernBERT's, Qwen2's, Llama-3's, GPT-2's,
BLOOM's and GPT-NeoX's byte-level one;
Llama-2's, Mistral's, Phi-3's and Gemma's with byte fallback), models/bpe.py
(WordPiece, Unigram and BPE with `tokenizers`' own Unicode tables,
models/unicode.py), and models/bert.py's `BertModel` (BERT, RoBERTa,
XLM-RoBERTa, CamemBERT, data2vec-text, XLM-RoBERTa-XL, DistilBERT,
MPNet, ELECTRA, ERNIE, BertGeneration, RemBERT, Megatron-BERT and
BigBird, its block-sparse attention in models/big_bird.py),
models/longformer.py's `LongformerModel`,
models/albert.py's
`AlbertModel`, models/roformer.py's `RoFormerModel`,
models/modernbert.py's `ModernBertModel`, models/deberta_v2.py's
`DebertaV2Model`, models/mobilebert.py's `MobileBertModel`,
models/squeezebert.py's `SqueezeBertModel`, models/xlm.py's `XLMModel`
(XLM and FlauBERT),
models/xlnet.py's `XLNetModel`, models/decoder.py's `DecoderModel`
(Qwen3, Qwen2, Llama, Mistral, Gemma and Phi-3; Mixtral, Qwen2-MoE and
Qwen3-MoE with models/moe.py's sparse block), models/gemma2.py's
`Gemma2Model` (bge-multilingual-gemma2), models/gemma3.py's
`Gemma3Model` (Gemma 3's text stack, EmbeddingGemma), models/gpt_neo.py's
`GPTNeoModel` and models/gptj.py's `GPTJModel` (the SGPT embedders),
models/bloom.py's `BloomModel` (sgpt-bloom, udever-bloom) or
models/gpt_neox.py's `GPTNeoXModel` (Pythia, the BMRetriever embedders) runs on the device
under `torch.inference_mode()`. Pooling is the JAX package's (`forceCls`:
the first token's state, a pad's under left padding, as there; otherwise
the mean over the attention mask), and the result is L2-normalized in
numpy exactly as there (under `forceCls` with left padding, under a
`longrope` or `dynamic` rotary, for a block-sparse BigBird, and for
GPT-Neo, GPT-J and GPT-NeoX under left padding, every chunk of a call is padded to
the call's longest text, as the JAX package pads its one batch: a pad's
state can depend on how far it pads, those rotaries' frequencies on the
padded length, BigBird's choice of sparse attention and its blocks'
layout too, and GPT-Neo's, GPT-J's and GPT-NeoX's positions count from
the padded start; the Llama and Gemma tokenizer classes pad on the left by
default, BLOOM's published files ask for it). The JAX
package passes every output of its
tokenizer to the torch model (`**tok`), token types included; the port
passes them to the models that read them (XLNet, XLM, FlauBERT; GPT-Neo
and GPT-J add their `wte` rows, BLOOM refuses them), as `tokenize` gives
them. Only a local
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
from . import bloom, gpt_neo, gpt_neox, gptj, longformer, moe, squeezebert, xlnet
from .bert import RELATIVE_KEYS
from .checkpoint import build_model, build_tokenizer, gives_token_types, load_checkpoint
from .deberta_v2 import attention_span
from .decoder import MODEL_TYPES as DECODER_TYPES
from .gemma2 import MODEL_TYPE as GEMMA2_TYPE
from .gemma3 import MODEL_TYPE as GEMMA3_TYPE
from .rope import BATCH_LENGTH_ROPES

# Texts per forward pass. 256 texts of 128 tokens give each linear layer
# 32,768 rows, enough to fill the card; at the 512-token limit, the largest
# live tensors of a bge-base pass, the (256, 12, 512, 512) float32 scores
# and their softmax, take 3.2 GB each. On a CUDA device the chunk shrinks
# until its worst case fits a quarter of the free memory.
CHUNK_TEXTS = 256
FORWARDS = LaunchCounter()  # encoder forward passes, any device
# model types whose positions count from the padded start of the batch
PADDED_POSITIONS = (gpt_neo.MODEL_TYPE, gptj.MODEL_TYPE, gpt_neox.MODEL_TYPE)


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
        self._types = False  # whether the model is given the tokenizer's token types
        self._lock = threading.Lock()

    def _load(self) -> None:
        with self._lock:
            if self._model is not None:
                return
            ckpt = load_checkpoint(self.model_name)
            self._tokenizer = build_tokenizer(ckpt)
            model = build_model(ckpt)
            self._types = getattr(model, "reads_token_types", False) and gives_token_types(ckpt)
            self._model = model.to(self.device)

    def chunk_texts(self) -> int:
        """Texts per forward pass on this encoder's device."""
        if self.device.type != "cuda":
            return CHUNK_TEXTS
        c = self._model.config
        L, heads = self.max_len, c["num_attention_heads"]
        gated = c.get("model_type") in ("modernbert", *DECODER_TYPES, GEMMA3_TYPE, GEMMA2_TYPE)
        # the feed-forward's widest activation: ModernBERT's GeGLU and the
        # decoders' and Gemma 2's and 3's gated MLPs project to two halves,
        # 2 x intermediate_size (Phi-3's fused gate_up_proj in one tensor)
        ffn = c["intermediate_size"] * (2 if gated else 1)
        # the widest of the hidden width and Q's heads x head_dim (a
        # decoder's head_dim need not be hidden_size / heads)
        width = max(c["hidden_size"], heads * (c.get("head_dim") or 0))
        # per text at max_len: scores, their bias sum and softmax, and the
        # hidden, intermediate and projection activations, float32
        per_text = 4 * (3 * heads * L * L + L * (6 * width + 2 * ffn))
        if c.get("position_embedding_type") in RELATIVE_KEYS:
            # the relative keys' score terms: einsum(Q, pos), and
            # einsum(K, pos) for relative_key_query
            per_text += 4 * heads * L * L * (1 + (c["position_embedding_type"]
                                                  == "relative_key_query"))
        kind = c.get("model_type")
        if kind == "deberta-v2" and c["relative_attention"]:
            # DeBERTa's c2p and p2c: two (heads, L, 2 span) products and
            # their two (heads, L, L) gathers
            per_text += 4 * heads * L * (4 * attention_span(c) + 2 * L)
        if kind == "deberta-v2" and c["conv_kernel_size"] > 0:
            # the ConvLayer's unfolded windows (kernel x hidden) and its output
            per_text += 4 * L * (c["conv_kernel_size"] + 2) * c["hidden_size"]
        elif kind == xlnet.MODEL_TYPE:
            # XLNet's (heads, L, 2L) position scores and their shifted copy,
            # and the segment term (heads, L, L)
            per_text += 4 * heads * L * 5 * L
        elif kind == longformer.MODEL_TYPE:
            # Longformer's (L, L) scores run under a (B, 1, L, L) bool band
            # mask, one for each distinct window, built once a forward
            per_text += L * L * len(set(c["attention_window"]))
        elif kind in (gpt_neo.MODEL_TYPE, gptj.MODEL_TYPE, bloom.MODEL_TYPE):
            # the (B, 1, L, L) float32 additive mask; GPT-Neo's `where` and
            # GPT-J's division make one more score-sized tensor before the
            # mask is added (BLOOM's baddbmm adds its ALiBi in the product)
            per_text += 4 * L * L
            if kind != bloom.MODEL_TYPE:
                per_text += 4 * heads * L * L
        elif kind in moe.MODEL_TYPES:
            # the sparse block's routed rows, up to num_experts_per_tok x L a
            # text (all of them in one expert at worst): each expert's
            # gathered input and output rows and its 2 x expert-wide
            # activation; the shared expert's over every row; the logits
            k, h = c["num_experts_per_tok"], c["hidden_size"]
            per_text += 4 * L * (k * (2 * moe.expert_width(c) + 2 * h) + moe.num_experts(c)
                                 + 2 * c.get("shared_expert_intermediate_size", 0))
        elif kind == gpt_neox.MODEL_TYPE and c["use_parallel_residual"]:
            # the parallel residual holds the attention's output and the
            # MLP's input (its own LayerNorm of the layer's input) at once,
            # two hidden-wide activations beside the six counted (its MLP is
            # not gated: intermediate_size once, above)
            per_text += 4 * L * 2 * c["hidden_size"]
        elif kind == squeezebert.MODEL_TYPE:
            # SqueezeBERT's channel-last copies around each LayerNorm and the
            # grouped products' copies of their inputs
            per_text += 4 * L * (2 * width + ffn)
        # (BigBird's block-sparse attention computes the same (L, L)
        # scores and softmax as the full path, its pattern's log weights
        # added in place: counted above; its (B, 1, L, L) bool pattern
        # mask, L^2 bytes a text, is under 1% of the scores' count;
        # XLM-RoBERTa-XL's 2,560-wide hidden state and 10,240-wide
        # intermediate are the widths above; its pre-norms' outputs are
        # among the 6 hidden-wide activations;
        # MobileBERT's widest activations are its 512-wide hidden state and
        # intermediate_size, each FFN of the stack run after the other, and
        # its 3 x 128 trigram embedding: counted above)
        free, _total = torch.cuda.mem_get_info(self.device)
        return max(1, min(CHUNK_TEXTS, free // 4 // per_text))

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def tokenize(self, texts: list) -> tuple:
        """(input_ids, attention_mask, token_type_ids or None) CPU tensors:
        the types only where the model reads them and transformers'
        tokenizer gives them (XLNet's segment term, XLM's type rows); the
        Unigram tokenizer's are its template's (XLNet's `<cls>` 2, its pad
        3), the others' all zeros."""
        if not self._types:
            return (*self._tokenizer(texts, self.max_len), None)
        if hasattr(self._tokenizer, "encode_types"):
            return self._tokenizer.encode_types(texts, self.max_len)
        ids, mask = self._tokenizer(texts, self.max_len)
        return ids, mask, torch.zeros_like(ids)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pooled (B, hidden) float32 on the device for host-tokenized ids
        (and the token types `tokenize` gives, where it gives them)."""
        ids, mask = self._upload(input_ids), self._upload(attention_mask)
        with torch.inference_mode():
            FORWARDS.add()
            if token_type_ids is None:
                hidden = self._model(ids, mask)
            else:
                hidden = self._model(ids, mask, self._upload(token_type_ids))
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
        whole = None
        rope = getattr(self._model, "rope", None)
        left = getattr(self._tokenizer, "padding_side", "right") == "left"
        if len(texts) > step and (
                (self.pooling == "forceCls" and left)
                or (left and self._model.config.get("model_type") in PADDED_POSITIONS)
                or (rope is not None and rope.kind in BATCH_LENGTH_ROPES)
                or getattr(self._model, "sparse_threshold", None) is not None):
            # forceCls pools position 0, a pad for every text shorter than
            # its batch's longest under left padding, and a pad's state can
            # read the text (XLNet, a bidirectional Gemma 3); GPT-Neo's and
            # GPT-J's positions count from the padded start, so a
            # left-padded text's shift with its batch's longest; a
            # `longrope` or `dynamic` rotary takes its frequencies from the
            # batch's padded length (Phi-3's long factors past
            # original_max_position_embeddings); a block-sparse BigBird runs
            # sparse past its threshold, and its blocks' layout (which block
            # is last, which blocks a row slides over) follows the padded
            # length: each chunk is cut from the call's one padded batch, as
            # the JAX package pads (GPT-NeoX's positions too, though its
            # rotary is relative: a left pad's state and the real tokens'
            # rounding move with them)
            t = time.perf_counter()
            whole = self.tokenize(texts)
            tokenize_s += time.perf_counter() - t
        for s in range(0, len(texts), step):
            t = time.perf_counter()
            if whole is None:
                ids, mask, types = self.tokenize(texts[s : s + step])
            else:
                ids, mask, types = (None if x is None else x[s : s + step] for x in whole)
            tokenize_s += time.perf_counter() - t
            tokens += int(mask.sum())
            emb[s : s + len(ids)] = self.forward(ids, mask, types).float().cpu().numpy()
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
