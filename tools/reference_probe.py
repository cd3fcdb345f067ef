#!/usr/bin/env python3
"""Probe which model types the JAX package's encoder embeds.

    python3 tools/reference_probe.py [model_type ...]

For each model type (by default the candidates ROADMAP queue 1 lists), a
2-layer model at small widths (hidden 64, 4 heads; the type's other
defaults) is built from transformers' config class, its weights drawn
from a seeded torch generator, and saved with `save_pretrained` as
pytorch_model.bin beside a WordPiece vocab.txt saved by
`BertTokenizerFast` (every type meets the same neutral vocabulary). Its
tokenizer_config.json names the inputs the type's own tokenizer class
gives (`model_input_names`, from AutoTokenizer's mapping: GPT-2's,
BLOOM's, BART's and most decoders' classes give no token types, and a
model that takes none raises when handed BERT's). The
JAX package's `FlaxTextEncoder` then encodes a padded batch of four texts
from the directory, under mean pooling and under forceCls: the type
embeds if both give finite vectors. Prints one line a type: which branch
the encoder took (Flax, or transformers' torch model on the CPU), or the
exception it raised. Needs jax and transformers (the CPU environment);
nothing is downloaded.
"""

from __future__ import annotations

import os
import string
import sys
import tempfile
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ROADMAP queue 1 item 2: the types the reference embeds and the port still
# refuses, in the queue's order
CANDIDATES = ("bart", "falcon", "stablelm", "gpt2", "opt", "phi", "gpt_bigcode", "mpt",
              "starcoder2", "olmo", "olmo2", "granite", "cohere", "exaone4", "olmoe",
              "granitemoe", "phimoe", "dbrx", "deberta", "convbert", "nezha", "luke", "ibert",
              "roc_bert")
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 96, "max_position_embeddings": 512}
# per type: what a 64-wide, 2-layer model needs besides SMALL
EXTRA = {
    "gemma2": {"num_key_value_heads": 2, "head_dim": 16},
    "gemma": {"num_key_value_heads": 2, "head_dim": 16},
    "phi3": {"num_key_value_heads": 2, "pad_token_id": 0},
    "longformer": {"attention_window": 8},
    "big_bird": {"block_size": 4, "num_random_blocks": 2},
    "gpt_neo": {"num_layers": 2, "attention_types": [[["global", "local"], 1]]},
    "gptj": {"rotary_dim": 8},
    "mixtral": {"num_key_value_heads": 2, "num_local_experts": 4, "num_experts_per_tok": 2},
    "qwen2_moe": {"num_key_value_heads": 2, "num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64},
    "qwen3_moe": {"num_key_value_heads": 2, "num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 32},
}
# the inputs a type's published tokenizer_config.json names where its class
# is the generic PreTrainedTokenizerFast (whose default gives token types):
# tiiuae/falcon-7b's
INPUTS = {"falcon": ["input_ids", "attention_mask"]}
TEXTS = ["hello world", "search engine for the cloud " * 12, "", "rust python database"]


def _vocab() -> list:
    words = ["hello", "world", "search", "engine", "for", "the", "cloud", "rust", "python",
             "database"]
    return list(dict.fromkeys(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "<s>", "</s>",
                               "<pad>", *words, *string.ascii_lowercase, *string.digits,
                               *string.punctuation]))


def model_input_names(model_type: str):
    """The `model_input_names` of the type's own tokenizer class (its fast
    class where AutoTokenizer maps one; INPUTS' where the class is the
    generic one), or None for a type it maps none for."""
    import transformers
    from transformers.models.auto.tokenization_auto import TOKENIZER_MAPPING_NAMES

    if model_type in INPUTS:
        return INPUTS[model_type]
    names = [n for n in TOKENIZER_MAPPING_NAMES.get(model_type) or () if n]
    for name in reversed(names):  # the fast class first
        cls = getattr(transformers, name, None)
        if cls is not None:
            return list(cls.model_input_names)
    return None


def probe(model_type: str, root: str) -> str:
    import json

    import torch
    import transformers

    from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder

    vocab = _vocab()
    path = os.path.join(root, model_type)
    os.makedirs(path)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in vocab))
    transformers.BertTokenizerFast(os.path.join(path, "vocab.txt")).save_pretrained(path)
    inputs = model_input_names(model_type)
    if inputs is not None:
        with open(os.path.join(path, "tokenizer_config.json")) as f:
            tok_config = json.load(f)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({**tok_config, "model_input_names": inputs}, f)
    config = transformers.AutoConfig.for_model(
        model_type, vocab_size=len(vocab) + 8, **SMALL, **EXTRA.get(model_type, {}))
    torch.manual_seed(0)
    model = transformers.AutoModel.from_config(config)
    model.save_pretrained(path, safe_serialization=False)
    out = []
    for pooling in ("useModel", "forceCls"):
        enc = FlaxTextEncoder(path, pooling)
        emb = enc.encode(TEXTS)
        branch = "Flax" if enc._flax is not None else f"torch {type(enc._torch).__name__}"
        if emb.shape != (len(TEXTS), SMALL["hidden_size"]) or not np.isfinite(emb).all():
            return f"{model_type}: {pooling} gives {emb.shape}, finite {np.isfinite(emb).all()}"
        out.append(f"{pooling} {branch}")
    return f"{model_type}: embeds ({'; '.join(out)})"


def main() -> int:
    types = sys.argv[1:] or CANDIDATES
    with tempfile.TemporaryDirectory() as root:
        for model_type in types:
            try:
                print(probe(model_type, root), flush=True)
            except Exception as exc:  # noqa: BLE001 - the probe reports any failure
                where = traceback.extract_tb(exc.__traceback__)[-1]
                print(f"{model_type}: raises {type(exc).__name__}: {str(exc)[:200]!r} at"
                      f" {os.path.basename(where.filename)}:{where.lineno}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
