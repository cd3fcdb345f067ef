"""Read (and write) a local BERT, RoBERTa, XLM-RoBERTa, CamemBERT,
data2vec-text, XLM-RoBERTa-XL, DistilBERT, MPNet, ELECTRA, ERNIE,
BertGeneration, RemBERT, Megatron-BERT, BigBird, Longformer, ALBERT,
RoFormer, ModernBERT, DeBERTa-v2, MobileBERT, SqueezeBERT, XLM, FlauBERT,
XLNet, Qwen3, Qwen2, Llama, Mistral, Gemma, Phi-3, Mixtral, Qwen2-MoE,
Qwen3-MoE, Gemma 2, Gemma 3, GPT-Neo, GPT-J, BLOOM or GPT-NeoX checkpoint
directory without transformers.

A directory as transformers' `save_pretrained` leaves it:
- `config.json`: the model's type and widths (models/bert.py::CONFIG_KEYS,
  or DISTILBERT_KEYS; models/albert.py::CONFIG_KEYS for `albert` and
  models/roformer.py::CONFIG_KEYS for `roformer`, which `build_model`
  gives to `AlbertModel` and `RoFormerModel`;
  models/modernbert.py::CONFIG_KEYS for `modernbert`,
  which `build_model` gives to `ModernBertModel`,
  models/deberta_v2.py::CONFIG_KEYS for `deberta-v2`, which it gives to
  `DebertaV2Model`, and models/decoder.py::CONFIG_KEYS for `qwen3`,
  `qwen2`, `llama`, `mistral`, `gemma`, `phi3`, `mixtral`, `qwen2_moe`
  and `qwen3_moe`, which it gives to
  `DecoderModel`, and models/gemma3.py::CONFIG_KEYS for `gemma3_text` and
  `gemma2`, which it gives to `Gemma3Model` and `Gemma2Model`; `mobilebert`, `squeezebert`, `xlm`, `flaubert` and
  `xlnet` configs, their config class's defaults filled in, to
  models/mobilebert.py's, models/squeezebert.py's, models/xlm.py's and
  models/xlnet.py's modules, and `gpt_neo`, `gptj` and `bloom` ones,
  under their own config names and attribute_map aliases, to
  models/gpt_neo.py's, models/gptj.py's and models/bloom.py's, and
  `gpt_neox` ones, GPTNeoXConfig's defaults filled in, to
  models/gpt_neox.py's);
- the weights, in the order transformers' `from_pretrained` picks them:
  `model.safetensors`, parsed here (an 8-byte little-endian header
  length, a JSON header of dtype, shape and `data_offsets` per tensor,
  then the raw little-endian bytes; BF16 widened to float32), else
  `model.safetensors.index.json` and its shards, else `pytorch_model.bin`
  through `torch.load(weights_only=True)`, else
  `pytorch_model.bin.index.json` and its shards (an index's `weight_map`
  names each tensor's file; each file is read once);
- the tokenizer: first its class, chosen as `AutoTokenizer` chooses it
  (tokenizer_config.json's `tokenizer_class`, else config.json's, else
  the model type's: `XLMTokenizer` for `xlm`, `FlaubertTokenizer` for
  `flaubert`, `LongformerTokenizerFast` for `longformer`,
  `BigBirdTokenizerFast` for `big_bird`, `GPT2TokenizerFast` for
  `gpt_neo` and `gptj`, `BloomTokenizerFast` for `bloom` and
  `GPTNeoXTokenizerFast` for `gpt_neox`, which read a tokenizer.json
  only, `LlamaTokenizerFast` for `mixtral`,
  `Qwen2TokenizerFast` for `qwen2_moe` and `qwen3_moe`); XLM's and FlauBERT's read
  `vocab.json` and `merges.txt` through
  Moses and a `</w>` BPE (models/xlm_bpe.py), never as RoBERTa's
  byte-level BPE. Otherwise the tokenizer is chosen by what the directory
  holds, whatever the model type: a `tokenizer.json` whose model is Unigram (XLM-R's, CamemBERT's
  and DeBERTa-v3's SentencePiece vocabularies) is read by
  models/unigram.py, one whose model is BPE
  (RoBERTa's, ModernBERT's, Qwen2's and Llama-3's byte-level BPE;
  Llama-2's, Mistral's and Gemma's sentencepiece BPE with byte fallback)
  by models/bpe.py; without a tokenizer.json,
  `vocab.json` and `merges.txt` are RoBERTa's older layout (models/bpe.py
  lays them out as a tokenizer.json); otherwise `vocab.txt`, one
  WordPiece token per line (models/wordpiece.py; a WordPiece
  tokenizer.json means vocab.txt too, and gives its added tokens and
  template). A `tokenizer.json` of any other model (WordLevel, ...) is
  refused; so is a directory whose only tokenizer is a sentencepiece
  model file (`spm.model`, `sentencepiece.bpe.model`), which the port
  does not parse, and a `LongformerTokenizer(Fast)` directory whose
  tokenizer is not a BPE one or a `BigBirdTokenizer(Fast)` one whose
  tokenizer is not a Unigram tokenizer.json. Beside it, `tokenizer_config.json` (`do_lower_case`,
  default true; `strip_accents`; `tokenize_chinese_chars`;
  `add_prefix_space`; the special tokens and `added_tokens_decoder`;
  `tokenizer_class`, where `RoFormerTokenizer(Fast)`, whose jieba
  pre-tokenizer the port does not run, is refused by name;
  `model_input_names`,
  or the class, says whether transformers' tokenizer gives token types,
  `gives_token_types`).

Checkpoint names map onto `BertModel`'s, `AlbertModel`'s,
`RoFormerModel`'s, `ModernBertModel`'s, `DebertaV2Model`'s,
`MobileBertModel`'s, `SqueezeBertModel`'s, `XLMModel`'s, `XLNetModel`'s,
`DecoderModel`'s, `Gemma3Model`'s, `LongformerModel`'s, `GPTNeoModel`'s,
`GPTJModel`'s, `BloomModel`'s and `GPTNeoXModel`'s (`hf_to_state_dict`): a
`gpt_neox.` (`GPTNeoXForCausalLM`'s), `bert.` (BERT's,
Megatron-BERT's, BertGeneration's and BigBird's), `roberta.` (RoBERTa's,
CamemBERT's and XLM-RoBERTa-XL's), `data2vec_text.`, `longformer.`,
`distilbert.`, `mpnet.`, `electra.`, `ernie.`, `rembert.`, `albert.`,
`roformer.`, `deberta.`, `mobilebert.`, `model.` (ModernBERT's and the
`*ForCausalLM` decoders', `Gemma3ForCausalLM`'s, `Gemma2ForCausalLM`'s,
`GemmaForCausalLM`'s and `Phi3ForCausalLM`'s too) or
`transformer.` (SqueezeBERT's, XLM's, FlauBERT's, XLNet's and the
`*ForCausalLM` of GPT-Neo, GPT-J and BLOOM; DistilBERT's
`transformer.layer.N.` keeps it) prefix is dropped, so are the pooler,
the pre-training and language-model heads (`cls.`, `lm_head.`, `vocab_*`;
`ModernBertForMaskedLM`'s `head.` and `decoder.`; ELECTRA's
`discriminator_predictions.`, `generator_predictions.` and
`generator_lm_head.`; `DebertaV2ForMaskedLM`'s `lm_predictions.` and the
`mask_predictions.` transformers ignores; ALBERT's `predictions.` and
`sop_classifier.`; XLM's and FlauBERT's `pred_layer.` and
`sequence_summary.`; XLNet's
`lm_loss.`, `sequence_summary.` and `logits_proj.`; `GPTNeoXForCausalLM`'s
`embed_out.`) and the
`position_ids`, `token_type_ids` and `rotary_emb.inv_freq` buffers (and
the causal `attn.bias` / `attn.masked_bias` buffers older GPT-J files
hold, `attn.attention.bias` / `.masked_bias` in GPT-Neo's, `attention.bias`
/ `.masked_bias` in GPT-NeoX's), and old
`LayerNorm.gamma/beta` become `weight/bias`. DistilBERT's layers
(`transformer.layer.N`: `attention.{q,k,v,out}_lin`, `sa_layer_norm`,
`ffn.lin1`, `ffn.lin2`, `output_layer_norm`) take BERT's names
(`encoder.layer.N`: `attention.self.{query,key,value}`,
`attention.output.dense`, `attention.output.LayerNorm`,
`intermediate.dense`, `output.dense`, `output.LayerNorm`). MPNet's
layers keep `encoder.layer.N` and BERT's names but for the attention
(`attention.attn.{q,k,v}` to `attention.self.{query,key,value}`,
`attention.attn.o` to `attention.output.dense`, `attention.LayerNorm` to
`attention.output.LayerNorm`); `encoder.relative_attention_bias` is
kept, and so is ELECTRA's `embeddings_project`; RemBERT's and ALBERT's
`encoder.embedding_hidden_mapping_in` is that projection under another
name and becomes `embeddings_project` (`write_checkpoint` names it back).
Megatron-BERT's `attention.ln.` and `ln.` are kept as they are;
XLM-RoBERTa-XL's pre-norms take those names by where they run, never by
what `LayerNorm` means in BERT: `attention.self_attn_layer_norm.` (before
self-attention) becomes `attention.ln.`, the layer's own `LayerNorm.`
(before the intermediate) `ln.`, and `encoder.LayerNorm.` (after the
last layer) `encoder.ln.` (`hf_to_state_dict` given the model type).
`flax_to_state_dict` does the same for a Flax parameter tree given as numpy arrays (transformers'
`FlaxBertModel.params`, or `FlaxXLMRobertaModel.params`, the same tree,
or `FlaxDistilBertModel.params`): a dense `kernel` (in, out) becomes
`weight` (out, in), `scale` and `embedding` become `weight`. No Flax
MPNet, CamemBERT, DeBERTa-v2, ERNIE, BertGeneration, RemBERT,
Megatron-BERT, MobileBERT, SqueezeBERT, XLM, FlauBERT, XLNet, Qwen2, Qwen3,
Phi-3, Gemma 2 or Gemma 3 exists, and the JAX
package reads ELECTRA (fault 3.16), RoFormer (fault 3.23) and Llama and
Mistral (fault 3.17)
through its torch branch: for those it holds a torch
`state_dict`, whose numpy arrays `hf_to_state_dict` carries as they are.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import (
    albert,
    bert,
    bloom,
    deberta_v2,
    decoder,
    gemma2,
    gemma3,
    gpt_neo,
    gpt_neox,
    gptj,
    longformer,
    mobilebert,
    modernbert,
    roformer,
    squeezebert,
    xlm,
    xlnet,
)
from .albert import AlbertModel
from .bert import BertModel
from .bloom import BloomModel
from .bpe import BPE, legacy_spec
from .deberta_v2 import DebertaV2Model
from .decoder import DecoderModel
from .fixtures import (
    albert_tokenizer_config,
    bigbird_tokenizer_config,
    bloom_tokenizer_config,
    camembert_tokenizer_config,
    deberta_v2_tokenizer_config,
    gemma_tokenizer_config,
    gpt2_tokenizer_config,
    gpt_neox_tokenizer_config,
    llama3_tokenizer_config,
    llama_tokenizer_config,
    longformer_tokenizer_config,
    modernbert_tokenizer_config,
    moses_tokenizer_config,
    mpnet_tokenizer_config,
    qwen2_tokenizer_config,
    xlnet_tokenizer_config,
)
from .gemma2 import Gemma2Model
from .gemma3 import Gemma3Model
from .gpt_neo import GPTNeoModel
from .gpt_neox import GPTNeoXModel
from .gptj import GPTJModel
from .longformer import LongformerModel
from .mobilebert import MobileBertModel
from .modernbert import ModernBertModel
from .roformer import RoFormerModel
from .squeezebert import SqueezeBertModel
from .unigram import Unigram
from .wordpiece import WordPiece
from .xlm import XLMModel
from .xlm_bpe import CLASSES as MOSES_CLASSES
from .xlm_bpe import MosesBPE
from .xlnet import XLNetModel

# safetensors dtype -> numpy little-endian dtype (BF16 is widened below)
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}
# torch dtype -> safetensors dtype, for writing
_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32"}
# the weight files transformers' `from_pretrained` reads from a local
# directory, in the order it picks them: (file, is an index of shards)
WEIGHT_FILES = (("model.safetensors", False), ("model.safetensors.index.json", True),
                ("pytorch_model.bin", False), ("pytorch_model.bin.index.json", True))
_PREFIXES = ("bert.", "roberta.", "distilbert.", "mpnet.", "electra.", "ernie.", "rembert.",
             "albert.", "roformer.", "deberta.", "model.", "mobilebert.", "longformer.",
             "data2vec_text.", "gpt_neox.")
# SqueezeBERT's, XLM's and XLNet's base-model prefix; DistilBERT's layers
# (`transformer.layer.N.` over DistilBERT's leaves) keep it
_TRANSFORMER = "transformer."
_DROPPED = ("pooler.", "cls.", "lm_head.", "vocab_", "head.", "decoder.",
            "discriminator_predictions.", "generator_predictions.", "generator_lm_head.",
            "lm_predictions.", "mask_predictions.", "predictions.", "sop_classifier.",
            "pred_layer.", "lm_loss.", "sequence_summary.", "logits_proj.", "embed_out.",
            "embeddings.position_ids", "embeddings.token_type_ids")
# RemBERT's and ALBERT's name of the embeddings' projection -> the modules'
_MAPPING_IN, _PROJECT = "encoder.embedding_hidden_mapping_in.", "embeddings_project."
# tokenizer classes refused by name: RoFormer's jieba pre-tokenizer
_REFUSED_TOKENIZERS = {"RoFormerTokenizer": "its jieba pre-tokenizer",
                       "RoFormerTokenizerFast": "its jieba pre-tokenizer"}
# AutoTokenizer's class for a model type, where the port reads it from the
# type alone (a directory that names no class)
_TYPE_TOKENIZERS = {xlm.MODEL_TYPE: "XLMTokenizer", xlm.FLAUBERT_TYPE: "FlaubertTokenizer",
                    longformer.MODEL_TYPE: "LongformerTokenizerFast",
                    bert.BIG_BIRD: "BigBirdTokenizerFast", gpt_neo.MODEL_TYPE: "GPT2TokenizerFast",
                    gptj.MODEL_TYPE: "GPT2TokenizerFast", bloom.MODEL_TYPE: "BloomTokenizerFast",
                    gpt_neox.MODEL_TYPE: "GPTNeoXTokenizerFast",
                    "mixtral": "LlamaTokenizerFast", "qwen2_moe": "Qwen2TokenizerFast",
                    "qwen3_moe": "Qwen2TokenizerFast"}
# tokenizer classes (without `Fast`) the port reads from one tokenizer
# model only: Longformer's, GPT-2's, BLOOM's and GPT-NeoX's byte-level BPE,
# BigBird's Unigram tokenizer.json
_CLASS_MODELS = {"LongformerTokenizer": "BPE", "BigBirdTokenizer": "Unigram",
                 "GPT2Tokenizer": "BPE", "BloomTokenizer": "BPE", "GPTNeoXTokenizer": "BPE"}
# tokenizer classes whose `model_input_names` leave out token_type_ids
# (the others give them, PreTrainedTokenizerBase's default)
_UNTYPED_TOKENIZERS = ("RobertaTokenizer", "XLMRobertaTokenizer", "CamembertTokenizer",
                       "DistilBertTokenizer", "MPNetTokenizer", "LlamaTokenizer",
                       "GemmaTokenizer", "Qwen2Tokenizer", "GPT2Tokenizer", "BartTokenizer",
                       "LongformerTokenizer", "BigBirdTokenizer", "BloomTokenizer",
                       "GPTNeoXTokenizer")
# tokenizer classes (without `Fast`) with no slow class: a fast one read
# from a tokenizer.json only
_JSON_ONLY = ("BloomTokenizer", "GPTNeoXTokenizer")
# sentencepiece model files, which the port does not parse
_SPM_FILES = ("spm.model", "sentencepiece.bpe.model", "sentencepiece.model")
# DistilBERT's layer names -> BertModel's, inside `transformer.layer.N.`
_DISTILBERT_NAMES = (
    ("attention.q_lin.", "attention.self.query."),
    ("attention.k_lin.", "attention.self.key."),
    ("attention.v_lin.", "attention.self.value."),
    ("attention.out_lin.", "attention.output.dense."),
    ("sa_layer_norm.", "attention.output.LayerNorm."),
    ("ffn.lin1.", "intermediate.dense."),
    ("ffn.lin2.", "output.dense."),
    ("output_layer_norm.", "output.LayerNorm."),
)
# MPNet's attention names -> BertModel's, inside `encoder.layer.N.`
_MPNET_NAMES = (
    ("attention.attn.q.", "attention.self.query."),
    ("attention.attn.k.", "attention.self.key."),
    ("attention.attn.v.", "attention.self.value."),
    ("attention.attn.o.", "attention.output.dense."),
    ("attention.LayerNorm.", "attention.output.LayerNorm."),
)
_LAYER = "encoder.layer."
# XLM-RoBERTa-XL's pre-norms -> BertModel's by where they run, inside
# `encoder.layer.N.` (before self-attention, before the intermediate), and
# its final norm
_XLMR_XL_NAMES = (("attention.self_attn_layer_norm.", "attention.ln."), ("LayerNorm.", "ln."))
_XLMR_XL_FINAL = ("encoder.LayerNorm.", "encoder.ln.")


def _rename_layer(name: str, src: str, dst: str, table) -> str:
    """`{src}N.leaf` as `{dst}N.leaf`, the leaf's first prefix `old` of
    `table`'s (old, new) pairs replaced by `new`."""
    i, _, leaf = name[len(src):].partition(".")
    for old, new in table:
        if leaf.startswith(old):
            return f"{dst}{i}.{new}{leaf[len(old):]}"
    return f"{dst}{i}.{leaf}"


def _to_distilbert(name: str) -> str:
    """BertModel's parameter name under DistilBERT's."""
    if not name.startswith(_LAYER):
        return name
    return _rename_layer(name, _LAYER, "transformer.layer.",
                         [(ours, theirs) for theirs, ours in _DISTILBERT_NAMES])


def _to_mpnet(name: str) -> str:
    """BertModel's parameter name under MPNet's."""
    if not name.startswith(_LAYER):
        return name
    return _rename_layer(name, _LAYER, _LAYER, [(ours, theirs) for theirs, ours in _MPNET_NAMES])


def _distilbert_layer(name: str) -> bool:
    """`transformer.layer.N.` over one of DistilBERT's layer leaves (XLNet's
    `transformer.layer.N.rel_attn.` and `.ff.` are not)."""
    if not name.startswith("transformer.layer."):
        return False
    leaf = name[len("transformer.layer."):].partition(".")[2]
    return leaf.startswith(tuple(old for old, _new in _DISTILBERT_NAMES))


def _to_xlmr_xl(name: str) -> str:
    """BertModel's parameter name under XLM-RoBERTa-XL's."""
    if name.startswith(_LAYER):
        return _rename_layer(name, _LAYER, _LAYER,
                             [(ours, theirs) for theirs, ours in _XLMR_XL_NAMES])
    theirs, ours = _XLMR_XL_FINAL
    return theirs + name[len(ours):] if name.startswith(ours) else name


def _from_xlmr_xl(name: str) -> str:
    """XLM-RoBERTa-XL's parameter name under BertModel's."""
    if name.startswith(_LAYER):
        return _rename_layer(name, _LAYER, _LAYER, _XLMR_XL_NAMES)
    theirs, ours = _XLMR_XL_FINAL
    return ours + name[len(theirs):] if name.startswith(theirs) else name


def _to_mapping_in(name: str) -> str:
    """The module's projection under RemBERT's and ALBERT's name."""
    if name.startswith(_PROJECT):
        return _MAPPING_IN + name[len(_PROJECT):]
    return name


# model types with a module of their own, and its checks
_MODELS = {"modernbert": ModernBertModel, "deberta-v2": DebertaV2Model,
           longformer.MODEL_TYPE: LongformerModel,
           albert.MODEL_TYPE: AlbertModel, roformer.MODEL_TYPE: RoFormerModel,
           **{kind: DecoderModel for kind in decoder.MODEL_TYPES},
           gemma3.MODEL_TYPE: Gemma3Model, gemma2.MODEL_TYPE: Gemma2Model,
           mobilebert.MODEL_TYPE: MobileBertModel,
           squeezebert.MODEL_TYPE: SqueezeBertModel, xlm.MODEL_TYPE: XLMModel,
           xlm.FLAUBERT_TYPE: XLMModel, xlnet.MODEL_TYPE: XLNetModel,
           gpt_neo.MODEL_TYPE: GPTNeoModel, gptj.MODEL_TYPE: GPTJModel,
           bloom.MODEL_TYPE: BloomModel, gpt_neox.MODEL_TYPE: GPTNeoXModel}
# (`gemma3`, the multimodal model, is refused by models/gemma3.py by name)
_CHECKS = {"modernbert": modernbert.check_config, "deberta-v2": deberta_v2.check_config,
           longformer.MODEL_TYPE: longformer.check_config,
           albert.MODEL_TYPE: albert.check_config, roformer.MODEL_TYPE: roformer.check_config,
           **{kind: decoder.check_config for kind in decoder.MODEL_TYPES},
           gemma3.MODEL_TYPE: gemma3.check_config, "gemma3": gemma3.check_config,
           gemma2.MODEL_TYPE: gemma2.check_config,
           mobilebert.MODEL_TYPE: mobilebert.check_config,
           squeezebert.MODEL_TYPE: squeezebert.check_config, xlm.MODEL_TYPE: xlm.check_config,
           xlm.FLAUBERT_TYPE: xlm.check_config, xlnet.MODEL_TYPE: xlnet.check_config,
           gpt_neo.MODEL_TYPE: gpt_neo.check_config, gptj.MODEL_TYPE: gptj.check_config,
           bloom.MODEL_TYPE: bloom.check_config, gpt_neox.MODEL_TYPE: gpt_neox.check_config}
# model types whose modules fill in their config class's defaults
_OWN_DEFAULTS = (mobilebert.MODEL_TYPE, squeezebert.MODEL_TYPE, xlm.MODEL_TYPE,
                 xlm.FLAUBERT_TYPE, xlnet.MODEL_TYPE)
# the GPT families: their own defaults too, written as pytorch_model.bin
# (the JAX package converts a model.safetensors to the Flax classes of the
# first three; older Pythia files are .bin, with the stale buffers below)
_GPT_TYPES = (gpt_neo.MODEL_TYPE, gptj.MODEL_TYPE, bloom.MODEL_TYPE, gpt_neox.MODEL_TYPE)
# the stale causal buffers older GPT-Neo, GPT-J and GPT-NeoX files hold
# (GPT-NeoX's `attention.rotary_emb.inv_freq` goes with every rotary's)
_STALE = {gpt_neo.MODEL_TYPE: (".attn.attention.bias", ".attn.attention.masked_bias"),
          gptj.MODEL_TYPE: (".attn.bias", ".attn.masked_bias"),
          gpt_neox.MODEL_TYPE: (".attention.bias", ".attention.masked_bias")}
# model types whose checkpoints the port writes as model.safetensors: those
# published so, and those that have no Flax class (the JAX package's
# encoder reads either file through its torch branch)
_SAFETENSORS = ("modernbert", *decoder.MODEL_TYPES, gemma3.MODEL_TYPE, gemma2.MODEL_TYPE,
                *_OWN_DEFAULTS)


def check_config(config: dict) -> dict:
    """Raise ValueError unless the port runs `config`'s model: a
    `modernbert` config checked by models/modernbert.py, a `deberta-v2`
    one by models/deberta_v2.py, an `albert` one by models/albert.py, a
    `roformer` one by models/roformer.py, a `qwen3`, `qwen2`, `llama`,
    `mistral`, `gemma` or `phi3` one by models/decoder.py, a `gemma3_text`
    (or `gemma3`) one by models/gemma3.py, a `gemma2` one by
    models/gemma2.py, a `longformer` one by models/longformer.py, a
    `gpt_neo`, `gptj`, `bloom` or `gpt_neox` one by models/gpt_neo.py,
    models/gptj.py, models/bloom.py or models/gpt_neox.py, any other by
    models/bert.py."""
    return _CHECKS.get(config.get("model_type"), bert.check_config)(config)


def new_model(config: dict):
    """The module that runs `config`'s model: `ModernBertModel` for
    `modernbert`, `DebertaV2Model` for `deberta-v2`, `AlbertModel` for
    `albert`, `RoFormerModel` for `roformer`, `DecoderModel` for
    the decoders, `Gemma3Model` for `gemma3_text`, `Gemma2Model` for
    `gemma2`, `LongformerModel` for `longformer`, `GPTNeoModel`,
    `GPTJModel`, `BloomModel` and `GPTNeoXModel` for `gpt_neo`, `gptj`,
    `bloom` and `gpt_neox`, `BertModel` for the other families."""
    return _MODELS.get(config.get("model_type"), BertModel)(config)


@dataclass
class Checkpoint:
    config: dict
    state_dict: dict  # the module's names (new_model) -> float32 CPU tensors
    vocab: list  # vocab.txt's WordPiece tokens (empty for a Unigram or BPE tokenizer)
    tokenizer: dict = field(default_factory=dict)  # tokenizer_config.json
    # the tokenizer.json, parsed (vocab.json + merges.txt laid out as a BPE one)
    tokenizer_json: Optional[dict] = None
    # XLM's or FlauBERT's: (vocab.json's token -> id, merges.txt's text, class)
    moses: Optional[tuple] = None


def read_safetensors(path: str) -> dict:
    """name -> numpy array of a `.safetensors` file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":  # the high half of a float32, widened by torch's copy
            count = (end - start) // 2
            arr = (torch.frombuffer(data, dtype=torch.bfloat16, count=count, offset=start)
                   .float().numpy() if count else np.zeros(0, np.float32))
        elif meta["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[meta["dtype"]])
            arr = np.frombuffer(data, dt, (end - start) // dt.itemsize, start)
        else:
            raise ValueError(f"{path}: tensor `{name}` has dtype {meta['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def hf_to_state_dict(named: dict, model_type: Optional[str] = None) -> dict:
    """A checkpoint's tensors (torch or numpy) under BertModel's (or
    AlbertModel's, RoFormerModel's, ModernBertModel's, DebertaV2Model's,
    ...) names, as float32 CPU tensors; `model_type` `xlm-roberta-xl`
    renames its pre-norms by where they run, and `gpt_neo`, `gptj` and
    `gpt_neox` drop the stale causal buffers."""
    out = {}
    for name, value in named.items():
        for prefix in _PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        if name.startswith(_TRANSFORMER) and not _distilbert_layer(name):
            name = name[len(_TRANSFORMER):]
        if name.startswith(_DROPPED) or name.endswith("rotary_emb.inv_freq"):
            continue
        if name.endswith(_STALE.get(model_type, ())):
            continue
        if name.startswith(_MAPPING_IN):
            name = _PROJECT + name[len(_MAPPING_IN):]
        if name.startswith("transformer.layer."):
            name = _rename_layer(name, "transformer.layer.", _LAYER, _DISTILBERT_NAMES)
        elif name.startswith(_LAYER):
            name = _rename_layer(name, _LAYER, _LAYER, _MPNET_NAMES)
        if model_type == "xlm-roberta-xl":
            name = _from_xlmr_xl(name)
        if name.endswith(".gamma"):
            name = name[: -len("gamma")] + "weight"
        elif name.endswith(".beta"):
            name = name[: -len("beta")] + "bias"
        if not isinstance(value, torch.Tensor):
            # a writable array (read_safetensors' views of its one buffer) is
            # shared, not copied: a 2.4 GB file stays one copy on the host
            value = np.asarray(value)
            value = torch.from_numpy(value if value.flags.writeable else value.copy())
        out[name] = value.detach().to("cpu", torch.float32).contiguous()
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def flax_to_state_dict(params: dict) -> dict:
    """A Flax BERT, XLM-RoBERTa or DistilBERT parameter tree (numpy
    leaves) as BertModel's state_dict."""
    named = {}
    for name, value in _flatten(params).items():
        value = np.asarray(value, np.float32)
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            named[f"{stem}.weight"] = value.T
        elif leaf in ("scale", "embedding"):
            named[f"{stem}.weight"] = value
        else:
            named[name] = value
    return hf_to_state_dict(named)


def _read_file(path: str) -> dict:
    """name -> tensor or array of one weight file (safetensors or torch)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_shards(index_path: str) -> dict:
    """name -> tensor or array of a sharded checkpoint, as transformers
    reads one: the index's `weight_map` names each tensor's file, each
    file is read once (in the index's order of first mention), and every
    tensor the map names must be in its file."""
    with open(index_path) as f:
        weight_map = json.load(f)["weight_map"]
    root = os.path.dirname(index_path)
    named = {}
    for shard in dict.fromkeys(weight_map.values()):
        tensors = _read_file(os.path.join(root, shard))
        missing = [k for k, v in weight_map.items() if v == shard and k not in tensors]
        if missing:
            raise ValueError(f"`{index_path}` maps {missing[:3]} to `{shard}`, which lacks them")
        named.update(tensors)
    return named


def read_weights(path: str, model_type: Optional[str] = None) -> dict:
    """The module's state_dict from a checkpoint directory's weights (of
    `model_type`, config.json's, for `hf_to_state_dict`): the first of
    WEIGHT_FILES the directory holds."""
    for name, sharded in WEIGHT_FILES:
        file = os.path.join(path, name)
        if os.path.exists(file):
            named = read_shards(file) if sharded else _read_file(file)
            return hf_to_state_dict(named, model_type)
    raise FileNotFoundError(
        f"`{path}` holds none of {[name for name, _sharded in WEIGHT_FILES]}"
    )


def tokenizer_class(config: dict, tokenizer: dict) -> Optional[str]:
    """The tokenizer class AutoTokenizer takes for a directory:
    tokenizer_config.json's `tokenizer_class`, else config.json's, else
    the model type's where the port reads it from the type alone."""
    return (tokenizer.get("tokenizer_class") or config.get("tokenizer_class")
            or _TYPE_TOKENIZERS.get(config.get("model_type")))


def load_checkpoint(path: str) -> Checkpoint:
    """Read a local checkpoint directory (no download: a hub name that is
    not a directory raises)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"`{path}` is not a local checkpoint directory (the model is read"
            " from disk; nothing is downloaded)"
        )
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    check_config(config)
    tok_path = os.path.join(path, "tokenizer_config.json")
    tokenizer = {}
    if os.path.exists(tok_path):
        with open(tok_path) as f:
            tokenizer = json.load(f)
    tok_class = tokenizer_class(config, tokenizer)
    if tok_class in _REFUSED_TOKENIZERS:
        raise ValueError(
            f"tokenizer_class `{tok_class}` is not supported: {_REFUSED_TOKENIZERS[tok_class]}"
            " is not in the port (a checkpoint saved with a WordPiece, Unigram or BPE tokenizer"
            " class the port reads loads)")
    state = read_weights(path, config.get("model_type"))
    if config.get("model_type") == roformer.MODEL_TYPE:
        state = roformer.with_positions(config, state)
    if (tok_class or "").removesuffix("Fast") in _JSON_ONLY and not os.path.exists(
            os.path.join(path, "tokenizer.json")):
        raise ValueError(f"`{path}`'s tokenizer is {tok_class}, which reads a"
                         " tokenizer.json only, and the directory has none")
    if tok_class in MOSES_CLASSES:
        files = [os.path.join(path, f) for f in ("vocab.json", "merges.txt")]
        if not all(map(os.path.exists, files)):
            raise ValueError(f"`{path}`'s tokenizer is {tok_class} (Moses and a `</w>` BPE over"
                             " vocab.json and merges.txt), and the directory lacks one of them")
        with open(files[0], encoding="utf-8") as f:
            vocab = json.load(f)
        with open(files[1], encoding="utf-8") as f:
            merges = f.read()
        return Checkpoint(config, state, [], tokenizer, None, (vocab, merges, tok_class))
    spec = None
    json_path = os.path.join(path, "tokenizer.json")
    if os.path.exists(json_path):
        with open(json_path, encoding="utf-8") as f:
            spec = json.load(f)
        kind = (spec.get("model") or {}).get("type")
        if kind not in ("Unigram", "BPE", "WordPiece"):
            raise ValueError(
                f"`{json_path}` holds a {kind} tokenizer: the port reads Unigram, BPE and"
                " WordPiece tokenizer.json files, vocab.json + merges.txt and WordPiece"
                " vocab.txt only"
            )
    elif os.path.exists(os.path.join(path, "merges.txt")):
        spec = legacy_spec(path, tokenizer, tok_class)
    elif not os.path.exists(os.path.join(path, "vocab.txt")):
        spm = [f for f in _SPM_FILES if os.path.exists(os.path.join(path, f))]
        if spm:
            raise ValueError(
                f"`{path}` holds its tokenizer only as `{spm[0]}`: the port does not parse"
                " sentencepiece model files; save the tokenizer with transformers to write its"
                " tokenizer.json"
            )
    kind = spec["model"]["type"] if spec is not None else "WordPiece"
    want = _CLASS_MODELS.get((tok_class or "").removesuffix("Fast"))
    if want is not None and kind != want:
        raise ValueError(f"tokenizer_class `{tok_class}` over a {kind} tokenizer is not"
                         f" supported: the port reads that class from a {want} tokenizer"
                         " only")
    vocab = []
    if spec is None or spec["model"]["type"] == "WordPiece":
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
    return Checkpoint(config, state, vocab, tokenizer, spec)


def build_tokenizer(ckpt: Checkpoint):
    """The checkpoint's tokenizer: XLM's or FlauBERT's Moses BPE for those
    classes, Unigram or BPE for a tokenizer.json of that model (BPE for
    vocab.json + merges.txt), else WordPiece over vocab.txt (with a
    WordPiece tokenizer.json's added tokens and template). Each takes
    (texts, max_len) and gives (input_ids, attention_mask)."""
    if ckpt.moses is not None:
        vocab, merges, tok_class = ckpt.moses
        return MosesBPE(vocab, merges, ckpt.tokenizer, tok_class)
    kind = None if ckpt.tokenizer_json is None else ckpt.tokenizer_json["model"]["type"]
    if kind in (None, "WordPiece"):
        return WordPiece.from_config(ckpt.vocab, ckpt.tokenizer, ckpt.tokenizer_json,
                                     ckpt.config.get("model_type"))
    if kind == "BPE":
        return BPE(ckpt.tokenizer_json, ckpt.tokenizer, ckpt.config.get("model_type"))
    return Unigram(ckpt.tokenizer_json, ckpt.tokenizer, ckpt.config.get("model_type"))


def gives_token_types(ckpt: Checkpoint) -> bool:
    """Whether transformers' tokenizer for the checkpoint returns
    `token_type_ids` (which the JAX package's encoder passes to the model):
    tokenizer_config.json's `model_input_names`, else its class's, as
    `tokenizer_class` picks it (`_UNTYPED_TOKENIZERS` leave them out)."""
    names = ckpt.tokenizer.get("model_input_names")
    if names is not None:
        return "token_type_ids" in names
    tok_class = tokenizer_class(ckpt.config, ckpt.tokenizer) or ""
    return tok_class.removesuffix("Fast") not in _UNTYPED_TOKENIZERS


def build_model(ckpt: Checkpoint):
    """The checkpoint's module (`new_model`) holding its weights (every
    parameter must be present), on the CPU, in eval mode. The module is
    built on the meta device and takes the state_dict's tensors as its
    parameters: no second copy of the weights is made."""
    with torch.device("meta"):
        model = new_model(ckpt.config)
    model.load_state_dict(ckpt.state_dict, strict=True, assign=True)
    return model.eval()


def write_safetensors(path: str, state_dict: dict) -> None:
    """`state_dict` as a `.safetensors` file (the layout `read_safetensors`
    parses; metadata `format: pt`, as transformers' loader asks)."""
    header, offset, blobs = {"__metadata__": {"format": "pt"}}, 0, []
    for name, t in state_dict.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor `{name}` has dtype {t.dtype}")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # numpy has no bfloat16
        blob = raw.numpy().view(np.uint8).reshape(-1) if t.numel() else np.zeros(0, np.uint8)
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + blob.size]}
        offset += blob.size
        blobs.append(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for blob in blobs:
            f.write(memoryview(blob))


def write_shards(path: str, state_dict: dict, shard_bytes: int, safetensors: bool = True) -> None:
    """`state_dict` as shards of at most `shard_bytes` each (a tensor
    larger than that alone in its shard), in the state_dict's order, named
    as `save_pretrained` names them (`model-00001-of-00003.safetensors` or
    `pytorch_model-00001-of-00003.bin`), and the index beside them
    (`model.safetensors.index.json` or `pytorch_model.bin.index.json`:
    `metadata.total_parameters` and `total_size`, and `weight_map`)."""
    shards, size = [[]], 0
    for name, t in state_dict.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += nbytes
    stem, ext = ("model", "safetensors") if safetensors else ("pytorch_model", "bin")
    weight_map, total, params = {}, 0, 0
    for i, names in enumerate(shards):
        file = f"{stem}-{i + 1:05d}-of-{len(shards):05d}.{ext}"
        part = {name: state_dict[name] for name in names}
        if safetensors:
            write_safetensors(os.path.join(path, file), part)
        else:
            torch.save({k: v.detach().to("cpu").contiguous() for k, v in part.items()},
                       os.path.join(path, file))
        weight_map.update(dict.fromkeys(names, file))
        total += sum(t.numel() * t.element_size() for t in part.values())
        params += sum(t.numel() for t in part.values())
    with open(os.path.join(path, f"{stem}.{ext}.index.json"), "w") as f:
        json.dump({"metadata": {"total_parameters": params, "total_size": total},
                   "weight_map": weight_map}, f, indent=2)


def write_checkpoint(path: str, config: dict, state_dict: dict, vocab: Optional[list] = None,
                     do_lower_case: bool = True, tokenizer_json: Optional[dict] = None,
                     tokenizer_config: Optional[dict] = None,
                     moses: Optional[tuple] = None, shard_bytes: Optional[int] = None) -> None:
    """Write a directory `load_checkpoint` reads: config.json (`model_type`
    bert unless `config` names one), the weights as pytorch_model.bin
    (BertModel's names, DistilBERT's, MPNet's or XLM-RoBERTa-XL's for such
    a config, RemBERT's and ALBERT's `encoder.embedding_hidden_mapping_in`
    for their `embeddings_project`, LongformerModel's, AlbertModel's,
    RoFormerModel's and
    DebertaV2Model's for `albert`, `roformer` and `deberta-v2`; ELECTRA's
    and BigBird's there too, the one file from which the JAX package reads
    each through its torch branch, faults 3.16 and 3.27),
    or for `modernbert`, the
    decoders, `gemma3_text` and `gemma2` as model.safetensors, the file their
    checkpoints are published in (ModernBertModel's, DecoderModel's,
    Gemma3Model's and Gemma2Model's names), as for `mobilebert`, `squeezebert`, `xlm`,
    `flaubert` and `xlnet`, which have no Flax class (their modules' names, no prefix),
    and
    tokenizer_config.json (`tokenizer_config` as given, else:), with either
    `vocab` as vocab.txt (MPNetTokenizerFast's special tokens for an
    `mpnet` config, ElectraTokenizer's class for `electra`) or
    `tokenizer_json` (a Unigram tokenizer.json with XLM-R's special tokens,
    CamemBERT's config for `camembert`, DeBERTa-v2's for `deberta-v2`,
    ALBERT's for `albert`, XLNet's for `xlnet` and BigBird's for
    `big_bird`, fixtures.camembert_tokenizer_config,
    deberta_v2_tokenizer_config, albert_tokenizer_config,
    xlnet_tokenizer_config and bigbird_tokenizer_config; a
    BPE one with RoBERTa's, add_prefix_space false, Longformer's for a
    `longformer` config, fixtures.longformer_tokenizer_config, or, for a `modernbert`
    config, a BPE one with its own specials and `PreTrainedTokenizerFast`'s
    config, fixtures.modernbert_tokenizer_config; for `qwen3` and `qwen2`
    Qwen2Tokenizer's, fixtures.qwen2_tokenizer_config, for `llama` and
    `mistral` Llama-3's, fixtures.llama3_tokenizer_config, for `phi3`
    LlamaTokenizer's, fixtures.llama_tokenizer_config, and for
    `gemma3_text`, `gemma2` and `gemma` GemmaTokenizer's,
    fixtures.gemma_tokenizer_config, for `gpt_neo` and `gptj`
    GPT2Tokenizer's, fixtures.gpt2_tokenizer_config, for `bloom`
    BloomTokenizerFast's, fixtures.bloom_tokenizer_config, and for
    `gpt_neox` GPTNeoXTokenizer's, fixtures.gpt_neox_tokenizer_config), or
    `moses`, (vocab.json's dict, merges.txt's text), with XLMTokenizer's
    tokenizer_config.json (FlaubertTokenizer's for `flaubert`,
    fixtures.moses_tokenizer_config). With `shard_bytes`, the weights are
    shards of at most that many bytes and their index instead of the one
    file (`write_shards`), as `save_pretrained` writes a large model; the
    tensors keep their dtype (BF16 ones as BF16)."""
    os.makedirs(path, exist_ok=True)
    config = {"model_type": "bert", **config}
    model_type = config["model_type"]
    rename = {"distilbert": _to_distilbert, "mpnet": _to_mpnet, "rembert": _to_mapping_in,
              albert.MODEL_TYPE: _to_mapping_in, "xlm-roberta-xl": _to_xlmr_xl}.get(model_type)
    if rename is not None:
        state_dict = {rename(k): v for k, v in state_dict.items()}
    if model_type not in ("distilbert", "modernbert", albert.MODEL_TYPE, *decoder.MODEL_TYPES,
                          gemma3.MODEL_TYPE, gemma2.MODEL_TYPE, *_OWN_DEFAULTS, *_GPT_TYPES):
        config.setdefault("hidden_act", "gelu")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if shard_bytes is not None:
        write_shards(path, state_dict, shard_bytes, safetensors=model_type in _SAFETENSORS)
    elif model_type in _SAFETENSORS:
        write_safetensors(os.path.join(path, "model.safetensors"), state_dict)
    else:
        torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))
    if moses is not None:
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(moses[0], f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write(moses[1])
        tok_config = moses_tokenizer_config(_TYPE_TOKENIZERS.get(model_type, "XLMTokenizer"))
    elif tokenizer_json is not None:
        with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(tokenizer_json, f, ensure_ascii=False)
        bpe = tokenizer_json["model"]["type"] == "BPE"
        tok_config = {"tokenizer_class": "RobertaTokenizer" if bpe else "XLMRobertaTokenizer",
                      "bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                      "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                      "mask_token": "<mask>"}
        own = {"modernbert": modernbert_tokenizer_config, "camembert": camembert_tokenizer_config,
               albert.MODEL_TYPE: albert_tokenizer_config,
               "deberta-v2": deberta_v2_tokenizer_config, "qwen3": qwen2_tokenizer_config,
               "qwen2": qwen2_tokenizer_config, "llama": llama3_tokenizer_config,
               "mistral": llama3_tokenizer_config,
               "phi3": llama_tokenizer_config, "mixtral": llama_tokenizer_config,
               "qwen2_moe": qwen2_tokenizer_config, "qwen3_moe": qwen2_tokenizer_config,
               "gemma": gemma_tokenizer_config,
               gemma3.MODEL_TYPE: gemma_tokenizer_config,
               gemma2.MODEL_TYPE: gemma_tokenizer_config,
               xlnet.MODEL_TYPE: xlnet_tokenizer_config,
               longformer.MODEL_TYPE: longformer_tokenizer_config,
               bert.BIG_BIRD: bigbird_tokenizer_config,
               gpt_neo.MODEL_TYPE: gpt2_tokenizer_config,
               gptj.MODEL_TYPE: gpt2_tokenizer_config,
               bloom.MODEL_TYPE: bloom_tokenizer_config,
               gpt_neox.MODEL_TYPE: gpt_neox_tokenizer_config}.get(model_type)
        if own is not None:
            tok_config = own(tokenizer_json)
        elif bpe:
            tok_config["add_prefix_space"] = False
    else:
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("".join(f"{token}\n" for token in vocab))
        if model_type == "mpnet":
            tok_config = mpnet_tokenizer_config(vocab, do_lower_case)
        else:
            tok_class = "ElectraTokenizer" if model_type == "electra" else "BertTokenizer"
            tok_config = {"do_lower_case": do_lower_case, "tokenizer_class": tok_class}
    if tokenizer_config is not None:
        tok_config = tokenizer_config
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(tok_config, f)
