"""BPE tokenization, as the `tokenizers` library runs it: byte-level
(what `AutoTokenizer` gives a RoBERTa or data2vec-text checkpoint,
`RobertaTokenizerFast`, a Longformer one, `LongformerTokenizerFast`, the
same class under another name, a ModernBERT or Llama-3 one,
`PreTrainedTokenizerFast`, a Qwen2 or Qwen3 one, `Qwen2TokenizerFast`, a
GPT-Neo or GPT-J one, `GPT2TokenizerFast`, a BLOOM one,
`BloomTokenizerFast`, and a GPT-NeoX one, Pythia's and BMRetriever's,
`GPTNeoXTokenizerFast`) and sentencepiece's with byte fallback
(what transformers' `LlamaConverter` and `GemmaConverter` write: Llama-2's,
Mistral's, e5-mistral's and Phi-3's files, `LlamaTokenizerFast`, and
Gemma's, bge-multilingual-gemma2's and EmbeddingGemma's,
`GemmaTokenizerFast`).

The JAX package tokenizes through `AutoTokenizer(texts, padding=True,
truncation=True, max_length=max_len)`. This module reads the same files
and gives the same input ids and attention masks, on the host:

1. added tokens are cut out and kept whole, leftmost and longest first:
   those matched on the raw text, then the normalizer on each piece left
   (none; `NFC`, as in ModernBERT's file; `Prepend`, `Replace` of a
   string, or a `Sequence` of them: Llama-2's legacy `Prepend("▁")`,
   `Replace(" ", "▁")` and Gemma's `Replace(" ", "▁")`; a `Prepend` adds
   to every non-empty piece) and, inside it, those marked `normalized`;
   `lstrip`/`rstrip` take the whitespace beside them. Besides the file's
   `added_tokens`, the special tokens of tokenizer_config.json count, as
   the class it names adds them: a token given as a dict keeps its flags,
   and `added_tokens_decoder` overrides the file's flags. A RoBERTa class
   (`RobertaTokenizer`, the default of every family without one below;
   `LongformerTokenizer`, the default of `longformer`, reads the same)
   also gives `RobertaTokenizerFast`'s defaults (`<s>`, `</s>`, `<unk>`,
   `<pad>`, `<mask>`) to the keys the config leaves out, and makes
   `<mask>` given as a string `lstrip`; a GPT-2 class (`GPT2Tokenizer`,
   the default of `gpt_neo` and `gptj`) gives `GPT2TokenizerFast`'s
   (`<|endoftext|>` as unk, bos and eos, no pad: the reference refuses to
   pad, and so does the port, unless tokenizer_config.json names one), as
   does a GPT-NeoX class (`GPTNeoXTokenizer(Fast)`, the default of
   `gpt_neox`); a BLOOM class (`BloomTokenizerFast`, the default of
   `bloom`) gives its (`<unk>`, `<s>`, `</s>`, `<pad>`); a Qwen2 class
   (`Qwen2Tokenizer`, the default of `qwen2` and `qwen3`) gives `Qwen2TokenizerFast`'s
   (`<|endoftext|>` as unk, eos and pad, no bos); a Llama class
   (`LlamaTokenizer`, the default of `llama`, `mistral` and `phi3`) gives
   `LlamaTokenizerFast`'s (`<unk>`, `<s>`, `</s>`, no pad) and a Gemma
   class (`GemmaTokenizer`, the default of `gemma3_text`, `gemma2` and
   `gemma`)
   `GemmaTokenizerFast`'s (`<unk>`, `<bos>`, `<eos>`, `<pad>`);
   `PreTrainedTokenizerFast` (the class of ModernBERT's and Llama-3's
   files, and `modernbert`'s default) adds only what the config names,
   with the file's flags. Any other class is refused;
2. the pre-tokenizer on each piece between added tokens. ByteLevel: a
   space in front when `add_prefix_space` and the piece does not start
   with one (transformers sets the flag from tokenizer_config.json,
   default false, whatever the file says), then GPT-2's split regex
   (`use_regex`): `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
   ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`, with `\\p{L}`, `\\p{N}` and `\\s`
   the classes of `tokenizers`' own regex engine (models/unicode.py's
   frozen tables; Python's `re` knows no `\\p` class); or, for Qwen2's
   and Llama-3's files, `Sequence[Split(Regex, Isolated), ByteLevel
   (use_regex false, no prefix space)]` with one of the three published
   Split patterns (SPLIT_PATTERNS: Qwen2's, Llama-3's, the same with
   `\\p{N}{1,3}` for `\\p{N}`, and BLOOM's, ` ?[^(\\s|[.,!?…。，、।۔،])]+`),
   built from the same tables. BLOOM's nests a class inside a negated
   class, which Oniguruma reads as their union and Python's `re` cannot
   parse: the port builds it as one flat negated class (`\\s` and the
   marks), and, since its matches leave runs of other characters between
   them (`! (` in `world! (a`), keeps each such run as a piece of its own,
   as the Isolated behavior does (`isolated`). Each word's
   UTF-8 bytes become GPT-2's printable byte symbols (`bytes_to_unicode`).
   A sentencepiece-style file has none (Llama-2's legacy layout: each
   piece is one word), `Metaspace` (Llama-2's non-legacy layout: spaces
   become U+2581, which is put in front of the piece at the start of the
   text, prepend scheme `first`, or of every piece, `always`; no split)
   or `Split(" ", MergedWithPrevious)` (Gemma's: a word ends after each
   space; its normalizer leaves none, so each piece is one word). Its
   words stay characters;
3. BPE on each word: with `ignore_merges` (Llama-3's), a word that is
   whole in the vocabulary is taken as it stands. Otherwise the word
   becomes symbols: a byte-level word's byte symbols (the vocabulary
   holds all 256), a sentencepiece-style word's characters, each one the
   vocabulary lacks as its UTF-8 bytes' `<0xNN>` pieces (`byte_fallback`,
   when the vocabulary holds them all), else as the model's `unk_token`
   (dropped when there is none); with `fuse_unk` a run of unknown
   characters is one `<unk>`, and byte pieces met while that run is open
   go before it, as `tokenizers` adds them. Then the adjacent pair of
   lowest merge rank (on a tie, the leftmost) is merged, over and over,
   until no adjacent pair has a merge. Words are cached;
4. the post-processor after truncation to `max_len` less the special
   tokens (from the end, or with tokenizer_config.json's
   `truncation_side` `left` from the front), and padding with the pad
   token to the longest text of the call, after the text, or before it
   with `padding_side` `left` (Qwen3-Embedding's, and the default of the
   Llama and Gemma classes). The file's `RobertaProcessing` (`<s> $A
   </s>`), `TemplateProcessing`, `ByteLevel`, which adds nothing, or a
   `Sequence` of ByteLevel and at most one of the others; the Llama and
   Gemma classes replace it, whatever the file says, with
   `update_post_processor`'s template: bos before the text when
   `add_bos_token` (default true), eos after it when `add_eos_token`
   (default false); `GPTNeoXTokenizerFast` does the same with both flags
   false by default, so its file's post-processor never counts.
   `GPT2TokenizerFast` keeps the file's (it reads `add_bos_token` and does
   nothing with it).

`legacy_spec` reads the older layout, `vocab.json` and `merges.txt` with
no tokenizer.json, as transformers' `RobertaConverter` converts it, or,
for a GPT-2 class, its `GPT2Converter` (the class's specials; bos before
the text under tokenizer_config.json's `add_bos_token`, default false)
(the first line of merges.txt and the text after its last newline are
skipped, as `RobertaTokenizer` and `GPT2Tokenizer` read it).

Anything else raises `ValueError` naming it: another model, `dropout`, a
`continuing_subword_prefix` or `end_of_word_suffix`, `byte_fallback` or
`fuse_unk` over ByteLevel words, a byte-level vocabulary without the 256
byte symbols, an `unk_token` the vocabulary lacks, another normalizer
(a `Replace` of a Regex too), a pre-tokenizer other than those above (a
Metaspace with `split`, another Split pattern, ...), a `single_word`
added token, another tokenizer class, a Llama class given
`add_prefix_space` (transformers then rebuilds the tokenizer from the
sentencepiece model), a BLOOM class given `add_prefix_space` (its
pickled rewrite sets the flag of the ByteLevel after Split; the port's
choice: no published file sets it), a padding or truncation side other
than `right` and `left`, no pad token (transformers raises "Asking to
pad but the tokenizer does not have a padding token"), or a special token
the vocabulary lacks.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import threading
from functools import lru_cache
from typing import Optional

import torch

from . import unicode
from .unigram import SPIECE, AddedTokens, _template, _token_content

_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied
# the tokenizer classes read (when tokenizer_config.json names none, the
# model type decides, as AutoTokenizer does: _DEFAULT_CLASS, else
# RobertaTokenizer)
ROBERTA_CLASSES = ("RobertaTokenizer", "RobertaTokenizerFast", "LongformerTokenizer",
                   "LongformerTokenizerFast")
QWEN2_CLASSES = ("Qwen2Tokenizer", "Qwen2TokenizerFast")
PLAIN_CLASSES = ("PreTrainedTokenizerFast",)
LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast")
GEMMA_CLASSES = ("GemmaTokenizer", "GemmaTokenizerFast")
GPT2_CLASSES = ("GPT2Tokenizer", "GPT2TokenizerFast")
BLOOM_CLASSES = ("BloomTokenizerFast",)
# GPTNeoXTokenizerFast, under the name Pythia's files give (AutoTokenizer
# adds `Fast`: the class has no slow one)
GPT_NEOX_CLASSES = ("GPTNeoXTokenizer", "GPTNeoXTokenizerFast")
_DEFAULT_CLASS = {"modernbert": "PreTrainedTokenizerFast", "qwen2": "Qwen2TokenizerFast",
                  "qwen3": "Qwen2TokenizerFast", "llama": "LlamaTokenizerFast",
                  "mistral": "LlamaTokenizerFast", "phi3": "LlamaTokenizerFast",
                  "gemma3_text": "GemmaTokenizerFast", "gemma2": "GemmaTokenizerFast",
                  "gemma": "GemmaTokenizerFast", "longformer": "LongformerTokenizerFast",
                  "gpt_neo": "GPT2TokenizerFast", "gptj": "GPT2TokenizerFast",
                  "bloom": "BloomTokenizerFast", "gpt_neox": "GPTNeoXTokenizerFast",
                  "mixtral": "LlamaTokenizerFast",
                  "qwen2_moe": "Qwen2TokenizerFast", "qwen3_moe": "Qwen2TokenizerFast"}
# RobertaTokenizerFast's special tokens and their defaults
_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "sep_token": "</s>",
             "pad_token": "<pad>", "cls_token": "<s>", "mask_token": "<mask>"}
# Qwen2TokenizerFast's defaults (no bos)
_QWEN2_SPECIALS = {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>"}
# LlamaTokenizerFast's defaults (no pad) and GemmaTokenizerFast's
_LLAMA_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"}
_GEMMA_SPECIALS = {"unk_token": "<unk>", "bos_token": "<bos>", "eos_token": "<eos>",
                   "pad_token": "<pad>"}
# GPT2TokenizerFast's defaults (no pad; GPTNeoXTokenizerFast's too) and
# BloomTokenizerFast's
_GPT2_SPECIALS = {"unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
                  "eos_token": "<|endoftext|>"}
_BLOOM_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                   "pad_token": "<pad>"}
# the classes whose `update_post_processor` replaces the file's template
# with bos before the text under `add_bos_token` and eos after it under
# `add_eos_token`: the two flags' defaults
_REBUILT_TEMPLATES = {**dict.fromkeys(LLAMA_CLASSES + GEMMA_CLASSES, (True, False)),
                      **dict.fromkeys(GPT_NEOX_CLASSES, (False, False))}
# the Split pre-tokenizer patterns read, as tokenizer.json writes them
# (Qwen2's, Llama-3's and BLOOM's)
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
               r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPLIT = QWEN2_SPLIT.replace(r"|\p{N}|", r"|\p{N}{1,3}|")
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
SPLIT_PATTERNS = (QWEN2_SPLIT, LLAMA3_SPLIT, BLOOM_SPLIT)
# the characters BLOOM's nested classes hold besides `\s`: the outer
# class's `(`, `|` and `)`, the inner one's marks
BLOOM_MARKS = "(|).,!?…。，、।۔،"
# Gemma's pre-tokenizer: a word ends after each space
_SPACE_WORDS = re.compile("[^ ]* |[^ ]+")


def byte_piece(b: int) -> str:
    """The vocabulary's piece for byte `b` under byte fallback (`<0x0A>`)."""
    return f"<0x{b:02X}>"


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """GPT-2's map of each byte to a printable character: the printable
    Latin-1 bytes map to themselves, the other 68 to U+0100 onwards
    (keyed by the byte's Latin-1 code point, a `str.translate` table)."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=None)
def split_pattern(file_pattern: Optional[str] = None) -> re.Pattern:
    """GPT-2's split regex (ByteLevel's own, `file_pattern` None) or one of
    SPLIT_PATTERNS, over `tokenizers`' letter, number and space classes.
    All but BLOOM's match every character, so `findall` gives
    `tokenizers`' Isolated split; BLOOM's is one flat negated class, and
    `isolated` keeps the runs between its matches."""
    letter = unicode.ranges("BYTE_LEVEL_LETTER").char_class()
    number = unicode.ranges("BYTE_LEVEL_NUMBER").char_class()
    space = unicode.ranges("BYTE_LEVEL_SPACE").char_class()
    if file_pattern == BLOOM_SPLIT:
        return re.compile(f" ?[^{space}{re.escape(BLOOM_MARKS)}]+")
    if file_pattern is None:
        return re.compile(
            f"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+| ?[^{space}{letter}{number}]+"
            f"|[{space}]+(?![^{space}])|[{space}]+"
        )
    digits = "{1,3}" if file_pattern == LLAMA3_SPLIT else ""
    return re.compile(
        f"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n{letter}{number}]?[{letter}]+|[{number}]{digits}"
        f"| ?[^{space}{letter}{number}]+[\\r\\n]*|[{space}]*[\\r\\n]+|[{space}]+(?![^{space}])"
        f"|[{space}]+"
    )


def isolated(split: re.Pattern, text: str) -> list:
    """`tokenizers`' Isolated split of `text` by `split`: each match a
    piece, and each run of text between two matches a piece too."""
    pieces = split.findall(text)
    if sum(map(len, pieces)) == len(text):
        return pieces  # every character matched: no run between
    pieces, at = [], 0
    for m in split.finditer(text):
        if m.start() > at:
            pieces.append(text[at:m.start()])
        pieces.append(m.group())
        at = m.end()
    if at < len(text):
        pieces.append(text[at:])
    return pieces


def byte_level_words(text: str, add_prefix_space: bool = False, use_regex: bool = True,
                     split: Optional[re.Pattern] = None) -> list:
    """The ByteLevel pre-tokenizer: the words of `text` in byte symbols
    (`split`: a Split pattern that cuts the text first, in place of
    ByteLevel's own regex)."""
    if add_prefix_space and text and not text.startswith(" "):
        text = " " + text
    if split is None and use_regex:
        split = split_pattern()
    pieces = isolated(split, text) if split is not None else [text]
    table = bytes_to_unicode()
    return [piece.encode("utf-8").decode("latin-1").translate(table) for piece in pieces if piece]


def _pre_tokenizer(spec: Optional[dict]) -> tuple:
    """(use_regex, Split pattern or None) of a ByteLevel pre-tokenizer or of
    a Sequence[Split(Regex, Isolated), ByteLevel] with one of
    SPLIT_PATTERNS (refusing any other)."""
    kind = None if spec is None else spec.get("type")
    if kind == "ByteLevel":
        return spec.get("use_regex", True), None
    steps = (spec or {}).get("pretokenizers") or []
    if kind == "Sequence" and [step.get("type") for step in steps] == ["Split", "ByteLevel"]:
        split, level = steps
        regex = (split.get("pattern") or {}).get("Regex")
        if regex not in SPLIT_PATTERNS:
            raise ValueError(f"Split pattern {regex!r} is not supported: the port reads Qwen2's,"
                             " Llama-3's and BLOOM's")
        if split.get("behavior") != "Isolated" or split.get("invert"):
            raise ValueError(f"Split behavior `{split.get('behavior')}` (invert"
                             f" {split.get('invert')}) is not supported: the port reads Isolated")
        if level.get("use_regex", True) or level.get("add_prefix_space"):
            raise ValueError("a ByteLevel after Split with use_regex or add_prefix_space is not"
                             " supported")
        return False, split_pattern(regex)
    raise ValueError(f"pre-tokenizer `{kind}` is not supported: the port's BPE tokenizer"
                     " reads ByteLevel and Sequence[Split, ByteLevel] only")


def _spm_pre_tokenizer(spec: Optional[dict]) -> tuple:
    """(Metaspace's (replacement, prepend scheme) or None, whether a word
    ends after each space) of a sentencepiece-style file's pre-tokenizer:
    none, Metaspace without split, or Split(" ", MergedWithPrevious)."""
    kind = None if spec is None else spec.get("type")
    if kind is None:
        return None, False
    if kind == "Metaspace":
        scheme = spec.get("prepend_scheme", "always")
        if spec.get("split", True):
            raise ValueError("Metaspace with split true is not supported by the port's BPE"
                             " tokenizer (it reads Llama's, split false)")
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"Metaspace prepend_scheme `{scheme}` is not supported")
        return (spec.get("replacement", SPIECE), scheme), False
    if kind == "Split":
        pattern = spec.get("pattern") or {}
        if pattern != {"String": " "} or spec.get("behavior") != "MergedWithPrevious" \
                or spec.get("invert"):
            raise ValueError(f"Split on {pattern} with behavior `{spec.get('behavior')}` (invert"
                             f" {spec.get('invert')}) is not supported: the port reads Gemma's,"
                             " on the string \" \" merged with the previous piece")
        return None, True
    raise ValueError(f"pre-tokenizer `{kind}` is not supported: the port's BPE tokenizer reads"
                     " ByteLevel, Sequence[Split, ByteLevel], Metaspace, Split on \" \" and none")


def _normalizer(spec: Optional[dict]):
    """A str -> str function for a tokenizer.json normalizer (None for
    none): NFC, Prepend (to a non-empty text), Replace of a string, or a
    Sequence of them."""
    kind = None if spec is None else spec.get("type")
    if kind is None:
        return None
    if kind == "NFC":
        return unicode.nfc
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Replace" and "String" in (spec.get("pattern") or {}):
        old, new = spec["pattern"]["String"], spec["content"]
        return lambda s: s.replace(old, new) if old else s
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec.get("normalizers") or []]

        def run(s: str) -> str:
            for part in parts:
                s = part(s)
            return s

        return run
    what = "Replace of a Regex" if kind == "Replace" else kind
    raise ValueError(f"normalizer `{what}` is not supported by the port's BPE tokenizer (it reads"
                     " NFC, Prepend, Replace of a string and a Sequence of them)")


def _post_processor(spec: Optional[dict]) -> tuple:
    """(ids before, ids after) the text: nothing for ByteLevel, a Sequence's
    one template, else unigram.py's `_template`."""
    kind = None if spec is None else spec.get("type")
    if kind == "ByteLevel":
        return [], []
    if kind == "Sequence":
        templates = [p for p in spec.get("processors") or [] if p.get("type") != "ByteLevel"]
        if len(templates) > 1:
            raise ValueError("a Sequence post-processor with more than one template is not"
                             " supported")
        return _template(templates[0]) if templates else ([], [])
    return _template(spec)


def legacy_spec(path: str, config: Optional[dict] = None,
                tok_class: Optional[str] = None) -> dict:
    """A directory's vocab.json and merges.txt laid out as the tokenizer.json
    transformers' RobertaConverter makes of them, or its GPT2Converter for
    a GPT-2 `tok_class` (`config`: the tokenizer_config.json, for the
    special tokens and GPT-2's `add_bos_token`)."""
    config = config or {}
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
    gpt2 = tok_class in GPT2_CLASSES
    defaults = _GPT2_SPECIALS if gpt2 else _SPECIALS
    keys = [*defaults, *(["pad_token"] if gpt2 and config.get("pad_token") else [])]
    tokens = {key: _token_content(config.get(key, defaults.get(key))) for key in keys}
    for token in tokens.values():
        if token not in vocab:
            raise ValueError(f"the special token `{token}` is not in vocab.json")
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": key == "mask_token",
              "rstrip": False, "normalized": key != "mask_token", "special": True}
             for key, t in tokens.items()]
    if not gpt2:
        post = {"type": "RobertaProcessing",
                "sep": [tokens["sep_token"], vocab[tokens["sep_token"]]],
                "cls": [tokens["cls_token"], vocab[tokens["cls_token"]]]}
    elif config.get("add_bos_token", False):
        bos = tokens["bos_token"]
        post = {"type": "TemplateProcessing", "single": [{"SpecialToken": {"id": bos}},
                                                         {"Sequence": {"id": "A"}}],
                "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]], "tokens": [bos]}}}
    else:
        post = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
                "use_regex": True}
    return {
        "added_tokens": list({tok["content"]: tok for tok in added}.values()),
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
        "post_processor": post,
        "model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def _class_specials(config: dict, model_type: Optional[str]) -> tuple:
    """(class name, its default special tokens) of the tokenizer class
    (tokenizer_config.json's, else the model type's); refuses a class that
    is not a RoBERTa, Qwen2, Llama, Gemma, GPT-2, BLOOM, GPT-NeoX or plain
    one."""
    name = config.get("tokenizer_class") or _DEFAULT_CLASS.get(model_type, ROBERTA_CLASSES[0])
    read = (ROBERTA_CLASSES + QWEN2_CLASSES + LLAMA_CLASSES + GEMMA_CLASSES + GPT2_CLASSES
            + BLOOM_CLASSES + GPT_NEOX_CLASSES + PLAIN_CLASSES)
    if name not in read:
        raise ValueError(f"tokenizer class `{name}` is not supported by the port's BPE tokenizer"
                         f" (it reads {', '.join(read)})")
    if name in ROBERTA_CLASSES:
        return name, _SPECIALS
    if name in LLAMA_CLASSES:
        return name, _LLAMA_SPECIALS
    if name in GEMMA_CLASSES:
        return name, _GEMMA_SPECIALS
    if name in GPT2_CLASSES + GPT_NEOX_CLASSES:
        return name, _GPT2_SPECIALS
    if name in BLOOM_CLASSES:
        return name, _BLOOM_SPECIALS
    return name, (_QWEN2_SPECIALS if name in QWEN2_CLASSES else {})


class BPE:
    """Tokenize texts into input ids and attention masks from a parsed
    `tokenizer.json` whose model is BPE, over ByteLevel words or
    sentencepiece-style ones (`config`: the checkpoint's
    tokenizer_config.json; `model_type`: its config.json's, which names
    the tokenizer class when `config` does not)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 model_type: Optional[str] = None):
        config = config or {}
        model = spec.get("model") or {}
        kind = model.get("type")
        if kind != "BPE":
            raise ValueError(f"tokenizer model `{kind}` is not supported by the port's BPE"
                             " tokenizer")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise ValueError(f"BPE with {key} {model[key]!r} is not supported")
        self.normalize = _normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        self.byte_level = (pre or {}).get("type") in ("ByteLevel", "Sequence")
        self.vocab = dict(model["vocab"])
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        if self.byte_level:
            for key in ("byte_fallback", "fuse_unk"):
                if model.get(key):
                    raise ValueError(f"BPE with {key} {model[key]!r} over ByteLevel words is not"
                                     " supported: the port reads it in sentencepiece-style files")
            self.use_regex, self.split = _pre_tokenizer(pre)
            missing = [c for c in bytes_to_unicode().values() if c not in self.vocab]
            if missing:
                raise ValueError(f"the BPE vocabulary lacks {len(missing)} byte symbols, such as"
                                 f" `{missing[0]}`: the port reads byte-level vocabularies only")
            self.metaspace, self.space_words = None, False
        else:
            self.use_regex, self.split = False, None
            self.metaspace, self.space_words = _spm_pre_tokenizer(pre)
        self.unk = model.get("unk_token")
        if self.unk is not None and self.unk not in self.vocab:
            raise ValueError(f"the BPE unk_token `{self.unk}` is not in the vocabulary")
        # each byte's fallback piece, where the vocabulary holds it
        self.byte_pieces = {b: byte_piece(b) for b in range(256) if byte_piece(b) in self.vocab}
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.ranks = {}
        for rank, merge in enumerate(model.get("merges") or []):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            if a + b not in self.vocab:
                raise ValueError(f"the merge `{a} {b}` makes a token the vocabulary lacks")
            self.ranks[a, b] = rank  # a repeated merge keeps its last rank

        name, defaults = _class_specials(config, model_type)
        spm_class = name in LLAMA_CLASSES + GEMMA_CLASSES
        roberta = name in ROBERTA_CLASSES
        if name in LLAMA_CLASSES and config.get("add_prefix_space") is not None:
            raise ValueError(f"{name} with add_prefix_space is not supported: transformers then"
                             " rebuilds the tokenizer from the sentencepiece model")
        if name in BLOOM_CLASSES and config.get("add_prefix_space"):
            raise ValueError(f"{name} with add_prefix_space true is not supported: the class"
                             " then sets the flag of the ByteLevel after its Split, which the"
                             " port does not run")
        # transformers sets a ByteLevel pre-tokenizer's flag from the config;
        # a Sequence keeps its own (false)
        self.add_prefix_space = (self.byte_level and self.split is None
                                 and bool(config.get("add_prefix_space", False)))
        self.padding_side = config.get("padding_side", "left" if spm_class else "right")
        self.truncation_side = config.get("truncation_side", "right")
        for key in ("padding_side", "truncation_side"):
            if getattr(self, key) not in ("right", "left"):
                raise ValueError(f"{key} `{getattr(self, key)}` is not right or left")

        tokens = {tok["content"]: dict(tok) for tok in spec.get("added_tokens") or []}
        flagged = list((config.get("added_tokens_decoder") or {}).values())
        for key in _SPECIALS:
            value = config.get(key, defaults.get(key))
            if isinstance(value, dict):
                flagged.append(value)
            elif roberta and key == "mask_token" and isinstance(value, str):
                flagged.append({"content": value, "lstrip": True})
            elif isinstance(value, str) and value not in tokens:
                flagged.append({"content": value})
        for tok in flagged:
            content = tok["content"]
            tid = tokens[content]["id"] if content in tokens else self.vocab.get(content)
            if tid is None:
                raise ValueError(f"the special token `{content}` ({name}'s) is not in the"
                                 " vocabulary")
            tokens[content] = {**tok, "id": tid}
        for content, tok in tokens.items():
            if tok.get("single_word"):
                raise ValueError(f"added token `{content}` is single_word, which the port does"
                                 " not support")
        self.added = {t: tok["id"] for t, tok in tokens.items()}

        def matched(normalized: bool) -> AddedTokens:
            return AddedTokens({t: (tok["id"], tok.get("lstrip", False), tok.get("rstrip", False))
                                for t, tok in tokens.items()
                                if bool(tok.get("normalized")) == normalized})

        self._raw, self._normalized = matched(False), matched(True)

        if name in _REBUILT_TEMPLATES:
            # update_post_processor: the class's template, not the file's
            self.before, self.after = [], []
            bos_on, eos_on = _REBUILT_TEMPLATES[name]
            for key, flag, on, side in (("bos_token", "add_bos_token", bos_on, self.before),
                                        ("eos_token", "add_eos_token", eos_on, self.after)):
                if config.get(flag, on):
                    token = _token_content(config.get(key, defaults.get(key)))
                    if token is None:
                        raise ValueError(f"{flag} is true but tokenizer_config.json names no"
                                         f" {key}")
                    side.append(self.token_to_id(token))
        else:
            self.before, self.after = _post_processor(spec.get("post_processor"))

        pad = _token_content(config.get("pad_token", None if roberta else defaults.get("pad_token")))
        if pad is None and not roberta:
            raise ValueError(f"tokenizer_config.json names no pad token, and {name} has none:"
                             " transformers raises \"Asking to pad but the tokenizer does not have"
                             " a padding token\" on a padded call")
        pad = pad or _SPECIALS["pad_token"]
        self.pad = self.token_to_id(pad)
        if self.pad is None:
            raise ValueError(f"the pad token `{pad}` is not in the tokenizer")
        self._words: dict = {}
        self._lock = threading.Lock()

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    # -- one word ------------------------------------------------------------

    def _symbols(self, word: str) -> list:
        """A sentencepiece-style word's symbols before any merge: its
        characters, those the vocabulary lacks as their bytes' pieces
        (byte_fallback) or as unk (fuse_unk: a run of them as one; byte
        pieces met while the run is open go before it), else dropped."""
        out, vocab, open_unk = [], self.vocab, False
        for ch in word:
            if ch in vocab:
                if open_unk:
                    out.append(self.unk)
                    open_unk = False
                out.append(ch)
                continue
            if self.byte_fallback:
                pieces = [self.byte_pieces.get(b) for b in ch.encode("utf-8")]
                if None not in pieces:
                    out += pieces
                    continue
            if self.unk is not None:
                if open_unk and not self.fuse_unk:
                    out.append(self.unk)
                open_unk = True
        if open_unk:
            out.append(self.unk)
        return out

    def _merge(self, symbols) -> list:
        """The symbols after every merge, the adjacent pair of lowest rank
        first (on a tie the leftmost): a heap of candidate pairs over a
        linked list, an entry skipped once its pair has changed."""
        symbols = list(symbols)
        ranks = self.ranks
        n = len(symbols)
        nxt = [*range(1, n), -1]
        prv = list(range(-1, n - 1))
        heap = []
        for i in range(n - 1):
            rank = ranks.get((symbols[i], symbols[i + 1]))
            if rank is not None:
                heap.append((rank, i))
        heapq.heapify(heap)
        while heap:
            rank, i = heapq.heappop(heap)
            j = nxt[i]
            if symbols[i] is None or j < 0 or ranks.get((symbols[i], symbols[j])) != rank:
                continue  # merged away, or its pair changed since it was pushed
            symbols[i] += symbols[j]
            symbols[j] = None
            k = nxt[i] = nxt[j]
            if k >= 0:
                prv[k] = i
                rank = ranks.get((symbols[i], symbols[k]))
                if rank is not None:
                    heapq.heappush(heap, (rank, i))
            p = prv[i]
            if p >= 0:
                rank = ranks.get((symbols[p], symbols[i]))
                if rank is not None:
                    heapq.heappush(heap, (rank, p))
        return [sym for sym in symbols if sym is not None]

    def _word_ids(self, word: str) -> list:
        ids = self._words.get(word)
        if ids is None:
            if self.ignore_merges and word in self.vocab:
                ids = [self.vocab[word]]
            else:
                symbols = word if self.byte_level else self._symbols(word)
                ids = [self.vocab[symbol] for symbol in self._merge(symbols)]
            with self._lock:
                if len(self._words) >= _WORD_CACHE_MAX:
                    self._words.clear()
                self._words[word] = ids
        return ids

    # -- one text ------------------------------------------------------------

    def _words_of(self, part: str, at_start: bool) -> list:
        """The pre-tokenizer's words of one piece between added tokens
        (`at_start`: the piece starts the text)."""
        if self.byte_level:
            return byte_level_words(part, self.add_prefix_space, self.use_regex, self.split)
        if self.metaspace is not None:
            replacement, scheme = self.metaspace
            part = part.replace(" ", replacement)
            if not part.startswith(replacement) and (
                    scheme == "always" or (scheme == "first" and at_start)):
                part = replacement + part
        return _SPACE_WORDS.findall(part) if self.space_words else [part]

    def _piece_ids(self, piece: str, at_start: bool) -> list:
        out = []
        if self.normalize is not None:
            piece = self.normalize(piece)
        for i, part in enumerate(self._normalized.split(piece)):
            if isinstance(part, int):
                out.append(part)
            elif part:
                for word in self._words_of(part, at_start and i == 0):
                    out += self._word_ids(word)
        return out

    def ids(self, text: str) -> list:
        """The ids of one text, without the template's special tokens."""
        out = []
        for i, part in enumerate(self._raw.split(text)):
            if isinstance(part, int):
                out.append(part)
            elif part:
                out += self._piece_ids(part, i == 0)
        return out

    # -- a batch -------------------------------------------------------------

    def __call__(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask), (len(texts), longest) int64 CPU
        tensors: the template around each text's ids, truncated to
        max_len (on the truncation side), padded with the pad token (on
        the padding side)."""
        room = max(max_len - len(self.before) - len(self.after), 0)
        rows = []
        for t in texts:
            ids = self.ids(t)
            ids = ids[:room] if self.truncation_side == "right" else ids[max(len(ids) - room, 0):]
            rows.append([*self.before, *ids, *self.after])
        width = max((len(r) for r in rows), default=0)
        ids = torch.full((len(rows), width), self.pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            at = width - len(r) if self.padding_side == "left" else 0
            ids[i, at:at + len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, at:at + len(r)] = 1
        return ids, mask
