"""Byte-level BPE tokenization, as the `tokenizers` library runs it (what
`AutoTokenizer` gives a RoBERTa checkpoint, `RobertaTokenizerFast`, and a
ModernBERT one, `PreTrainedTokenizerFast`).

The JAX package tokenizes through `AutoTokenizer(texts, padding=True,
truncation=True, max_length=max_len)`. This module reads the same files
and gives the same input ids and attention masks, on the host:

1. added tokens are cut out and kept whole, leftmost and longest first:
   those matched on the raw text, then the normalizer (none, or `NFC` as
   in ModernBERT's file; any other is refused) on each piece left, and,
   inside it, those marked `normalized`; `lstrip`/`rstrip` take the
   whitespace beside them. Besides the file's `added_tokens`, the special
   tokens of tokenizer_config.json count, as the class it names adds
   them: a token given as a dict keeps its flags, and
   `added_tokens_decoder` overrides the file's flags. A RoBERTa class
   (`RobertaTokenizer`, the default of every family but `modernbert`)
   also gives `RobertaTokenizerFast`'s defaults (`<s>`, `</s>`, `<unk>`,
   `<pad>`, `<mask>`) to the keys the config leaves out, and makes
   `<mask>` given as a string `lstrip`; `PreTrainedTokenizerFast` (the
   class of ModernBERT's file, and `modernbert`'s default) adds only what
   the config names, with the file's flags. Any other class is refused;
2. the ByteLevel pre-tokenizer on each piece between added tokens: a
   space in front when `add_prefix_space` and the piece does not start
   with one (transformers sets the flag from tokenizer_config.json,
   default false, whatever the file says), then GPT-2's split regex
   (`use_regex`): `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
   ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`, with `\\p{L}`, `\\p{N}` and `\\s`
   the classes of `tokenizers`' own regex engine (models/unicode.py's
   frozen tables; Python's `re` knows no `\\p` class). Each word's UTF-8
   bytes become GPT-2's printable byte symbols (`bytes_to_unicode`);
3. BPE on each word: its byte symbols are merged pair by pair, always the
   adjacent pair of lowest merge rank (on a tie, the leftmost), until no
   adjacent pair has a merge; every symbol is then in the vocabulary (it
   holds the 256 byte symbols and every merge's result). Words are cached;
4. the post-processor (`RobertaProcessing`: `<s> $A </s>`, or a
   `TemplateProcessing`) after truncation to `max_len` less the special
   tokens, and padding with the pad token to the longest text of the call.

`legacy_spec` reads the older layout, `vocab.json` and `merges.txt` with
no tokenizer.json, as transformers' `RobertaConverter` converts it (the
first line of merges.txt and the text after its last newline are
skipped, as `RobertaTokenizer` reads it).

Anything else raises `ValueError` naming it: another model, `dropout`,
`byte_fallback`, a `continuing_subword_prefix` or `end_of_word_suffix`,
`ignore_merges`, `fuse_unk`, a vocabulary without the 256 byte symbols,
a normalizer other than NFC, a pre-tokenizer that is not ByteLevel
(Metaspace, ...), a `single_word` added token, another tokenizer class,
or a special token the vocabulary lacks.
"""

from __future__ import annotations

import json
import os
import re
import threading
from functools import lru_cache
from typing import Optional

import torch

from . import unicode
from .unigram import AddedTokens, _template, _token_content

_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied
# the tokenizer classes read (when tokenizer_config.json names none, the
# model type decides: `modernbert` PreTrainedTokenizerFast, any other
# RobertaTokenizer)
ROBERTA_CLASSES = ("RobertaTokenizer", "RobertaTokenizerFast")
PLAIN_CLASSES = ("PreTrainedTokenizerFast",)
# RobertaTokenizerFast's special tokens and their defaults
_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "sep_token": "</s>",
             "pad_token": "<pad>", "cls_token": "<s>", "mask_token": "<mask>"}


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
def split_pattern() -> re.Pattern:
    """GPT-2's split regex over `tokenizers`' letter, number and space classes."""
    letter = unicode.ranges("BYTE_LEVEL_LETTER").char_class()
    number = unicode.ranges("BYTE_LEVEL_NUMBER").char_class()
    space = unicode.ranges("BYTE_LEVEL_SPACE").char_class()
    return re.compile(
        f"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+| ?[^{space}{letter}{number}]+"
        f"|[{space}]+(?![^{space}])|[{space}]+"
    )


def byte_level_words(text: str, add_prefix_space: bool = False, use_regex: bool = True) -> list:
    """The ByteLevel pre-tokenizer: the words of `text` in byte symbols."""
    if add_prefix_space and text and not text.startswith(" "):
        text = " " + text
    pieces = split_pattern().findall(text) if use_regex else [text]
    table = bytes_to_unicode()
    return [piece.encode("utf-8").decode("latin-1").translate(table) for piece in pieces if piece]


def _byte_level(spec: Optional[dict]) -> bool:
    """`use_regex` of a ByteLevel pre-tokenizer (refusing any other)."""
    kind = None if spec is None else spec.get("type")
    if kind != "ByteLevel":
        raise ValueError(f"pre-tokenizer `{kind}` is not supported: the port's BPE tokenizer"
                         " reads ByteLevel only")
    return spec.get("use_regex", True)


def legacy_spec(path: str, config: Optional[dict] = None) -> dict:
    """A directory's vocab.json and merges.txt laid out as the tokenizer.json
    transformers' RobertaConverter makes of them (`config`: the
    tokenizer_config.json, for the special tokens)."""
    config = config or {}
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
    tokens = {key: _token_content(config.get(key, default)) for key, default in _SPECIALS.items()}
    for token in tokens.values():
        if token not in vocab:
            raise ValueError(f"the special token `{token}` is not in vocab.json")
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": key == "mask_token",
              "rstrip": False, "normalized": key != "mask_token", "special": True}
             for key, t in tokens.items()]
    return {
        "added_tokens": list({tok["content"]: tok for tok in added}.values()),
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": [tokens["sep_token"], vocab[tokens["sep_token"]]],
                           "cls": [tokens["cls_token"], vocab[tokens["cls_token"]]]},
        "model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def _roberta_class(config: dict, model_type: Optional[str]) -> bool:
    """Whether the tokenizer class (tokenizer_config.json's, else the model
    type's) is a RoBERTa one, with its default specials; refuses a class
    that is neither that nor PreTrainedTokenizerFast."""
    name = config.get("tokenizer_class") or (
        PLAIN_CLASSES[0] if model_type == "modernbert" else ROBERTA_CLASSES[0])
    if name not in ROBERTA_CLASSES + PLAIN_CLASSES:
        raise ValueError(f"tokenizer class `{name}` is not supported by the port's BPE tokenizer"
                         f" (it reads {', '.join(ROBERTA_CLASSES + PLAIN_CLASSES)})")
    return name in ROBERTA_CLASSES


class BPE:
    """Tokenize texts into input ids and attention masks from a parsed
    `tokenizer.json` whose model is BPE over ByteLevel words (`config`:
    the checkpoint's tokenizer_config.json; `model_type`: its
    config.json's, which names the tokenizer class when `config` does
    not)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 model_type: Optional[str] = None):
        config = config or {}
        model = spec.get("model") or {}
        kind = model.get("type")
        if kind != "BPE":
            raise ValueError(f"tokenizer model `{kind}` is not supported by the port's BPE"
                             " tokenizer")
        for key in ("dropout", "byte_fallback", "continuing_subword_prefix", "end_of_word_suffix",
                    "ignore_merges", "fuse_unk"):
            if model.get(key):
                raise ValueError(f"BPE with {key} {model[key]!r} is not supported")
        normalizer = (spec.get("normalizer") or {}).get("type")
        if normalizer not in (None, "NFC"):
            raise ValueError(f"normalizer `{normalizer}` is not supported by the port's BPE"
                             " tokenizer (it reads none or NFC)")
        self.normalize = unicode.nfc if normalizer == "NFC" else None
        self.use_regex = _byte_level(spec.get("pre_tokenizer"))
        self.vocab = dict(model["vocab"])
        missing = [c for c in bytes_to_unicode().values() if c not in self.vocab]
        if missing:
            raise ValueError(f"the BPE vocabulary lacks {len(missing)} byte symbols, such as"
                             f" `{missing[0]}`: the port reads byte-level vocabularies only")
        self.ranks = {}
        for rank, merge in enumerate(model.get("merges") or []):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            if a + b not in self.vocab:
                raise ValueError(f"the merge `{a} {b}` makes a token the vocabulary lacks")
            self.ranks[a, b] = rank  # a repeated merge keeps its last rank
        self.add_prefix_space = bool(config.get("add_prefix_space", False))
        self.before, self.after = _template(spec.get("post_processor"))

        roberta = _roberta_class(config, model_type)
        tokens = {tok["content"]: dict(tok) for tok in spec.get("added_tokens") or []}
        flagged = list((config.get("added_tokens_decoder") or {}).values())
        for key, default in _SPECIALS.items():
            value = config.get(key, default if roberta else None)
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
                raise ValueError(f"the special token `{content}` is not in the vocabulary")
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

        pad = _token_content(config.get("pad_token"))
        if pad is None and not roberta:
            raise ValueError("tokenizer_config.json names no pad token")
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

    def _merge(self, word: str) -> list:
        """The word's symbols after every merge, lowest rank first."""
        symbols = list(word)
        ranks = self.ranks
        while len(symbols) > 1:
            best, at = None, -1
            for i in range(len(symbols) - 1):
                rank = ranks.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best is None or rank < best):
                    best, at = rank, i
            if best is None:
                break
            symbols[at:at + 2] = [symbols[at] + symbols[at + 1]]
        return symbols

    def _word_ids(self, word: str) -> list:
        ids = self._words.get(word)
        if ids is None:
            ids = [self.vocab[symbol] for symbol in self._merge(word)]
            with self._lock:
                if len(self._words) >= _WORD_CACHE_MAX:
                    self._words.clear()
                self._words[word] = ids
        return ids

    # -- one text ------------------------------------------------------------

    def _piece_ids(self, piece: str) -> list:
        out = []
        if self.normalize is not None:
            piece = self.normalize(piece)
        for part in self._normalized.split(piece):
            if isinstance(part, int):
                out.append(part)
            elif part:
                for word in byte_level_words(part, self.add_prefix_space, self.use_regex):
                    out += self._word_ids(word)
        return out

    def ids(self, text: str) -> list:
        """The ids of one text, without the template's special tokens."""
        out = []
        for part in self._raw.split(text):
            if isinstance(part, int):
                out.append(part)
            elif part:
                out += self._piece_ids(part)
        return out

    # -- a batch -------------------------------------------------------------

    def __call__(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask), (len(texts), longest) int64 CPU
        tensors: the template around each text's ids, truncated to
        max_len, padded with the pad token."""
        room = max(max_len - len(self.before) - len(self.after), 0)
        rows = [[*self.before, *self.ids(t)[:room], *self.after] for t in texts]
        width = max((len(r) for r in rows), default=0)
        ids = torch.full((len(rows), width), self.pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, : len(r)] = 1
        return ids, mask
