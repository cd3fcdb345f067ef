"""BERT's WordPiece tokenizer, as transformers' `BertTokenizerFast` runs it.

The JAX package's encoder tokenizes through `AutoTokenizer`, which gives a
BERT checkpoint `BertTokenizerFast` (the `tokenizers` library's BERT
pipeline). This is the same pipeline, on the host:

1. special tokens (`[CLS]`, `[SEP]`, `[PAD]`, `[MASK]`, `[UNK]`) written in
   the text are cut out first and kept whole;
2. the normalizer, in this order: drop U+0000, U+FFFD and control
   characters (categories Cc, Cf, Co and Cs, but tab, newline and
   carriage return; unassigned code points stay) and map
   whitespace to a space; put spaces around CJK ideographs; with
   `strip_accents` (by default: when lowercasing) decompose (NFD) and drop
   non-spacing marks (Mn); lowercase character by character;
3. the pre-tokenizer: split on whitespace and cut out each punctuation
   character (ASCII 33-47, 58-64, 91-96, 123-126 and Unicode P*);
4. WordPiece: the greedy longest match from the left, later pieces with a
   `##` prefix; a word with no full match, or over 100 characters, is
   `[UNK]`;
5. `[CLS]` ids `[SEP]`, truncated to `max_len` with both kept, padded with
   `[PAD]` to the longest text of the call.

Words are cached, so a corpus with a bounded vocabulary tokenizes at dict
speed; ASCII text takes a regular-expression path.
"""

from __future__ import annotations

import re
import threading
import unicodedata

import torch

MAX_CHARS_PER_WORD = 100
_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied

# ASCII: control characters go, tab/newline/return become a space
_ASCII_CLEAN = {c: None for c in [*range(0, 9), 11, 12, *range(14, 32), 127]}
_ASCII_CLEAN.update({9: " ", 10: " ", 13: " "})
_CONTROL = ("Cc", "Cf", "Co", "Cs")  # unassigned (Cn) characters stay
_ASCII_PUNCT = "!-/:-@\\[-`{-~"
_ASCII_WORDS = re.compile(f"[^\\s{_ASCII_PUNCT}]+|[{_ASCII_PUNCT}]")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPiece:
    """Tokenize texts into BERT input ids and attention masks."""

    def __init__(
        self,
        vocab: list,
        do_lower_case: bool = True,
        strip_accents=None,
        tokenize_chinese_chars: bool = True,
        unk_token: str = "[UNK]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        mask_token: str = "[MASK]",
    ):
        self.vocab = {token: i for i, token in enumerate(vocab)}
        self.lower = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.chinese = tokenize_chinese_chars
        for token in (unk_token, sep_token, pad_token, cls_token):
            if token not in self.vocab:
                raise ValueError(f"the vocabulary lacks `{token}`")
        self.unk, self.sep = self.vocab[unk_token], self.vocab[sep_token]
        self.pad, self.cls = self.vocab[pad_token], self.vocab[cls_token]
        specials = [
            t for t in (unk_token, sep_token, pad_token, cls_token, mask_token)
            if t in self.vocab
        ]
        # longest first, so one special token never cuts another
        self._specials = re.compile(
            "|".join(re.escape(t) for t in sorted(specials, key=len, reverse=True))
        )
        self._words: dict = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, vocab: list, config: dict) -> "WordPiece":
        """From a checkpoint's vocab.txt and tokenizer_config.json."""
        keys = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
        tokens = {k: config[k] for k in keys if isinstance(config.get(k), str)}
        return cls(
            vocab,
            do_lower_case=config.get("do_lower_case", True),
            strip_accents=config.get("strip_accents"),
            tokenize_chinese_chars=config.get("tokenize_chinese_chars", True),
            **tokens,
        )

    # -- one text ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            if ch in "\t\n\r":
                out.append(" ")
                continue
            if unicodedata.category(ch) in _CONTROL:
                continue
            if ch.isspace():
                out.append(" ")
            elif self.chinese and _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(
                c for c in unicodedata.normalize("NFD", text)
                if unicodedata.category(c) != "Mn"
            )
        if self.lower:
            text = "".join(c.lower() for c in text)
        return text

    def _split(self, text: str) -> list:
        """Normalized, whitespace- and punctuation-split words of a text
        with no special token in it."""
        if text.isascii():
            text = text.translate(_ASCII_CLEAN)
            return _ASCII_WORDS.findall(text.lower() if self.lower else text)
        words = []
        for chunk in self._normalize(text).split():
            start = 0
            for i, ch in enumerate(chunk):
                if _is_punct(ch):
                    if start < i:
                        words.append(chunk[start:i])
                    words.append(ch)
                    start = i + 1
            if start < len(chunk):
                words.append(chunk[start:])
        return words

    def _word_ids(self, word: str) -> list:
        ids = self._words.get(word)
        if ids is not None:
            return ids
        ids = self._wordpiece(word)
        with self._lock:
            if len(self._words) >= _WORD_CACHE_MAX:
                self._words.clear()
            self._words[word] = ids
        return ids

    def _wordpiece(self, word: str) -> list:
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                tid = self.vocab.get(piece)
                if tid is not None:
                    ids.append(tid)
                    break
                end -= 1
            else:
                return [self.unk]
            start = end
        return ids

    def ids(self, text: str) -> list:
        """The ids of one text, without [CLS]/[SEP]."""
        out = []
        pos = 0
        for m in self._specials.finditer(text) if "[" in text else ():
            for word in self._split(text[pos : m.start()]):
                out += self._word_ids(word)
            out.append(self.vocab[m.group()])
            pos = m.end()
        for word in self._split(text[pos:]):
            out += self._word_ids(word)
        return out

    # -- a batch -------------------------------------------------------------

    def __call__(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask), (len(texts), longest) int64 CPU
        tensors: [CLS] ids [SEP], truncated to max_len, padded with [PAD]."""
        rows = [
            [self.cls, *self.ids(t)[: max(max_len - 2, 0)], self.sep] for t in texts
        ]
        width = max((len(r) for r in rows), default=0)
        ids = torch.full((len(rows), width), self.pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, : len(r)] = 1
        return ids, mask
