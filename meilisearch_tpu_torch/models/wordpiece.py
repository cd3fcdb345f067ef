"""BERT's WordPiece tokenizer, as transformers' `BertTokenizerFast` runs it.

The JAX package's encoder tokenizes through `AutoTokenizer`, which gives a
BERT checkpoint `BertTokenizerFast` (the `tokenizers` library's BERT
pipeline). This is the same pipeline, on the host:

1. special tokens (`[CLS]`, `[SEP]`, `[PAD]`, `[MASK]`, `[UNK]`) written in
   the text are cut out first and kept whole;
2. the normalizer, in this order: drop U+0000, U+FFFD and control
   characters and map whitespace to a space; put spaces around CJK
   ideographs; with `strip_accents` (by default: when lowercasing)
   decompose (NFD) and drop non-spacing marks; lowercase character by
   character;
3. the pre-tokenizer: split on whitespace and cut out each punctuation
   character;
4. WordPiece: the greedy longest match from the left, later pieces with a
   `##` prefix; a word with no full match, or over 100 characters, is
   `[UNK]`;
5. `[CLS]` ids `[SEP]`, truncated to `max_len` with both kept, padded with
   `[PAD]` to the longest text of the call.

Every class and normalization form is `tokenizers`' own, from the frozen
tables of models/unicode.py (BertNormalizer's control, whitespace and CJK
sets, BertPreTokenizer's punctuation and whitespace, NFD and the
non-spacing marks, Lowercase), so no answer depends on the host's
`unicodedata`. Words are cached, so a corpus with a bounded vocabulary
tokenizes at dict speed; ASCII text takes a translate table and one
regular expression.
"""

from __future__ import annotations

import re
import threading
from functools import lru_cache

import torch

from . import unicode

MAX_CHARS_PER_WORD = 100
_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied


class _Clean(dict):
    """BertNormalizer's per-character step as a `str.translate` table,
    filled on first sight of each character: controls (and U+0000,
    U+FFFD) dropped, whitespace to a space, CJK ideographs padded with
    spaces when `chinese`."""

    def __init__(self, chinese: bool):
        super().__init__()
        self.chinese = chinese
        self.control = unicode.ranges("BERT_CONTROL")
        self.space = unicode.ranges("BERT_WHITESPACE")
        self.cjk = unicode.ranges("BERT_CJK")

    def __missing__(self, cp: int):
        if cp in self.control:
            out = None
        elif cp in self.space:
            out = " "
        elif self.chinese and cp in self.cjk:
            out = f" {chr(cp)} "
        else:
            out = cp
        self[cp] = out
        return out


@lru_cache(maxsize=None)
def _words_pattern() -> re.Pattern:
    """BertPreTokenizer: runs of neither whitespace nor punctuation, and
    each punctuation character alone."""
    space = unicode.ranges("BERT_SPLIT_SPACE").char_class()
    punct = unicode.ranges("BERT_PUNCT").char_class()
    return re.compile(f"[^{space}{punct}]+|[{punct}]")


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
        self._clean = _Clean(self.chinese)
        self._words_rx = _words_pattern()
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
        text = text.translate(self._clean)
        if text.isascii():
            return text.lower() if self.lower else text
        if self.strip_accents:
            text = unicode.strip_marks(unicode.nfd(text))
        return unicode.lowercase(text) if self.lower else text

    def _split(self, text: str) -> list:
        """Normalized, whitespace- and punctuation-split words of a text
        with no special token in it."""
        return self._words_rx.findall(self._normalize(text))

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
