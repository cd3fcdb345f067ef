"""BERT's WordPiece tokenizer, as transformers' `BertTokenizerFast` and
`MPNetTokenizerFast` run it.

The JAX package's encoder tokenizes through `AutoTokenizer`, which gives a
BERT checkpoint `BertTokenizerFast` (the `tokenizers` library's BERT
pipeline) and an MPNet one `MPNetTokenizerFast` (the same pipeline with
RoBERTa's special tokens: `<s> $A </s>`, `<pad>`, `<mask>`). This is the
same pipeline, on the host:

1. added tokens written in the text are cut out and kept whole, leftmost
   and longest first: those matched on the raw text first, then, inside
   each piece left, after the normalizer, those marked `normalized`
   (their content normalized too, so MPNet's `<MASK>` is `<mask>`);
   `lstrip`/`rstrip` take the whitespace beside them. They are the
   tokenizer.json's `added_tokens`, then those of tokenizer_config.json's
   `added_tokens_decoder` and its special tokens that the file lacks (a
   token given as a dict keeps its flags; given as a string it is matched
   on the raw text, and MPNet's mask token is `lstrip`). BERT's specials
   (`[CLS]`, `[SEP]`, `[PAD]`, `[MASK]`, `[UNK]`) are matched on the raw
   text;
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
5. the post-processor's template (the tokenizer.json's; without one,
   `[CLS] $A [SEP]`, or `<s> $A </s>` for MPNet, as transformers'
   converters write it), truncated to `max_len` with the specials kept,
   padded with the pad token to the longest text of the call.

Every class and normalization form is `tokenizers`' own, from the frozen
tables of models/unicode.py (BertNormalizer's control, whitespace and CJK
sets, BertPreTokenizer's punctuation and whitespace, NFD and the
non-spacing marks, Lowercase), so no answer depends on the host's
`unicodedata`. Words are cached, so a corpus with a bounded vocabulary
tokenizes at dict speed; ASCII text takes a translate table and one
regular expression. A tokenizer.json whose normalizer is not
BertNormalizer, whose pre-tokenizer is not BertPreTokenizer or whose
model has another subword prefix or word limit is refused, and so is a
`single_word` added token.
"""

from __future__ import annotations

import re
import threading
from functools import lru_cache
from typing import Optional

import torch

from . import unicode
from .unigram import AddedTokens, _template, _token_content

MAX_CHARS_PER_WORD = 100
_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied
# the special tokens of BertTokenizerFast and MPNetTokenizerFast, by their
# tokenizer_config.json keys, and their defaults
BERT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                 "cls_token": "[CLS]", "mask_token": "[MASK]"}
MPNET_SPECIALS = {"unk_token": "[UNK]", "sep_token": "</s>", "pad_token": "<pad>",
                  "cls_token": "<s>", "mask_token": "<mask>"}


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
        added: Optional[dict] = None,
        template: Optional[tuple] = None,
    ):
        """`added`: content -> (id, lstrip, rstrip, normalized), by default
        the special tokens the vocabulary holds, matched on the raw text;
        `template`: (ids before, ids after) a text, by default ([CLS],
        [SEP])."""
        self.vocab = {token: i for i, token in enumerate(vocab)}
        self.lower = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.chinese = tokenize_chinese_chars
        for token in (unk_token, sep_token, pad_token, cls_token):
            if token not in self.vocab:
                raise ValueError(f"the vocabulary lacks `{token}`")
        self.unk, self.pad = self.vocab[unk_token], self.vocab[pad_token]
        self.before, self.after = template or ([self.vocab[cls_token]], [self.vocab[sep_token]])
        if added is None:
            added = {t: (self.vocab[t], False, False, False)
                     for t in (unk_token, sep_token, pad_token, cls_token, mask_token)
                     if t in self.vocab}
        self._clean = _Clean(self.chinese)
        self._words_rx = _words_pattern()
        self._raw = AddedTokens({t: a[:3] for t, a in added.items() if not a[3]})
        self._normalized = AddedTokens({self._normalize(t): a[:3] for t, a in added.items()
                                        if a[3]})
        self._words: dict = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, vocab: list, config: dict, spec: Optional[dict] = None,
                    model_type: Optional[str] = None) -> "WordPiece":
        """From a checkpoint's vocab.txt, tokenizer_config.json and, when
        the directory has one, its WordPiece tokenizer.json (`spec`, for
        its added tokens and template); MPNet's specials when `model_type`
        or the config's `tokenizer_class` names MPNet."""
        mpnet = (model_type == "mpnet"
                 or str(config.get("tokenizer_class") or "").startswith("MPNet"))
        defaults = MPNET_SPECIALS if mpnet else BERT_SPECIALS
        names = {k: _token_content(config.get(k)) or v for k, v in defaults.items()}
        index = {token: i for i, token in enumerate(vocab)}
        tokens = {}  # content -> the added token's dict, "id" included
        template = None
        if spec is not None:
            _check_spec(spec)
            names["unk_token"] = spec["model"].get("unk_token", names["unk_token"])
            tokens = {tok["content"]: tok for tok in spec.get("added_tokens") or []}
            template = _template(spec.get("post_processor"))
        for tid, tok in (config.get("added_tokens_decoder") or {}).items():
            tokens.setdefault(tok["content"], {**tok, "id": int(tid)})
        for key, default in defaults.items():
            value = config.get(key, default)
            content = _token_content(value)
            if content is None or content in tokens or content not in index:
                continue
            flags = value if isinstance(value, dict) else {
                "lstrip": mpnet and key == "mask_token"}
            tokens[content] = {**flags, "content": content, "id": index[content]}
        for content, tok in tokens.items():
            if tok.get("single_word"):
                raise ValueError(f"added token `{content}` is single_word, which the port does"
                                 " not support")
        added = {t: (tok["id"], bool(tok.get("lstrip")), bool(tok.get("rstrip")),
                     bool(tok.get("normalized"))) for t, tok in tokens.items()}
        return cls(
            vocab,
            do_lower_case=config.get("do_lower_case", True),
            strip_accents=config.get("strip_accents"),
            tokenize_chinese_chars=config.get("tokenize_chinese_chars", True),
            **names,
            added=added,
            template=template,
        )

    # -- one text ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        text = text.translate(self._clean)
        if text.isascii():
            return text.lower() if self.lower else text
        if self.strip_accents:
            text = unicode.strip_marks(unicode.nfd(text))
        return unicode.lowercase(text) if self.lower else text

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
        """The ids of one text, without the template's special tokens."""
        out = []
        for part in self._raw.split(text):
            if isinstance(part, int):
                out.append(part)
                continue
            for piece in self._normalized.split(self._normalize(part)):
                if isinstance(piece, int):
                    out.append(piece)
                else:
                    for word in self._words_rx.findall(piece):
                        out += self._word_ids(word)
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


def _check_spec(spec: dict) -> None:
    """Refuse a WordPiece tokenizer.json this module would not follow."""
    kinds = ((spec.get("normalizer") or {}).get("type"),
             (spec.get("pre_tokenizer") or {}).get("type"))
    if kinds != ("BertNormalizer", "BertPreTokenizer"):
        raise ValueError(f"a WordPiece tokenizer.json with normalizer `{kinds[0]}` and"
                         f" pre-tokenizer `{kinds[1]}` is not supported: the port reads"
                         " BertNormalizer and BertPreTokenizer")
    model = spec["model"]
    limits = ("##", MAX_CHARS_PER_WORD)
    if (model.get("continuing_subword_prefix", limits[0]),
            model.get("max_input_chars_per_word", limits[1])) != limits:
        raise ValueError("a WordPiece model with another subword prefix or word limit than"
                         f" `##` and {MAX_CHARS_PER_WORD} is not supported")
