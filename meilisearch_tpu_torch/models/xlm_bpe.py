"""XLM's and FlauBERT's own tokenizers, as transformers' slow
`XLMTokenizer` and `FlaubertTokenizer` run them: Moses, then a BPE whose
word ends carry `</w>`, from `vocab.json` + `merges.txt`.

The JAX package's encoder gets them from `AutoTokenizer` for an `xlm` or
`flaubert` checkpoint (transformers has no fast class for either). This
is the same pipeline, on the host, with the port's own Moses
(models/moses.py):

1. XLM, when `do_lowercase_and_remove_accent` (its default; false for
   XLM-17 and XLM-100): `PreTrainedTokenizer.tokenize` lowercases the text
   character by character before anything else, every special token
   written in it kept as it is (`tokenization_utils.py:644`: the class's
   `do_lower_case` is that flag). So `<S>` becomes the special `<s>`, and
   Moses's sentence-period rule sees lowercase words: "World. Café"
   keeps "world." whole (a lowercase word follows), and "No. 5" splits
   (lowercase "no" is not English's numeric-only prefix);
2. the added tokens (tokenizer_config.json's `added_tokens_decoder`, and
   the special tokens: `<s>`, `</s>`, `<pad>`, `<unk>`, `<special0>` to
   `<special9>` by default) are cut out of the text, leftmost and longest
   first, each one id; a `single_word` token is refused by name;
3. each piece between them, FlauBERT's first through its
   `preprocess_text` (two backquotes and two single quotes to `"`, NFC,
   lowercased whole only with `do_lowercase`; accents are never removed),
   goes through Moses (models/moses.py: "en" for XLM, the default the
   reference's encoder never changes; "fr" for FlauBERT);
4. XLM, with the same flag, then `lowercase_and_remove_accent`: the
   tokens joined by spaces, lowercased, NFD, every `Mn` character
   dropped, lowercased again, split on spaces;
5. each nonempty token through the BPE: its characters, the last with
   `</w>`, merged by rank (merges.txt: every line but the file's last
   split on whitespace, its first two fields a pair, counts ignored, a
   repeated pair keeping its last rank), each piece an added token's id,
   else vocab.json's, else `<unk>`'s; words are cached;
6. `<s> A </s>` around each text (bos and sep), truncated to `max_len`
   with both kept, padded on the right with `<pad>`'s id to the call's
   longest text; token types all 0 (TextEncoder passes them: the model
   looks them up in its word table).

NFD, NFC and the `Mn` and `C*` categories are Python's `unicodedata`,
which is what transformers' slow tokenizers ask.
"""

from __future__ import annotations

import re
import threading
import unicodedata
from typing import Optional

import torch

from .moses import moses_tokenize
from .unigram import _token_content

CLASSES = ("XLMTokenizer", "FlaubertTokenizer")
_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied
# both classes' special tokens by their tokenizer_config.json keys, in
# `all_special_tokens`' order, and their defaults (no eos)
SPECIALS = {"bos_token": "<s>", "eos_token": None, "unk_token": "<unk>", "sep_token": "</s>",
            "pad_token": "<pad>", "cls_token": "</s>", "mask_token": "<special1>"}
ADDITIONAL = tuple(f"<special{i}>" for i in range(10))


def read_merges(text: str) -> dict:
    """merges.txt's pair -> rank, as both classes read it."""
    merges = [tuple(line.split()[:2]) for line in text.split("\n")[:-1]]
    return dict(zip(merges, range(len(merges))))


def lowercase_and_remove_accent(tokens: list) -> list:
    text = unicodedata.normalize("NFD", " ".join(tokens).lower())
    return "".join(c for c in text if unicodedata.category(c) != "Mn").lower().split(" ")


def _lower_chars(text: str) -> str:
    """`str.lower` one character at a time (a final capital sigma stays σ)."""
    return text.lower() if "Σ" not in text else "".join(c.lower() for c in text)


class MosesBPE:
    """Tokenize texts into input ids and attention masks as `XLMTokenizer`
    or `FlaubertTokenizer` (`tokenizer_class`) does, from vocab.json's
    token -> id, merges.txt's text and tokenizer_config.json (`config`)."""

    def __init__(self, vocab: dict, merges: str, config: Optional[dict] = None,
                 tokenizer_class: str = "XLMTokenizer"):
        if tokenizer_class not in CLASSES:
            raise ValueError(f"`{tokenizer_class}` is not XLMTokenizer or FlaubertTokenizer")
        config = config or {}
        self.flaubert = tokenizer_class == "FlaubertTokenizer"
        self.lang = "fr" if self.flaubert else "en"
        # XLM's do_lower_case; FlauBERT's is forced False and lowercases
        # (without removing accents) only in preprocess_text
        self.lower_accent = (not self.flaubert
                             and bool(config.get("do_lowercase_and_remove_accent", True)))
        self.lowercase = self.flaubert and bool(config.get("do_lowercase", False))
        self.vocab = vocab
        self.ranks = read_merges(merges)
        names = {k: _token_content(config.get(k, v)) for k, v in SPECIALS.items()}
        extra = config.get("additional_special_tokens", ADDITIONAL) or ()
        specials = list(dict.fromkeys(
            [t for t in names.values() if t is not None]
            + [_token_content(t) for t in extra]))
        for key in ("unk_token", "bos_token", "sep_token", "pad_token"):
            if names[key] not in vocab:
                raise ValueError(f"vocab.json lacks the {key} `{names[key]}`")
        self.unk, self.pad = vocab[names["unk_token"]], vocab[names["pad_token"]]
        self.before, self.after = [vocab[names["bos_token"]]], [vocab[names["sep_token"]]]
        added = {}  # content -> id
        protected = list(specials)  # kept as written by the first lowercasing
        for tid, tok in (config.get("added_tokens_decoder") or {}).items():
            if tok.get("single_word"):
                raise ValueError(f"added token `{tok['content']}` is single_word, which the port"
                                 " does not support")
            added[tok["content"]] = int(tid)
            if not tok.get("special") and tok.get("normalized"):
                protected.append(tok["content"])
        for token in specials:
            if token not in added:
                if token not in vocab:
                    raise ValueError(f"vocab.json lacks the special token `{token}`")
                added[token] = vocab[token]
        self.added = added
        self._added_rx = re.compile("|".join(
            re.escape(t) for t in sorted(added, key=len, reverse=True)))
        self._protected_rx = re.compile("|".join(map(re.escape, protected)))
        self._words: dict = {}
        self._lock = threading.Lock()

    # -- one text ------------------------------------------------------------

    def _lowercase(self, text: str) -> str:
        """PreTrainedTokenizer.tokenize's lowercasing: every character but
        those of the special tokens written in the text."""
        out, pos = [], 0
        for m in self._protected_rx.finditer(text):
            out += [_lower_chars(text[pos:m.start()]), m.group()]
            pos = m.end()
        out.append(_lower_chars(text[pos:]))
        return "".join(out)

    def _bpe(self, token: str) -> list:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return [token + "</w>"]
        ranks = self.ranks
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda pair: ranks.get(pair, float("inf")))
            if bigram not in ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        pieces = " ".join(word)
        if pieces == "\n  </w>":
            pieces = "\n</w>"
        return pieces.split(" ")

    def _word_ids(self, token: str) -> list:
        ids = self._words.get(token)
        if ids is not None:
            return ids
        ids = [self.added.get(p, self.vocab.get(p, self.unk)) for p in self._bpe(token)]
        with self._lock:
            if len(self._words) >= _WORD_CACHE_MAX:
                self._words.clear()
            self._words[token] = ids
        return ids

    def _piece_ids(self, text: str) -> list:
        if self.flaubert:
            text = unicodedata.normalize("NFC", text.replace("``", '"').replace("''", '"'))
            if self.lowercase:
                text = text.lower()
        tokens = moses_tokenize(text, self.lang)
        if self.lower_accent:
            tokens = lowercase_and_remove_accent(tokens)
        out = []
        for token in tokens:
            if token:
                out += self._word_ids(token)
        return out

    def ids(self, text: str) -> list:
        """The ids of one text, without the template's special tokens."""
        if self.lower_accent:
            text = self._lowercase(text)
        out, pos = [], 0
        for m in self._added_rx.finditer(text):
            if m.start() > pos:
                out += self._piece_ids(text[pos:m.start()])
            out.append(self.added[m.group()])
            pos = m.end()
        if pos < len(text):
            out += self._piece_ids(text[pos:])
        return out

    # -- a batch -------------------------------------------------------------

    def __call__(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask), (len(texts), longest) int64 CPU
        tensors: `<s> ids </s>`, truncated to max_len, padded on the
        right with the pad token."""
        room = max(max_len - len(self.before) - len(self.after), 0)
        rows = [[*self.before, *self.ids(t)[:room], *self.after] for t in texts]
        width = max((len(r) for r in rows), default=0)
        ids = torch.full((len(rows), width), self.pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, : len(r)] = 1
        return ids, mask
