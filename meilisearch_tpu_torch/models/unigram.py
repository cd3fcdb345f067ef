"""SentencePiece-Unigram tokenization from a `tokenizer.json`, as the
`tokenizers` library runs it (what `AutoTokenizer` gives an XLM-RoBERTa,
XLM-RoBERTa-XL, CamemBERT, DeBERTa-v2, ALBERT, RemBERT, XLNet or BigBird
checkpoint, and BERT checkpoints that carry XLM-R's vocabulary).

The JAX package tokenizes through `AutoTokenizer(texts, padding=True,
truncation=True, max_length=max_len)`. This module reads the same file
and gives the same input ids and attention masks, on the host:

1. added tokens (`added_tokens`, matched on the raw text, leftmost and
   longest first; `lstrip`/`rstrip` take the whitespace beside them) are
   cut out and kept whole; the rest is split around them. Under
   `BigBirdTokenizer(Fast)` (the class of a `tokenizer_class`-less
   `big_bird` checkpoint) the class adds what the file lacks, as
   transformers does: first tokenizer_config.json's
   `added_tokens_decoder` entries with their flags, then its seven
   special tokens (`<s>`, `</s>`, `<unk>`, `<pad>`, `[SEP]`, `[CLS]`,
   `[MASK]` by default; a string `mask_token` with lstrip), each the
   vocabulary's piece;
2. the normalizer, on each piece between added tokens: `Sequence`,
   `Precompiled` (sentencepiece's compiled character map, below), `Strip`,
   `Replace` (a string or a `Regex`), `NFKC`, `NFKD`, `StripAccents`
   (ALBERT's and RemBERT's converters write these two), `Nmt` and
   `Lowercase` (NFKC, NFKD, StripAccents and Lowercase from `tokenizers`'
   own tables, models/unicode.py);
3. the pre-tokenizer: `Metaspace`, alone or as the last of a `Sequence`
   whose first may be `Punctuation` with the `Isolated` behavior (what
   DeBERTa-v2's converter writes when `split_by_punct`): each punctuation
   character (`tokenizers`' class, `BertPreTokenizer`'s, from
   models/unicode.py) becomes a piece of its own. Metaspace, on each
   piece: spaces become U+2581, which is put in front of the piece
   (`prepend_scheme` `always`, `first`: only for the piece at the start
   of the text, or `never`; the legacy `add_prefix_space`), then the
   piece is split before every U+2581 (`split`);
4. the Unigram model: the Viterbi segmentation of each word over the
   pieces' scores (float64; on a tie the path found first stays); a
   character no piece starts with scores the lowest score minus 10, and a
   run of such characters is one `<unk>` (`unk_id`). Words are cached:
   the segmentation depends on the word alone;
5. the post-processor, `TemplateProcessing` or `RobertaProcessing` (`<s>
   $A </s>`, DeBERTa's `[CLS] $A [SEP]`, XLNet's `$A:0 <sep>:0 <cls>:2`),
   after truncation to `max_len` less the special tokens, and padding with
   the pad token (the config's `pad_token`, else the class default: `[PAD]`
   for `deberta-v2`, `<pad>` for the rest) to the longest text of the
   call, on the config's `padding_side`, else the class's: the left for
   `XLNetTokenizer(Fast)` (the class of a `tokenizer_class`-less `xlnet`
   checkpoint), the right for the rest. `encode_types` also gives the
   token type ids: the template's, and for the padding the class's pad
   type (3 for XLNet's, 0 for the rest).

`Precompiled` follows the `spm_precompiled` crate that `tokenizers` wraps.
The blob is a little-endian u32 (the trie's size in bytes), a darts-clone
double array of u32 units, then the NUL-terminated normalized strings.
The text is walked by extended grapheme clusters (Unicode's UAX #29 rules
for everything that can make a cluster under 6 bytes, and the emoji and
Hangul rules): a cluster under 6 bytes is replaced whole by the string of
the SHORTEST key that is a prefix of it (so the rest of the cluster is
dropped), otherwise each character is looked up alone. A text of ASCII
without CR, whose every character is a cluster of its own, goes through
one `str.translate` table instead. The cluster rules read the host's
`unicodedata` categories; they match `tokenizers` on every code point
under the Unicode version `_unicode_tables.CHECKED_UNIDATA` names, and
tests/test_torch_unicode_tables.py fails on a host with another.

Anything else raises `ValueError` naming it: a BPE, WordPiece or WordLevel
model, `byte_fallback: true`, another normalizer or pre-tokenizer, an
added token matched on the normalized text or `single_word`.
`models/fixtures.py` writes such files for the tests and the smoke run.
"""

from __future__ import annotations

import base64
import re
import struct
import threading
import unicodedata
from typing import Optional

import torch

from . import unicode

SPIECE = "▁"
UNK_PENALTY = 10.0
_WORD_CACHE_MAX = 1 << 20  # cached words before the cache is emptied
# the pad token of a model type's tokenizer class, when its
# tokenizer_config.json names none (DebertaV2TokenizerFast's `[PAD]`)
_DEFAULT_PAD = {"deberta-v2": "[PAD]"}
# the tokenizer class AutoTokenizer picks for a model type when
# tokenizer_config.json names none, where it pads otherwise than on the
# right with type 0
_CLASS_OF_TYPE = {"xlnet": "XLNetTokenizer", "big_bird": "BigBirdTokenizer"}
# a class's padding side and the token type of its pad (XLNetTokenizer's
# `padding_side` and `_pad_token_type_id`)
_CLASS_PADDING = {"XLNetTokenizer": ("left", 3)}
# BigBirdTokenizerFast's special tokens and their defaults
_BIGBIRD_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                     "pad_token": "<pad>", "sep_token": "[SEP]", "mask_token": "[MASK]",
                     "cls_token": "[CLS]"}

# char::is_whitespace (Unicode White_Space), which Strip and lstrip/rstrip use
_WHITESPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                  0x205F, 0x3000]))


# -- grapheme clusters (UAX #29) -----------------------------------------------

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING,
 _L, _V, _T, _LV, _LVT) = range(14)

_PREPEND_CPS = frozenset(
    [*range(0x600, 0x606), 0x6DD, 0x70F, 0x890, 0x891, 0x8E2, 0xD4E, 0x110BD,
     0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, *range(0x11A84, 0x11A8A),
     0x11D46, 0x11F02]
)
# Grapheme_Extend outside Mn/Me: ZWNJ, halfwidth sound marks, emoji
# modifiers, tags, and the spacing marks of Other_Grapheme_Extend
_EXTEND_CPS = frozenset(
    [0x200C, 0xFF9E, 0xFF9F, *range(0x1F3FB, 0x1F400), *range(0xE0020, 0xE0080),
     0x9BE, 0x9D7, 0xB3E, 0xB57, 0xBBE, 0xBD7, 0xCC2, 0xCD5, 0xCD6, 0xD3E, 0xD57,
     0xDCF, 0xDDF, 0x1B35, 0x302E, 0x302F, 0x1133E, 0x11357, 0x114B0, 0x114BD,
     0x115AF, 0x11930, 0x1D165, *range(0x1D16E, 0x1D173)]
)
# spacing combining marks (Mc) whose break class is Other
_MC_OTHER = frozenset(
    [0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, *range(0x1067, 0x106E), 0x1083,
     *range(0x1087, 0x108D), 0x108F, 0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64,
     0xAA7B, 0xAA7D, 0x11720, 0x11721]
)
_EXT_PICT = (
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B),
    (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3),
    (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB), (0x25B6, 0x25B6),
    (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612),
    (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), (0x2714, 0x2714),
    (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728),
    (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C),
    (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757), (0x2763, 0x2767),
    (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF),
    (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
    (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297),
    (0x3299, 0x3299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F),
    (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F),
    (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D),
    (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF),
    (0x1FC00, 0x1FFFD),
)


def _ext_pict(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _EXT_PICT) if cp >= 0xA9 else False


def _default_ignorable_unassigned(cp: int) -> bool:
    return cp == 0x2065 or 0xFFF0 <= cp <= 0xFFF8 or 0xE0000 <= cp <= 0xE0FFF


def _break_class(ch: str) -> int:
    cp = ord(ch)
    if cp == 0x0D:
        return _CR
    if cp == 0x0A:
        return _LF
    if cp == 0x200D:
        return _ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return _RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return _L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return _V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return _T
    if 0xAC00 <= cp <= 0xD7A3:
        return _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    if cp in _PREPEND_CPS:
        return _PREPEND
    if cp in _EXTEND_CPS:
        return _EXTEND
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me"):
        return _EXTEND
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return _CONTROL
    if cat == "Cn" and _default_ignorable_unassigned(cp):
        return _CONTROL
    if (cat == "Mc" and cp not in _MC_OTHER) or cp in (0x0E33, 0x0EB3):
        return _SPACING
    return _OTHER


def graphemes(text: str) -> list:
    """The extended grapheme clusters of `text` (UAX #29, without the
    Indic conjunct rule, which joins only clusters of 6 bytes or more)."""
    out = []
    if not text:
        return out
    start = 0
    prev = _break_class(text[0])
    emoji = 1 if _ext_pict(ord(text[0])) else 0  # 1: ExtPict Extend*, 2: ... ZWJ
    ri_run = 1 if prev == _RI else 0
    for i in range(1, len(text)):
        ch = text[i]
        cur = _break_class(ch)
        pict = _ext_pict(ord(ch))
        if prev == _CR and cur == _LF:
            join = True
        elif prev in (_CONTROL, _CR, _LF) or cur in (_CONTROL, _CR, _LF):
            join = False
        elif prev == _L and cur in (_L, _V, _LV, _LVT):
            join = True
        elif prev in (_LV, _V) and cur in (_V, _T):
            join = True
        elif prev in (_LVT, _T) and cur == _T:
            join = True
        elif cur in (_EXTEND, _ZWJ, _SPACING) or prev == _PREPEND:
            join = True
        elif emoji == 2 and pict:
            join = True
        else:
            join = prev == _RI and cur == _RI and ri_run % 2 == 1
        if not join:
            out.append(text[start:i])
            start = i
        if pict:
            emoji = 1
        elif not (emoji == 1 and cur in (_EXTEND, _ZWJ)):
            emoji = 0
        elif cur == _ZWJ:
            emoji = 2
        ri_run = ri_run + 1 if cur == _RI else 0
        prev = cur
    out.append(text[start:])
    return out


# -- Precompiled ----------------------------------------------------------------


class Precompiled:
    """sentencepiece's precompiled character map (the `spm_precompiled`
    crate's decoding and `tokenizers.normalizers.Precompiled`'s walk)."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("the precompiled charsmap is shorter than its header")
        (trie_bytes,) = struct.unpack_from("<I", blob, 0)
        n = trie_bytes // 4
        if 4 + 4 * n > len(blob):
            raise ValueError("the precompiled charsmap's trie runs past its end")
        self.units = struct.unpack_from(f"<{n}I", blob, 4)
        self.normalized = blob[4 + 4 * n:]
        self.normalized.decode("utf-8")  # the crate refuses a blob that is not UTF-8
        self._memo: dict = {}
        self._ascii = None  # str.translate table of the ASCII keys
        self._lock = threading.Lock()

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _search(self, key: bytes) -> tuple:
        """(value of the shortest key that is a prefix of `key` or None,
        whether every byte of `key` lay on a path of the trie)."""
        units = self.units
        if not units:
            return None, False
        pos = self._offset(units[0])
        first = None
        for c in key:
            if c == 0:
                return first, False
            pos ^= c
            if pos >= len(units):
                return first, False
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return first, False
            pos ^= self._offset(unit)
            if first is None and (unit >> 8) & 1:
                first = units[pos] & ((1 << 31) - 1)
        return first, True

    def _lookup(self, chunk: str) -> tuple:
        """(the normalized string of the shortest key that prefixes
        `chunk` or None, whether `chunk` lies on a path of the trie)."""
        hit = self._memo.get(chunk)
        if hit is None:
            value, alive = self._search(chunk.encode("utf-8"))
            norm = None
            if value is not None:
                end = self.normalized.find(b"\0", value)
                norm = self.normalized[value : end if end >= 0 else None].decode("utf-8")
            hit = (norm, alive)
            with self._lock:
                if len(self._memo) >= _WORD_CACHE_MAX:
                    self._memo.clear()
                self._memo[chunk] = hit
        return hit

    def transform(self, chunk: str) -> Optional[str]:
        return self._lookup(chunk)[0]

    def __call__(self, text: str) -> str:
        if text.isascii() and "\r" not in text:
            # every ASCII character but CR is a cluster of its own
            if self._ascii is None:
                self._ascii = {i: self.transform(chr(i)) for i in range(1, 128)
                               if self.transform(chr(i)) is not None}
            return text.translate(self._ascii)
        return self.walk(text)

    def walk(self, text: str) -> str:
        """The grapheme walk itself, for any text."""
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


# -- the pipeline ---------------------------------------------------------------


def _strip(text: str, left: bool, right: bool) -> str:
    a, b = 0, len(text)
    while left and a < b and text[a] in _WHITESPACE:
        a += 1
    while right and b > a and text[b - 1] in _WHITESPACE:
        b -= 1
    return text[a:b]


_NMT_DROP = frozenset([*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F])
_NMT_SPACE = frozenset([0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028,
                        0x2029, 0x2581, 0xFEFF, 0xFFFD])
_NMT_TABLE = {**{cp: None for cp in _NMT_DROP}, **{cp: " " for cp in _NMT_SPACE}}


def _normalizer(spec: Optional[dict]):
    """A str -> str function for a tokenizer.json normalizer."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for part in parts:
                s = part(s)
            return s

        return run
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec["precompiled_charsmap"] or ""))
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        return lambda s: _strip(s, left, right)
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        if "Regex" in pattern:
            rx = re.compile(pattern["Regex"])
            return lambda s: rx.sub(lambda m: content, s)
        literal = pattern["String"]
        return lambda s: s.replace(literal, content) if literal else s
    if kind == "NFKC":
        return unicode.nfkc
    if kind == "NFKD":
        return unicode.nfkd
    if kind == "StripAccents":
        return unicode.strip_accents
    if kind == "Nmt":
        return lambda s: s.translate(_NMT_TABLE)
    if kind == "Lowercase":
        return unicode.lowercase
    raise ValueError(f"normalizer `{kind}` is not supported by the port's Unigram tokenizer")


def _pre_tokenizer(spec: Optional[dict]) -> tuple:
    """(punctuation splitter or None, replacement, prepend scheme, split) of
    a Metaspace pre-tokenizer, alone or at the end of a Sequence that may
    open with Punctuation (Isolated)."""
    if spec is None or spec.get("type") != "Sequence":
        return (None, *_metaspace(spec))
    parts = spec.get("pretokenizers") or []
    kinds = [p.get("type") for p in parts]
    if kinds not in (["Metaspace"], ["Punctuation", "Metaspace"]):
        raise ValueError(f"pre-tokenizer Sequence {kinds} is not supported: the port's Unigram"
                         " tokenizer reads a Metaspace, alone or after Punctuation")
    if len(parts) == 1:
        return (None, *_metaspace(parts[0]))
    behavior = parts[0].get("behavior", "Isolated")
    if behavior != "Isolated":
        raise ValueError(f"Punctuation behavior `{behavior}` is not supported: the port's Unigram"
                         " tokenizer isolates punctuation only")
    punct = re.compile(f"([{unicode.ranges('BERT_PUNCT').char_class()}])")
    return (punct, *_metaspace(parts[1]))


def _metaspace(spec: Optional[dict]) -> tuple:
    """(replacement, prepend scheme, split) of a Metaspace pre-tokenizer."""
    kind = None if spec is None else spec.get("type")
    if kind != "Metaspace":
        raise ValueError(f"pre-tokenizer `{kind}` is not supported: the port's Unigram"
                         " tokenizer reads Metaspace (alone or in a Sequence) only")
    scheme = spec.get("prepend_scheme", "always")
    if spec.get("add_prefix_space") is False and scheme != "never":
        # the legacy spelling: tokenizers refuses a false add_prefix_space
        # beside any scheme but never
        raise ValueError("add_prefix_space does not match declared prepend_scheme")
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"Metaspace prepend_scheme `{scheme}` is not supported")
    return spec.get("replacement", SPIECE), scheme, spec.get("split", True)


def _template(spec: Optional[dict]) -> tuple:
    """(ids before, ids after) the sequence for a single text."""
    return _typed_template(spec)[:2]


def _typed_template(spec: Optional[dict]) -> tuple:
    """(ids before, ids after, (their type ids before, the text's type id,
    after)) the sequence for a single text."""
    kind = None if spec is None else spec.get("type")
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [spec["cls"][1]], [spec["sep"][1]], ([0], 0, [0])
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        types_before, types_after, text_type = [], [], 0
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A" or seen:
                    raise ValueError("the single template must hold $A once")
                seen = True
                text_type = item["Sequence"].get("type_id", 0)
            else:
                ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
                type_id = item["SpecialToken"].get("type_id", 0)
                (types_after if seen else types_before).extend([type_id] * len(ids))
        if not seen:
            raise ValueError("the single template must hold $A once")
        return before, after, (types_before, text_type, types_after)
    raise ValueError(f"post-processor `{kind}` is not supported by the port's Unigram tokenizer")


def _tokenizer_class(config: dict, model_type: Optional[str]) -> Optional[str]:
    """The transformers tokenizer class (without `Fast`) AutoTokenizer
    builds: tokenizer_config.json's, else the model type's."""
    name = config.get("tokenizer_class") or _CLASS_OF_TYPE.get(model_type) or ""
    return name.removesuffix("Fast") or None


def _token_content(token) -> Optional[str]:
    """A tokenizer_config.json token: a string or an AddedToken dict."""
    if isinstance(token, dict):
        return token.get("content")
    return token if isinstance(token, str) else None


class AddedTokens:
    """Added tokens cut out of a text, leftmost and longest first;
    `lstrip`/`rstrip` take the whitespace (char::is_whitespace) beside
    them. `tokens`: content -> (id, lstrip, rstrip)."""

    def __init__(self, tokens: dict):
        self.tokens = tokens
        self.rx = re.compile("|".join(
            re.escape(t) for t in sorted(tokens, key=len, reverse=True)
        )) if tokens else None

    def split(self, text: str) -> list:
        """`text` as pieces (str, the first at the text's start, maybe
        empty) and the ids (int) of the tokens between them."""
        if self.rx is None:
            return [text]
        out, pos = [], 0
        for m in self.rx.finditer(text):
            tid, lstrip, rstrip = self.tokens[m.group()]
            start, stop = m.start(), m.end()
            if start < pos:
                continue  # inside the whitespace the token before took
            while lstrip and start > pos and text[start - 1] in _WHITESPACE:
                start -= 1
            while rstrip and stop < len(text) and text[stop] in _WHITESPACE:
                stop += 1
            out += [text[pos:start], tid]
            pos = stop
        out.append(text[pos:])
        return out


class Unigram:
    """Tokenize texts into input ids and attention masks from a parsed
    `tokenizer.json` whose model is Unigram (`config`: the checkpoint's
    tokenizer_config.json, for the pad token; `model_type`: config.json's,
    for the class's pad token when the file names none)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 model_type: Optional[str] = None):
        model = spec.get("model") or {}
        kind = model.get("type")
        if kind != "Unigram":
            raise ValueError(f"tokenizer model `{kind}` is not supported: the port reads"
                             " Unigram tokenizer.json files (and WordPiece vocab.txt)")
        if model.get("byte_fallback"):
            raise ValueError("Unigram with byte_fallback: true is not supported")
        vocab = model["vocab"]
        self.pieces = {}
        for i, (piece, _score) in enumerate(vocab):
            self.pieces[piece] = i  # a repeated piece keeps its last id
        self.scores = [float(score) for _piece, score in vocab]
        self.unk_id = model.get("unk_id")
        self.unk_score = min(self.scores, default=0.0) - UNK_PENALTY
        self.max_piece = max((len(p) for p, _s in vocab), default=0)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.punct, self.replacement, self.scheme, self.split = _pre_tokenizer(
            spec.get("pre_tokenizer"))
        self.before, self.after, self.types = _typed_template(spec.get("post_processor"))

        added = {}
        for tok in spec.get("added_tokens") or []:
            if tok.get("normalized"):
                raise ValueError(f"added token `{tok['content']}` is matched on normalized"
                                 " text, which the port does not support")
            if tok.get("single_word"):
                raise ValueError(f"added token `{tok['content']}` is single_word, which the"
                                 " port does not support")
            added[tok["content"]] = (tok["id"], tok.get("lstrip", False),
                                     tok.get("rstrip", False))
        if _tokenizer_class(config or {}, model_type) == "BigBirdTokenizer":
            self._class_specials(added, config or {})
        self.added = AddedTokens(added)

        pad = (_token_content((config or {}).get("pad_token"))
               or _DEFAULT_PAD.get(model_type, "<pad>"))
        self.pad = self.token_to_id(pad)
        if self.pad is None:
            raise ValueError(f"the pad token `{pad}` is not in the tokenizer")
        side, self.pad_type = _CLASS_PADDING.get(_tokenizer_class(config or {}, model_type),
                                                 ("right", 0))
        self.padding_side = (config or {}).get("padding_side", side)
        if self.padding_side not in ("right", "left"):
            raise ValueError(f"padding_side `{self.padding_side}` is not right or left")
        self._words: dict = {}
        self._lock = threading.Lock()

    def _class_specials(self, added: dict, config: dict) -> None:
        """BigBirdTokenizerFast's added tokens that `added` (the file's)
        lacks: `added_tokens_decoder`'s, then the special tokens."""
        flagged = list((config.get("added_tokens_decoder") or {}).values())
        for key, default in _BIGBIRD_SPECIALS.items():
            value = config.get(key, default)
            if isinstance(value, str):
                value = {"content": value, "lstrip": key == "mask_token"}
            if isinstance(value, dict):
                flagged.append(value)
        for tok in flagged:
            content = tok["content"]
            if content in added:
                continue
            if content not in self.pieces:
                raise ValueError(f"the special token `{content}` (BigBirdTokenizer's) is not in"
                                 " the vocabulary")
            added[content] = (self.pieces[content], tok.get("lstrip", False),
                              tok.get("rstrip", False))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added.tokens:
            return self.added.tokens[token][0]
        return self.pieces.get(token)

    # -- one word ------------------------------------------------------------

    def _viterbi(self, word: str) -> list:
        """tokenizers' Unigram::encode_optimized, over characters."""
        n = len(word)
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)  # -1: no path ends here yet
        ids = [0] * (n + 1)
        pieces, scores = self.pieces, self.scores
        for s in range(n):
            here = score[s]
            single = False
            for e in range(s + 1, min(n, s + self.max_piece) + 1):
                tid = pieces.get(word[s:e])
                if tid is None:
                    continue
                cand = scores[tid] + here
                if start[e] < 0 or cand > score[e]:
                    score[e], start[e], ids[e] = cand, s, tid
                if e == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"`{word[s]}` has no piece and the model has no unk_id")
                cand = self.unk_score + here
                if start[s + 1] < 0 or cand > score[s + 1]:
                    score[s + 1], start[s + 1], ids[s + 1] = cand, s, self.unk_id
        out, e, unk_end = [], n, None
        while e > 0:
            s = start[e]
            if ids[e] == self.unk_id:
                unk_end = e if unk_end is None else unk_end
            else:
                if unk_end is not None:
                    out.append(self._unk_piece(word[e:unk_end]))
                    unk_end = None
                out.append(ids[e])
            e = s
        if unk_end is not None:
            out.append(self._unk_piece(word[:unk_end]))
        out.reverse()
        return out

    def _unk_piece(self, text: str) -> int:
        """The id of a fused run of unknown characters (tokenizers looks
        the run up as a piece first)."""
        tid = self.pieces.get(text)
        return self.unk_id if tid is None else tid

    def _word_ids(self, word: str) -> list:
        ids = self._words.get(word)
        if ids is None:
            ids = self._viterbi(word)
            with self._lock:
                if len(self._words) >= _WORD_CACHE_MAX:
                    self._words.clear()
                self._words[word] = ids
        return ids

    # -- one text ------------------------------------------------------------

    def _segment_ids(self, segment: str, at_start: bool) -> list:
        text = self.normalize(segment)
        if not text:
            return []
        if self.punct is None:
            return self._piece_ids(text, at_start)
        out = []
        for j, piece in enumerate(p for p in self.punct.split(text) if p):
            out += self._piece_ids(piece, at_start and j == 0)
        return out

    def _piece_ids(self, text: str, at_start: bool) -> list:
        """Metaspace and the model on one pre-tokenized piece."""
        text = text.replace(" ", self.replacement)
        if not text.startswith(self.replacement) and (
            self.scheme == "always" or (self.scheme == "first" and at_start)
        ):
            text = self.replacement + text
        if not self.split:
            return list(self._word_ids(text))
        out = []
        cut = [i for i, ch in enumerate(text) if ch == self.replacement and i > 0]
        for a, b in zip([0, *cut], [*cut, len(text)]):
            out += self._word_ids(text[a:b])
        return out

    def ids(self, text: str) -> list:
        """The ids of one text, without the template's special tokens."""
        out = []
        for i, part in enumerate(self.added.split(text)):
            if isinstance(part, int):
                out.append(part)
            else:
                out += self._segment_ids(part, i == 0)
        return out

    # -- a batch -------------------------------------------------------------

    def __call__(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask), (len(texts), longest) int64 CPU
        tensors: the template around each text's ids, truncated to
        max_len, padded with the pad token on the padding side."""
        return self.encode_types(texts, max_len)[:2]

    def encode_types(self, texts: list, max_len: int = 512):
        """(input_ids, attention_mask, token_type_ids): the template's type
        ids around the text's, the pad's (`pad_type`) in the padding."""
        room = max(max_len - len(self.before) - len(self.after), 0)
        rows = [[*self.before, *self.ids(t)[:room], *self.after] for t in texts]
        width = max((len(r) for r in rows), default=0)
        ids = torch.full((len(rows), width), self.pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        types = torch.full((len(rows), width), self.pad_type, dtype=torch.int64)
        before, text_type, after = self.types
        for i, r in enumerate(rows):
            at = width - len(r) if self.padding_side == "left" else 0
            ids[i, at:at + len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, at:at + len(r)] = 1
            n = len(r) - len(before) - len(after)
            types[i, at:at + len(r)] = torch.tensor([*before, *[text_type] * n, *after],
                                                    dtype=torch.int64)
        return ids, mask, types
