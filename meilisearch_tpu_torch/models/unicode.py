"""The `tokenizers` library's Unicode answers, read from frozen tables.

transformers' fast tokenizers (what the JAX package's `AutoTokenizer`
runs) decide character classes and normalization forms with the Unicode
tables built into `tokenizers`' Rust crates, not with Python's
`unicodedata`: their categories and normalization data are older than
Python 3.12's Unicode 15.0 and their case mappings newer. So the port's
tokenizers read `_unicode_tables.py`, generated by
`tools/unicode_tables.py` from `tokenizers`' own answers on every code
point, and nothing here asks the host's Python:

- `BertNormalizer` and `BertPreTokenizer`'s classes (control, whitespace,
  CJK, punctuation, split whitespace) and the non-spacing marks that
  `strip_accents` drops after NFD (`strip_marks`); the combining marks
  the `StripAccents` normalizer drops (`strip_accents`, every mark,
  spacing and enclosing ones too);
- `nfd`, `nfkd`, `nfc` and `nfkc` (Unicode's normalization algorithm: full
  decomposition, canonical reordering by combining class, canonical
  composition of primary composites, Hangul by arithmetic) over the
  crate's decompositions, combining classes and composites;
- `lowercase`, character by character, some characters to several;
- the ByteLevel pre-tokenizer regular expression's `\\p{L}`, `\\p{N}` and
  `\\s`, as character classes for Python's `re`.

Tables are parsed once, on first use.
"""

from __future__ import annotations

import re
from bisect import bisect_right
from functools import lru_cache

from . import _unicode_tables as _t

# Hangul syllables: S = 0xAC00 + (L * 21 + V) * 28 + T
_S0, _L0, _V0, _T0 = 0xAC00, 0x1100, 0x1161, 0x11A7
_NV, _NT = 21, 28
_NS = 19 * _NV * _NT


class Ranges:
    """A set of code points given as "lo-hi" hexadecimal ranges."""

    def __init__(self, spec: str):
        pairs = [tok.split("-") for tok in spec.split()]
        self.lo = [int(a, 16) for a, _ in pairs]
        self.hi = [int(b, 16) for _, b in pairs]

    def __contains__(self, cp: int) -> bool:
        i = bisect_right(self.lo, cp) - 1
        return i >= 0 and cp <= self.hi[i]

    def char_class(self) -> str:
        """The body of a regular-expression character class of the set."""
        out = []
        for a, b in zip(self.lo, self.hi):
            out.append(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}")
        return "".join(out)


def _map(spec: str) -> dict:
    """"cp=seq" tokens as {char: string}."""
    out = {}
    for tok in spec.split():
        cp, seq = tok.split("=")
        out[chr(int(cp, 16))] = "".join(chr(int(c, 16)) for c in seq.split("."))
    return out


@lru_cache(maxsize=None)
def ranges(name: str) -> Ranges:
    """A range table of _unicode_tables by name (BERT_CONTROL, BERT_PUNCT, ...)."""
    return Ranges(getattr(_t, name))


class _Tables:
    """The normalization tables, as translate tables and dicts."""

    def __init__(self):
        canonical = _map(_t.CANONICAL)
        compat = {**canonical, **_map(_t.COMPATIBILITY)}
        hangul = {}
        for s in range(_NS):
            t = s % _NT
            lv = chr(_L0 + s // (_NV * _NT)) + chr(_V0 + (s % (_NV * _NT)) // _NT)
            hangul[_S0 + s] = lv + (chr(_T0 + t) if t else "")
        self.nfd = {ord(c): d for c, d in canonical.items()} | hangul
        self.nfkd = {ord(c): d for c, d in compat.items()} | hangul
        self.lower = {ord(c): low for c, low in _map(_t.LOWERCASE).items()}
        marks = ranges("NONSPACING_MARK")
        self.marks = {cp: None for a, b in zip(marks.lo, marks.hi) for cp in range(a, b + 1)}
        combining = ranges("COMBINING_MARK")
        self.combining = {cp: None for a, b in zip(combining.lo, combining.hi)
                          for cp in range(a, b + 1)}
        self.ccc = {}
        for tok in _t.COMBINING.split():
            ccc, span = tok.split(":")
            lo, hi = (int(x, 16) for x in span.split("-"))
            self.ccc.update((chr(cp), int(ccc)) for cp in range(lo, hi + 1))
        self.compose = {}
        for tok in _t.COMPOSITION.split():
            pair, comp = tok.split("=")
            a, b = (chr(int(x, 16)) for x in pair.split("."))
            self.compose[a + b] = chr(int(comp, 16))
        for li in range(19):
            for vi in range(_NV):
                lv = _S0 + (li * _NV + vi) * _NT
                self.compose[chr(_L0 + li) + chr(_V0 + vi)] = chr(lv)
                for ti in range(1, _NT):
                    self.compose[chr(lv) + chr(_T0 + ti)] = chr(lv + ti)
        # characters that can join the character before them
        self.seconds = frozenset(pair[1] for pair in self.compose)


@lru_cache(maxsize=None)
def tables() -> _Tables:
    return _Tables()


def _reorder(text: str, ccc: dict) -> str:
    """Canonical ordering: each run of characters of non-zero combining
    class stably sorted by class."""
    if ccc.keys().isdisjoint(text):
        return text
    chars = list(text)
    i, n = 0, len(chars)
    while i < n:
        if chars[i] not in ccc:
            i += 1
            continue
        j = i + 1
        while j < n and chars[j] in ccc:
            j += 1
        if j - i > 1:
            chars[i:j] = sorted(chars[i:j], key=ccc.__getitem__)
        i = j
    return "".join(chars)


def _compose(text: str, t: _Tables) -> str:
    """Canonical composition of a canonically ordered string."""
    if t.seconds.isdisjoint(text):
        return text
    out = []
    starter = -1  # index in `out` of the last starter
    last = None  # class of the last character kept after it (None: none)
    for ch in text:
        cc = t.ccc.get(ch, 0)
        if starter >= 0 and (last is None or 0 < last < cc):
            comp = t.compose.get(out[starter] + ch)
            if comp is not None:
                out[starter] = comp
                continue
        if cc == 0:
            starter, last = len(out), None
        else:
            last = cc
        out.append(ch)
    return "".join(out)


def nfd(text: str) -> str:
    if text.isascii():
        return text
    t = tables()
    return _reorder(text.translate(t.nfd), t.ccc)


def nfc(text: str) -> str:
    if text.isascii():
        return text
    t = tables()
    return _compose(_reorder(text.translate(t.nfd), t.ccc), t)


def nfkd(text: str) -> str:
    if text.isascii():
        return text
    t = tables()
    return _reorder(text.translate(t.nfkd), t.ccc)


def nfkc(text: str) -> str:
    if text.isascii():
        return text
    t = tables()
    return _compose(_reorder(text.translate(t.nfkd), t.ccc), t)


def strip_marks(text: str) -> str:
    """`text` without the non-spacing marks `strip_accents` drops (after NFD)."""
    return text.translate(tables().marks)


def strip_accents(text: str) -> str:
    """`tokenizers`' StripAccents: `text` without its combining marks."""
    if text.isascii():
        return text
    return text.translate(tables().combining)


def lowercase(text: str) -> str:
    """`tokenizers`' Lowercase: each character's lowercase mapping (no
    final-sigma rule)."""
    return text.translate(tables().lower)
