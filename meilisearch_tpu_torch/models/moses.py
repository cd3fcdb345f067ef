"""Moses punctuation normalization and tokenization, as transformers'
`XLMTokenizer` and `FlaubertTokenizer` run them through sacremoses 0.1.1.

Both classes pass every text through `moses_pipeline`, then
`MosesTokenizer(lang).tokenize(text, return_str=False, escape=False)`.
This module is the port's copy of those steps, for `lang` "en" (XLM's
default: the reference's encoder never passes a language) and "fr"
(FlauBERT's, fixed); any other language is refused by name:

1. `replace_unicode_punct`: the full-width and CJK punctuation and digits
   of Moses' replace-unicode-punctuation.perl, as transformers copies it
   (`tokenization_xlm.py:66`; its order, not sacremoses');
2. `MosesPunctNormalizer(lang).normalize` with its default flags: `penn`,
   `norm_quote_commas`, `norm_numbers`, no `perl_parity`; the
   substitution lists in sacremoses' order, then `strip()`;
3. `remove_non_printing_char`: every character of a `C*` category
   dropped, `\\n` and `\\t` among them, so "hello\\nworld" is one word;
4. `MosesTokenizer(lang).tokenize`: runs of whitespace to one space,
   ASCII controls dropped, every character outside `IsAlnum` and
   `\\s.'`,-` padded with spaces, multi-dots protected, commas split
   outside numbers, the language's apostrophe rules (English's five, the
   French elision `l' homme`), the nonbreaking-prefix pass on each token
   ending in a period, then the trailing `.'`, split on whitespace.

The character classes (`IsN`, `IsAlnum`, `IsSc`, `IsSo`, `IsAlpha`,
`IsLower`: Perl's Unicode properties, not Python's) and the prefix lists
come from the frozen `_moses_tables.py`. Everything else is what
sacremoses itself runs: Python's `re` (whose `\\s` and `\\d` are Python's
Unicode classes), `str.split`, `str.strip` and `unicodedata.category`.
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache

from . import _moses_tables as _t
from .unicode import Ranges

LANGS = ("en", "fr")


def check_lang(lang: str) -> None:
    if lang not in LANGS:
        raise ValueError(f"Moses for lang `{lang}` is not in the port: it runs"
                         f" {' and '.join(LANGS)} only")


@lru_cache(maxsize=None)
def _ranges(name: str) -> Ranges:
    return Ranges(getattr(_t, name))


def _class(name: str) -> str:
    """The body of a regular-expression character class of a frozen class."""
    return _ranges(name).char_class()


# -- 1. replace-unicode-punctuation --------------------------------------------------

_UNICODE_PUNCT = (
    ("，", ","), (re.compile(r"。\s*"), ". "), ("、", ","), ("”", '"'), ("“", '"'),
    ("∶", ":"), ("：", ":"), ("？", "?"), ("《", '"'), ("》", '"'), ("）", ")"), ("！", "!"),
    ("（", "("), ("；", ";"), ("１", "1"), ("」", '"'), ("「", '"'), ("０", "0"), ("３", "3"),
    ("２", "2"), ("５", "5"), ("６", "6"), ("９", "9"), ("７", "7"), ("８", "8"), ("４", "4"),
    (re.compile(r"．\s*"), ". "), ("～", "~"), ("’", "'"), ("…", "..."), ("━", "-"),
    ("〈", "<"), ("〉", ">"), ("【", "["), ("】", "]"), ("％", "%"),
)


def replace_unicode_punct(text: str) -> str:
    for old, new in _UNICODE_PUNCT:
        text = old.sub(new, text) if isinstance(old, re.Pattern) else text.replace(old, new)
    return text


# -- 2. the punctuation normalizer ----------------------------------------------------

_EXTRA_WHITESPACE = [
    (r"\r", r""), (r"\(", r" ("), (r"\)", r") "), (r" +", r" "), (r"\) ([.!:?;,])", r")\g<1>"),
    (r"\( ", r"("), (r" \)", r")"), (r"(\d) %", r"\g<1>%"), (r" :", r":"), (r" ;", r";"),
]
_NORMALIZE_UNICODE_IF_NOT_PENN = [(r"`", r"'"), (r"''", r' " ')]
_NORMALIZE_UNICODE = [
    ("„", r'"'), ("“", r'"'), ("”", r'"'), ("–", r"-"), ("—", r" - "), (r" +", r" "),
    ("´", r"'"), ("([a-zA-Z])‘([a-zA-Z])", r"\g<1>'\g<2>"),
    ("([a-zA-Z])’([a-zA-Z])", r"\g<1>'\g<2>"), ("‘", r"'"), ("‚", r"'"), ("’", r"'"),
    (r"''", r'"'), ("´´", r'"'), ("…", r"..."),
]
_FRENCH_QUOTES = [
    ("\u00A0«\u00A0", r'"'), ("«\u00A0", r'"'), ("«", r'"'), ("\u00A0»\u00A0", r'"'),
    ("\u00A0»", r'"'), ("»", r'"'),
]
_HANDLE_PSEUDO_SPACES = [
    ("\u00A0%", r"%"), ("nº\u00A0", "nº "), ("\u00A0:", r":"), ("\u00A0ºC", " ºC"),
    ("\u00A0cm", r" cm"), ("\u00A0\\?", "?"), ("\u00A0\\!", "!"), ("\u00A0;", r";"),
    (",\u00A0", r", "), (r" +", r" "),
]
_EN_QUOTATION_FOLLOWED_BY_COMMA = [(r'"([,.]+)', r'\g<1>"')]
_FR_QUOTATION_FOLLOWED_BY_COMMA = [(r',"', r'",'), (r'(\.+)"(\s*[^<])', r'"\g<1>\g<2>')]
_FR_NUMBERS = [("(\\d)\u00A0(\\d)", r"\g<1>,\g<2>")]
_OTHER_NUMBERS = [("(\\d)\u00A0(\\d)", r"\g<1>.\g<2>")]


class MosesPunctNormalizer:
    """sacremoses' `MosesPunctNormalizer(lang)` with its default flags
    (`penn`, `norm_quote_commas`, `norm_numbers`; no `perl_parity`, no
    pre- or post-steps)."""

    def __init__(self, lang: str = "en"):
        check_lang(lang)
        subs = [*_EXTRA_WHITESPACE, *_NORMALIZE_UNICODE_IF_NOT_PENN, *_NORMALIZE_UNICODE,
                *_FRENCH_QUOTES, *_HANDLE_PSEUDO_SPACES]
        if lang == "en":
            subs += [*_EN_QUOTATION_FOLLOWED_BY_COMMA, *_OTHER_NUMBERS]
        else:
            subs += [*_FR_QUOTATION_FOLLOWED_BY_COMMA, *_FR_NUMBERS]
        self.subs = [(re.compile(p), r) for p, r in subs]

    def normalize(self, text: str) -> str:
        for rx, repl in self.subs:
            text = rx.sub(repl, text)
        return text.strip()


# -- 3. remove-non-printing-char ------------------------------------------------------


class _NonPrinting(dict):
    """`str.translate` table dropping every character whose category
    starts with C, filled on first sight of each character."""

    def __missing__(self, cp: int):
        out = None if unicodedata.category(chr(cp)).startswith("C") else cp
        self[cp] = out
        return out


_NON_PRINTING = _NonPrinting()


def remove_non_printing_char(text: str) -> str:
    return text.translate(_NON_PRINTING)


# -- 4. the tokenizer -----------------------------------------------------------------


_PERIOD_END = re.compile(r"^(\S+)\.$")
_DIGITS = re.compile(r"^[0-9]+")


class MosesTokenizer:
    """sacremoses' `MosesTokenizer(lang).tokenize(text, return_str=False,
    escape=False)`, no aggressive dash splits, no protected patterns."""

    def __init__(self, lang: str = "en"):
        check_lang(lang)
        prefixes = getattr(_t, f"NONBREAKING_PREFIXES_{lang.upper()}")
        self.numeric_only = [w.rpartition(" ")[0] for w in prefixes
                             if re.search(r"[\s]+(\#NUMERIC_ONLY\#)", w)]
        self.prefix_set = set(prefixes) - set(self.numeric_only)
        self.alpha, self.lower = _ranges("ISALPHA"), _ranges("ISLOWER")
        alnum, num, alpha = _class("ISALNUM"), _class("ISN"), _class("ISALPHA")
        self.pad_not_alnum = re.compile(r"([^{}\s\.'\`\,\-])".format(alnum))
        self.commas = [(re.compile(r"([^{}])[,]".format(num)), r"\1 , "),
                       (re.compile(r"[,]([^{}])".format(num)), r" , \1"),
                       (re.compile(r"([{}])[,]$".format(num)), r"\1 , ")]
        if lang == "en":
            self.apostrophes = [
                (re.compile(r"([^{a}])[']([^{a}])".format(a=alpha)), r"\1 ' \2"),
                (re.compile(r"([^{a}{n}])[']([{a}])".format(a=alpha, n=num)), r"\1 ' \2"),
                (re.compile(r"([{a}])[']([^{a}])".format(a=alpha)), r"\1 ' \2"),
                (re.compile(r"([{a}])[']([{a}])".format(a=alpha)), r"\1 '\2"),
                (re.compile(r"([{n}])[']([s])".format(n=num)), r"\1 '\2"),
            ]
        else:
            self.apostrophes = [
                (re.compile(r"([^{a}])[']([^{a}])".format(a=alpha)), r"\1 ' \2"),
                (re.compile(r"([^{a}])[']([{a}])".format(a=alpha)), r"\1 ' \2"),
                (re.compile(r"([{a}])[']([^{a}])".format(a=alpha)), r"\1 ' \2"),
                (re.compile(r"([{a}])[']([{a}])".format(a=alpha)), r"\1' \2"),
            ]

    def _islower(self, ch: str) -> bool:
        return ord(ch) in self.lower

    def _isanyalpha(self, text: str) -> bool:
        return any(ord(c) in self.alpha for c in text)

    def _nonbreaking_prefixes(self, text: str) -> str:
        tokens = text.split()
        n = len(tokens)
        for i, token in enumerate(tokens):
            m = _PERIOD_END.search(token) if token.endswith(".") else None
            if not m:
                continue
            prefix = m.group(1)
            if (("." in prefix and self._isanyalpha(prefix))
                    or prefix in self.prefix_set
                    or (i != n - 1 and tokens[i + 1] and self._islower(tokens[i + 1][0]))):
                continue  # the period stays on the token
            if prefix in self.numeric_only and i + 1 < n and _DIGITS.search(tokens[i + 1]):
                continue
            tokens[i] = prefix + " ."
        return " ".join(tokens)

    def tokenize(self, text: str) -> list:
        text = re.sub(r"\s+", r" ", text)
        text = re.sub(r"[\000-\037]", r"", text)
        text = text.strip()
        text = self.pad_not_alnum.sub(r" \1 ", text)
        text = _replace_multidots(text)
        for rx, repl in self.commas:
            text = rx.sub(repl, text)
        for rx, repl in self.apostrophes:
            text = rx.sub(repl, text)
        text = self._nonbreaking_prefixes(text)
        text = re.sub(r"\s+", r" ", text).strip()
        text = re.sub(r"\.' ?$", r" . ' ", text)
        return _restore_multidots(text).split()


def _replace_multidots(text: str) -> str:
    text = re.sub(r"\.([\.]+)", r" DOTMULTI\1", text)
    dotmulti = re.compile(r"DOTMULTI\.")
    while dotmulti.search(text):
        text = re.sub(r"DOTMULTI\.([^\.])", r"DOTDOTMULTI \1", text)
        text = dotmulti.sub("DOTDOTMULTI", text)
    return text


def _restore_multidots(text: str) -> str:
    dotmulti = re.compile(r"DOTDOTMULTI")
    while dotmulti.search(text):
        text = dotmulti.sub(r"DOTMULTI.", text)
    return re.sub(r"DOTMULTI", r".", text)


@lru_cache(maxsize=None)
def _steps(lang: str) -> tuple:
    return MosesPunctNormalizer(lang), MosesTokenizer(lang)


def moses_tokenize(text: str, lang: str) -> list:
    """XLMTokenizer's `moses_pipeline` then `moses_tokenize`: the text's
    Moses tokens."""
    normalizer, tokenizer = _steps(lang)
    text = remove_non_printing_char(normalizer.normalize(replace_unicode_punct(text)))
    return tokenizer.tokenize(text)
