#!/usr/bin/env python3
"""Write the port's frozen Unicode tables from the `tokenizers` library's
own answers on every code point.

    python3 tools/unicode_tables.py [--out meilisearch_tpu_torch/models/_unicode_tables.py]

The JAX package tokenizes through transformers' `AutoTokenizer`, that is
through `tokenizers`, whose Rust crates carry Unicode tables of their own
(older categories and normalization data, newer case mappings) that differ
from Python's `unicodedata`. The port's tokenizers (models/wordpiece.py,
models/unigram.py, models/bpe.py) read these tables instead, so their
answers do not depend on the host's Python. Every table below is probed
here, one code point at a time from U+0000 to U+10FFFF (surrogates have no
place in a Rust string), through the public pipeline pieces:

- `BertNormalizer(clean_text)`: the code points it drops (control) and
  those it maps to a space (whitespace); `handle_chinese_chars`: those it
  pads with spaces (CJK);
- `BertPreTokenizer` on "a{c}b": the code points it cuts out alone
  (punctuation) and those it splits on (whitespace);
- `NFD` and `NFKD` of each code point alone: the full decompositions
  (Hangul syllables are left to the algorithm);
- canonical combining classes: Python's value for every mark the crate
  reorders (probed against U+0334, class 1, and U+0301, class 230); a
  mark the crate does not reorder has class 0 there;
- primary composites: Python's two-code-point canonical decompositions of
  the code points that `NFC` keeps whole and `NFD` splits;
- `BertNormalizer(strip_accents)` of each code point that `NFD` keeps:
  the non-spacing marks it drops;
- `StripAccents` of each code point: the combining marks it drops (every
  mark, spacing and enclosing ones too, whatever `NFD` does with them);
- `Lowercase`: each code point's lowercase string where it differs;
- the ByteLevel pre-tokenizer's regular expression engine: `\\p{L}`,
  `\\p{N}` and `\\s`, matched by `Split(Regex(...))` over every code point.

It needs `tokenizers` (and the Python it runs under only for the classes
and pairs named above, which Unicode never changes once assigned); the
tests in tests/test_torch_unicode_tables.py hold every table against
`tokenizers` on every code point again. The generated module is data
only; models/unicode.py reads it.
"""

from __future__ import annotations

import argparse
import sys
import unicodedata
from pathlib import Path

import tokenizers
from tokenizers import Regex, normalizers, pre_tokenizers

OUT = (Path(__file__).resolve().parent.parent / "meilisearch_tpu_torch" / "models"
       / "_unicode_tables.py")
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
HANGUL = range(0xAC00, 0xD7A4)
WIDTH = 96  # characters of a generated line


def ranges(cps) -> str:
    """Sorted code points as "lo-hi" hex ranges, inclusive."""
    out, cps = [], sorted(cps)
    i = 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(f"{cps[i]:04X}-{cps[j]:04X}")
        i = j + 1
    return " ".join(out)


def seq(text: str) -> str:
    return ".".join(f"{ord(c):04X}" for c in text)


def bert_tables() -> dict:
    clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                       strip_accents=False, lowercase=False)
    chinese = normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=True,
                                         strip_accents=False, lowercase=False)
    strip = normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=False,
                                       strip_accents=True, lowercase=False)
    nfd = normalizers.NFD()
    strip_accents = normalizers.StripAccents()
    split = pre_tokenizers.BertPreTokenizer()
    control, space, cjk, punct, split_space, marks, combining = [], [], [], [], [], [], []
    for cp in CODE_POINTS:
        ch = chr(cp)
        out = clean.normalize_str(ch)
        if out == "":
            control.append(cp)
        elif out == " ":
            space.append(cp)
        elif out != ch:
            raise AssertionError(f"clean_text maps U+{cp:04X} to {out!r}")
        if chinese.normalize_str(ch) == f" {ch} ":
            cjk.append(cp)
        words = [w for w, _ in split.pre_tokenize_str(f"a{ch}b")]
        if words == ["a", ch, "b"]:
            punct.append(cp)
        elif words == ["a", "b"]:
            split_space.append(cp)
        if nfd.normalize_str(ch) == ch and strip.normalize_str(ch) == "":
            marks.append(cp)
        out = strip_accents.normalize_str(ch)
        if out == "":
            combining.append(cp)
        elif out != ch:
            raise AssertionError(f"StripAccents maps U+{cp:04X} to {out!r}")
    return {"BERT_CONTROL": control, "BERT_WHITESPACE": space, "BERT_CJK": cjk,
            "BERT_PUNCT": punct, "BERT_SPLIT_SPACE": split_space, "NONSPACING_MARK": marks,
            "COMBINING_MARK": combining}


def normalization_tables() -> dict:
    nfd, nfkd, nfc = normalizers.NFD(), normalizers.NFKD(), normalizers.NFC()
    lower = normalizers.Lowercase()
    canonical, compat, lowercase, combining, composition = {}, {}, {}, {}, {}
    for cp in CODE_POINTS:
        ch = chr(cp)
        low = lower.normalize_str(ch)
        if low != ch:
            lowercase[cp] = low
        if cp in HANGUL:
            continue
        d, k = nfd.normalize_str(ch), nfkd.normalize_str(ch)
        if d != ch:
            canonical[cp] = d
        if k != d:
            compat[cp] = k
        ccc = unicodedata.combining(ch)
        if ccc:
            # a mark of class > 1 moves after U+0334 (class 1); one of class
            # 1 moves before U+0301 (class 230), if the crate knows its class
            probe = f"a{ch}\u0334" if ccc > 1 else f"a\u0301{ch}"
            plain = nfd.normalize_str(probe)
            kept = f"a{d}\u0334" if ccc > 1 else f"a\u0301{d}"
            if plain != kept:
                combining[cp] = ccc
        parts = unicodedata.decomposition(ch).split()
        canonical_pair = len(parts) == 2 and not parts[0].startswith("<")
        if canonical_pair and d != ch and nfc.normalize_str(ch) == ch:
            composition[(int(parts[0], 16), int(parts[1], 16))] = cp
    return {"CANONICAL": canonical, "COMPATIBILITY": compat, "LOWERCASE": lowercase,
            "COMBINING": combining, "COMPOSITION": composition}


def byte_level_tables() -> dict:
    text = "".join(map(chr, CODE_POINTS))
    out = {}
    for name, pattern in (("BYTE_LEVEL_LETTER", r"\p{L}"), ("BYTE_LEVEL_NUMBER", r"\p{N}"),
                          ("BYTE_LEVEL_SPACE", r"\s")):
        kept = pre_tokenizers.Split(Regex(pattern), behavior="removed").pre_tokenize_str(text)
        hit = [True] * len(text)
        for _piece, (a, b) in kept:
            hit[a:b] = [False] * (b - a)
        out[name] = [cp for cp, h in zip(CODE_POINTS, hit) if h]
    return out


def wrap(name: str, tokens: list) -> str:
    """`name = ("..." "...")`, the tokens space-separated over lines."""
    lines, line = [], ""
    for tok in tokens:
        if line and len(line) + len(tok) + 1 > WIDTH:
            lines.append(line + " ")
            line = tok
        else:
            line = f"{line} {tok}" if line else tok
    lines.append(line)
    body = "\n".join(f'    "{ln}"' for ln in lines)
    return f"{name} = (\n{body}\n)\n"


def render(tables: dict) -> str:
    head = f'''"""Unicode tables of `tokenizers` {tokenizers.__version__}, frozen for the port.

Generated by `python3 tools/unicode_tables.py`; do not edit. Each table is
the `tokenizers` library's own answer on every code point (see the
generator's docstring for how each was probed); models/unicode.py parses
them. Range tables are "lo-hi" hexadecimal code points, inclusive; map
tables are "cp=seq" with `seq` hexadecimal code points joined by dots;
COMBINING is "class:ranges"; COMPOSITION is "first.second=composite".
"""

SOURCE = "tokenizers {tokenizers.__version__}"
# the host's Unicode version when the tables were checked: the grapheme
# walk of models/unigram.py still asks `unicodedata`, and a test fails
# when the host's version is another
CHECKED_UNIDATA = "{unicodedata.unidata_version}"

'''
    parts = [head]
    for name in ("BERT_CONTROL", "BERT_WHITESPACE", "BERT_CJK", "BERT_PUNCT", "BERT_SPLIT_SPACE",
                 "NONSPACING_MARK", "COMBINING_MARK", "BYTE_LEVEL_LETTER", "BYTE_LEVEL_NUMBER",
                 "BYTE_LEVEL_SPACE"):
        parts.append(wrap(name, ranges(tables[name]).split()))
    for name in ("CANONICAL", "COMPATIBILITY", "LOWERCASE"):
        parts.append(wrap(name, [f"{cp:04X}={seq(v)}" for cp, v in sorted(tables[name].items())]))
    by_class: dict = {}
    for cp, ccc in tables["COMBINING"].items():
        by_class.setdefault(ccc, []).append(cp)
    parts.append(wrap("COMBINING", [f"{ccc}:{r}" for ccc in sorted(by_class)
                                    for r in ranges(by_class[ccc]).split()]))
    parts.append(wrap("COMPOSITION", [f"{a:04X}.{b:04X}={c:04X}"
                                      for (a, b), c in sorted(tables["COMPOSITION"].items())]))
    return "\n".join(parts)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT)
    opts = parser.parse_args()
    tables = {**bert_tables(), **normalization_tables(), **byte_level_tables()}
    opts.out.write_text(render(tables), encoding="utf-8")
    sizes = ", ".join(f"{k} {len(v)}" for k, v in tables.items())
    print(f"wrote {opts.out} from tokenizers {tokenizers.__version__}: {sizes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
