#!/usr/bin/env python3
"""Write the port's frozen Moses tables from the `sacremoses` package.

    python3 tools/moses_tables.py [--out meilisearch_tpu_torch/models/_moses_tables.py]

transformers' `XLMTokenizer` and `FlaubertTokenizer` (what the JAX
package's `AutoTokenizer` gives an `xlm` or `flaubert` checkpoint) run
`sacremoses`' `MosesTokenizer`, whose regular expressions are built from
Perl's Unicode property lists shipped with the package
(`data/perluniprops/*.txt`), not from Python's `unicodedata`, and whose
sentence-period rule reads its nonbreaking-prefix lists
(`data/nonbreaking_prefixes/nonbreaking_prefix.*`). The port's Moses
(models/moses.py) reads this module instead, so it needs no sacremoses:

- the six character classes `MosesTokenizer` builds its expressions from,
  exactly as its class attributes hold them: `IsN`, `IsSc`, `IsSo` and
  `IsLower` as read, `IsAlnum` and `IsAlpha` with `sacremoses.indic`'s
  VIRAMAS and NUKTAS appended (a file's trailing newline is one of the
  characters where the file ends with one: U+000A is in `IsN`, `IsSc` and
  `IsSo`);
- the English and French nonbreaking prefixes, each line as
  `NonbreakingPrefixes.words(lang)` yields it (stripped, comments left
  out), `#NUMERIC_ONLY#` marks included.

Needs `sacremoses` (only the CPU environment has it);
tests/test_torch_moses.py holds every class on every code point and each
prefix list against the installed package again.
"""

from __future__ import annotations

import argparse
import sys
from importlib.metadata import version
from pathlib import Path

from sacremoses.corpus import NonbreakingPrefixes
from sacremoses.tokenize import MosesTokenizer

OUT = Path(__file__).resolve().parent.parent / "meilisearch_tpu_torch" / "models" / "_moses_tables.py"
CLASSES = ("IsN", "IsAlnum", "IsSc", "IsSo", "IsAlpha", "IsLower")
LANGS = ("en", "fr")
WIDTH = 96  # characters of a generated line


def ranges(cps) -> str:
    """Sorted code points as "lo-hi" hex ranges, inclusive."""
    out, cps = [], sorted(set(cps))
    i = 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(f"{cps[i]:04X}-{cps[j]:04X}")
        i = j + 1
    return " ".join(out)


def _wrapped(name: str, spec: str) -> str:
    lines, line = [], ""
    for tok in spec.split():
        if line and len(line) + len(tok) + 1 > WIDTH - 8:
            lines.append(line + " ")
            line = ""
        line += (" " if line else "") + tok
    lines.append(line)
    body = "\n".join(f'    "{ln}"' for ln in lines)
    return f"{name} = (\n{body}\n)\n"


def render() -> str:
    parts = [
        f'"""Moses tables of sacremoses {version("sacremoses")}, frozen for the port.\n\n'
        "Generated by `python3 tools/moses_tables.py`; do not edit. The character\n"
        "classes are `sacremoses.tokenize.MosesTokenizer`'s (Perl's Unicode\n"
        "property lists, `IsAlnum` and `IsAlpha` with the Indic viramas and\n"
        'nuktas), as "lo-hi" hexadecimal code point ranges, inclusive; the\n'
        "prefixes are `NonbreakingPrefixes.words(lang)`'s lines. models/moses.py\n"
        'reads them.\n"""\n',
        f'SOURCE = "sacremoses {version("sacremoses")}"\n',
    ]
    for name in CLASSES:
        parts.append(_wrapped(name.upper(), ranges(map(ord, getattr(MosesTokenizer, name)))))
    words = NonbreakingPrefixes()
    for lang in LANGS:
        items = "".join(f"    {w!r},\n" for w in words.words(lang))
        parts.append(f"NONBREAKING_PREFIXES_{lang.upper()} = (\n{items})\n")
    return "\n\n".join(parts)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT)
    opts = parser.parse_args()
    opts.out.write_text(render(), encoding="utf-8")
    print(f"wrote {opts.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
