"""Writers of the files the port's Unigram tokenizer reads, for tests and
smoke runs that build their own checkpoints (nothing is downloaded):
`build_charsmap` compiles a `Precompiled` character map, and
`xlmr_tokenizer_json` lays out a `tokenizer.json` as transformers'
XLM-RoBERTa converter writes it. No serving path calls them.
"""

from __future__ import annotations

import base64
import struct
from typing import Optional

from .unigram import SPIECE


def build_charsmap(mapping: dict) -> bytes:
    """A precompiled charsmap (the layout `Precompiled` reads) that maps
    each key string to its value: a darts-clone double array over the
    keys' UTF-8 bytes, with a unique base for every node and the array
    padded to whole blocks of 256 units."""
    normalized = bytearray()
    root: dict = {}
    for key in sorted(mapping):
        if not key or "\0" in key:
            raise ValueError(f"charsmap key {key!r} is empty or holds NUL")
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = len(normalized)
        normalized += mapping[key].encode("utf-8") + b"\0"
    units: dict = {}
    used, bases = {0}, set()
    lo = 1  # no position below lo is free
    stack = [(root, 0)]
    while stack:
        node, pos = stack.pop()
        labels = sorted(0 if b is None else b for b in node)
        while lo in used:
            lo += 1
        free = lo  # try each free position for the first label's unit
        while True:
            base = free ^ labels[0]
            if free not in used and base not in bases and all(base ^ c not in used for c in labels):
                break
            free += 1
        bases.add(base)
        used.update(base ^ c for c in labels)
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("the charsmap is too large: a node offset needs more than 21 bits")
        units[pos] = units.get(pos, 0) | (offset << 10) | ((1 << 8) if None in node else 0)
        for b, child in node.items():
            if b is None:
                units[base] = child | (1 << 31)
            else:
                units[base ^ b] = b
                stack.append((child, base ^ b))
    n = (max(units) // 256 + 1) * 256
    array = [units.get(i, 0) for i in range(n)]
    return struct.pack("<I", 4 * n) + struct.pack(f"<{n}I", *array) + bytes(normalized)


def xlmr_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None) -> dict:
    """A tokenizer.json as transformers' XLM-RoBERTa converter writes it:
    `vocab` [(piece, score)] after `<s> <pad> </s> <unk>` and before
    `<mask>` (ids 0-3 and the last), the normalizer Sequence[Precompiled,
    Strip(right), Replace(" {2,}", U+2581)] (without Precompiled when
    `charsmap` is None), Metaspace (always, split) and `<s> $A </s>`."""
    pieces = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    pieces += [[p, float(s)] for p, s in vocab] + [["<mask>", 0.0]]
    added = [
        {"id": i, "content": t, "single_word": False, "lstrip": t == "<mask>",
         "rstrip": False, "normalized": False, "special": True}
        for i, t in ((0, "<s>"), (1, "<pad>"), (2, "</s>"), (3, "<unk>"),
                     (len(pieces) - 1, "<mask>"))
    ]
    normalizers = [
        {"type": "Strip", "strip_left": False, "strip_right": True},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": SPIECE},
    ]
    if charsmap is not None:
        normalizers.insert(0, {"type": "Precompiled",
                               "precompiled_charsmap": base64.b64encode(charsmap).decode()})
    special = {t: {"id": t, "ids": [i], "tokens": [t]} for i, t in ((0, "<s>"), (2, "</s>"))}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": normalizers},
        "pre_tokenizer": {"type": "Metaspace", "replacement": SPIECE,
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": special,
        },
        "decoder": {"type": "Metaspace", "replacement": SPIECE,
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": pieces, "byte_fallback": False},
    }
