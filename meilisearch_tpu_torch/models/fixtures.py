"""Writers of the files the port's tokenizers read, for tests and smoke
runs that build their own checkpoints (nothing is downloaded):
`build_charsmap` compiles a `Precompiled` character map,
`xlmr_tokenizer_json` lays out a `tokenizer.json` as transformers'
XLM-RoBERTa converter writes it, `camembert_tokenizer_json` and
`deberta_v3_tokenizer_json` as its CamemBERT and DeBERTa-v2 converters
do (with `camembert_tokenizer_config` and `deberta_v2_tokenizer_config`,
what the fast tokenizers' `save_pretrained` writes beside them),
`albert_tokenizer_json` and `albert_tokenizer_config` as its ALBERT
converter and `AlbertTokenizerFast` write them, `bigbird_tokenizer_json`
and `bigbird_tokenizer_config` as its BigBird converter and
`BigBirdTokenizerFast` write them, `ernie_vocab` a WordPiece
vocabulary laid out as ERNIE 3.0's (CJK characters first),
`roberta_tokenizer_json` a seeded
byte-level BPE one as its RoBERTa converter writes it (with
`longformer_tokenizer_config`, what `LongformerTokenizerFast` writes
beside it),
`modernbert_tokenizer_json` and `modernbert_tokenizer_config` a seeded one
in ModernBERT's layout and the config published beside it,
`qwen2_tokenizer_json` and `llama3_tokenizer_json` seeded ones in Qwen2's
and Llama-3's layouts (their Split pre-tokenizers) with
`qwen2_tokenizer_config` and `llama3_tokenizer_config`,
`gpt2_tokenizer_json` and `bloom_tokenizer_json` seeded ones in GPT-2's
and BLOOM's layouts (BLOOM's Split) with `gpt2_tokenizer_config` and
`bloom_tokenizer_config`,
`llama_tokenizer_json` and `gemma_tokenizer_json` seeded sentencepiece
BPEs with byte fallback as transformers' Llama converter (legacy or
Metaspace) and Gemma converter write them, with `llama_tokenizer_config`
and `gemma_tokenizer_config` (`phi3_tokenizer_json` and
`phi3_tokenizer_config` add Phi-3's chat tokens after Llama-2's
pieces), and `mpnet_vocab`
and `mpnet_tokenizer_config` an MPNet WordPiece vocabulary and the
tokenizer_config.json `MPNetTokenizerFast.save_pretrained` writes beside
it. No serving path calls them.
"""

from __future__ import annotations

import base64
import struct
from collections import Counter
import re
from typing import Callable, Optional

import numpy as np

from .bpe import (
    BLOOM_SPLIT,
    LLAMA3_SPLIT,
    QWEN2_SPLIT,
    byte_level_words,
    byte_piece,
    bytes_to_unicode,
    split_pattern,
)
from .moses import moses_tokenize
from .unigram import SPIECE
from .xlm_bpe import lowercase_and_remove_accent


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


def _added(tokens, lstrip=()) -> list:
    """tokenizer.json's added tokens for (id, content) pairs: special,
    matched on the raw text, `lstrip` for the contents named."""
    return [{"id": i, "content": t, "single_word": False, "lstrip": t in lstrip,
             "rstrip": False, "normalized": False, "special": True} for i, t in tokens]


def _spm_normalizers(charsmap: Optional[bytes]) -> list:
    """SpmConverter's normalizer: [Precompiled (when `charsmap` is given),
    Strip(right), Replace(" {2,}", U+2581)]."""
    out = [{"type": "Strip", "strip_left": False, "strip_right": True},
           {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": SPIECE}]
    if charsmap is not None:
        out.insert(0, _precompiled(charsmap))
    return out


def _precompiled(charsmap: bytes) -> dict:
    return {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(charsmap).decode()}


def _template(cls: tuple, sep: tuple, pair_sep: bool, pair_type: int) -> dict:
    """TemplateProcessing of `cls $A sep` for one text, `cls $A sep
    [sep] $B sep` for two (the second sep only when `pair_sep`, $B and
    its sep of type `pair_type`); `cls` and `sep` are (token, id)."""
    def tok(t, type_id=0):
        return {"SpecialToken": {"id": t, "type_id": type_id}}

    def seq(name, type_id=0):
        return {"Sequence": {"id": name, "type_id": type_id}}

    single = [tok(cls[0]), seq("A"), tok(sep[0])]
    pair = single + [tok(sep[0])] * pair_sep + [seq("B", pair_type), tok(sep[0], pair_type)]
    special = {t: {"id": t, "ids": [i], "tokens": [t]} for t, i in (cls, sep)}
    return {"type": "TemplateProcessing", "single": single, "pair": pair,
            "special_tokens": special}


def _unigram_spec(pieces: list, unk_id: int, added: list, normalizer: dict,
                  pre_tokenizer: dict, post_processor: dict) -> dict:
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": normalizer, "pre_tokenizer": pre_tokenizer,
        "post_processor": post_processor, "decoder": METASPACE,
        "model": {"type": "Unigram", "unk_id": unk_id, "vocab": pieces, "byte_fallback": False},
    }


METASPACE = {"type": "Metaspace", "replacement": SPIECE, "prepend_scheme": "always",
             "split": True}


def xlmr_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None) -> dict:
    """A tokenizer.json as transformers' XLM-RoBERTa converter writes it:
    `vocab` [(piece, score)] after `<s> <pad> </s> <unk>` and before
    `<mask>` (ids 0-3 and the last), the normalizer Sequence[Precompiled,
    Strip(right), Replace(" {2,}", U+2581)] (without Precompiled when
    `charsmap` is None), Metaspace (always, split) and `<s> $A </s>`."""
    pieces = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    pieces += [[p, float(s)] for p, s in vocab] + [["<mask>", 0.0]]
    added = _added([(0, "<s>"), (1, "<pad>"), (2, "</s>"), (3, "<unk>"),
                    (len(pieces) - 1, "<mask>")], lstrip=("<mask>",))
    return _unigram_spec(pieces, 3, added,
                         {"type": "Sequence", "normalizers": _spm_normalizers(charsmap)},
                         METASPACE, _template(("<s>", 0), ("</s>", 2), True, 0))


# CamembertConverter's head: fairseq's four ids and a demoted <unk> piece
CAMEMBERT_HEAD = (("<s>NOTUSED", 0.0), ("<pad>", 0.0), ("</s>NOTUSED", 0.0), ("<unk>", 0.0),
                  ("<unk>NOTUSED", -100.0))


def camembert_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None) -> dict:
    """A tokenizer.json as transformers' CamemBERT converter and
    `CamembertTokenizerFast` write it for a sentencepiece model whose
    pieces are `<unk> <s> </s>` then `vocab` [(piece, score)]:
    CAMEMBERT_HEAD (ids 0-4), `<s>` and `</s>` (5 and 6), `vocab`, then
    `<mask>` (lstrip); unk_id 3; the added tokens 0-6 and `<mask>`; XLM-R's
    normalizer and Metaspace; `<s> $A </s>`. camembert-base's 32,005
    entries take 31,997 pieces in `vocab`."""
    pieces = [[p, float(s)] for p, s in CAMEMBERT_HEAD] + [["<s>", 0.0], ["</s>", 0.0]]
    pieces += [[p, float(s)] for p, s in vocab] + [["<mask>", 0.0]]
    added = _added([*enumerate(p for p, _s in pieces[:7]), (len(pieces) - 1, "<mask>")],
                   lstrip=("<mask>",))
    return _unigram_spec(pieces, 3, added,
                         {"type": "Sequence", "normalizers": _spm_normalizers(charsmap)},
                         METASPACE, _template(("<s>", 5), ("</s>", 6), True, 0))


def camembert_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `CamembertTokenizerFast.save_pretrained`
    writes beside such a tokenizer.json (model_max_length camembert-base's
    512)."""
    return {"added_tokens_decoder": _added_decoder(spec),
            "additional_special_tokens": ["<s>NOTUSED", "</s>NOTUSED", "<unk>NOTUSED"],
            "bos_token": "<s>", "clean_up_tokenization_spaces": False, "cls_token": "<s>",
            "eos_token": "</s>", "extra_special_tokens": {}, "mask_token": "<mask>",
            "model_max_length": 512, "pad_token": "<pad>", "sep_token": "</s>",
            "tokenizer_class": "CamembertTokenizerFast", "unk_token": "<unk>"}


# DeBERTa-v3's sentencepiece model opens with these four pieces
DEBERTA_HEAD = ("[PAD]", "[CLS]", "[SEP]", "[UNK]")


def deberta_v3_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None,
                              do_lower_case: bool = False, split_by_punct: bool = False) -> dict:
    """A tokenizer.json as transformers' DeBERTa-v2 converter and
    `DebertaV2TokenizerFast` write it for a sentencepiece model whose
    pieces are DEBERTA_HEAD then `vocab` [(piece, score)]: unk_id 3;
    `[MASK]` an added token after the model's last piece (128,000 in
    deberta-v3-base); the normalizer Sequence[Lowercase (only with
    `do_lower_case`), Strip, Precompiled (when `charsmap` is given),
    Replace(" {2,}", " ")]; Sequence[Punctuation (Isolated, only with
    `split_by_punct`), Metaspace]; `[CLS] $A [SEP]`."""
    pieces = [[p, 0.0] for p in DEBERTA_HEAD] + [[p, float(s)] for p, s in vocab]
    added = _added([*enumerate(DEBERTA_HEAD), (len(pieces), "[MASK]")])
    normalizers = [{"type": "Strip", "strip_left": True, "strip_right": True}]
    if do_lower_case:
        normalizers.insert(0, {"type": "Lowercase"})
    if charsmap is not None:
        normalizers.append(_precompiled(charsmap))
    normalizers.append({"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "})
    pre = [{"type": "Punctuation", "behavior": "Isolated"}] * split_by_punct + [METASPACE]
    return _unigram_spec(pieces, 3, added, {"type": "Sequence", "normalizers": normalizers},
                         {"type": "Sequence", "pretokenizers": pre},
                         _template(("[CLS]", 1), ("[SEP]", 2), False, 1))


def deberta_v2_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `DebertaV2TokenizerFast.save_pretrained`
    writes beside such a tokenizer.json, `do_lower_case` and
    `split_by_punct` read from it (model_max_length 512)."""
    normalizers = spec["normalizer"]["normalizers"]
    pre = spec["pre_tokenizer"]["pretokenizers"]
    return {"added_tokens_decoder": _added_decoder(spec), "bos_token": "[CLS]",
            "clean_up_tokenization_spaces": False, "cls_token": "[CLS]",
            "do_lower_case": any(n["type"] == "Lowercase" for n in normalizers),
            "eos_token": "[SEP]", "extra_special_tokens": {}, "mask_token": "[MASK]",
            "model_max_length": 512, "pad_token": "[PAD]", "sep_token": "[SEP]",
            "split_by_punct": any(p["type"] == "Punctuation" for p in pre),
            "tokenizer_class": "DebertaV2TokenizerFast", "unk_token": "[UNK]"}


# ALBERT's sentencepiece model opens with these five pieces
ALBERT_HEAD = ("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]")


def albert_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None,
                          do_lower_case: bool = True, keep_accents: bool = False) -> dict:
    """A tokenizer.json as transformers' ALBERT converter and
    `AlbertTokenizerFast` write it for a sentencepiece model whose pieces
    are ALBERT_HEAD then `vocab` [(piece, score)]: a piece that ends in a
    digit and a comma scores 100 less (the converter's
    `check_number_comma`); unk_id 1; the added tokens 0-4, `[MASK]` with
    lstrip; the normalizer Sequence[Replace("``", '"'), Replace("''",
    '"'), NFKD and StripAccents (unless `keep_accents`), Lowercase (with
    `do_lower_case`), Precompiled (when `charsmap` is given), Replace("
    {2,}", " ")]; Metaspace (always, split); `[CLS] $A [SEP]`.
    paraphrase-albert-small-v2's 30,000 entries take 29,995 pieces in
    `vocab`."""
    def score(piece, s):
        comma = len(piece) >= 2 and piece[-1] == "," and piece[-2].isdigit()
        return float(s) - 100 if comma else float(s)

    pieces = [[p, 0.0] for p in ALBERT_HEAD] + [[p, score(p, s)] for p, s in vocab]
    added = _added(enumerate(ALBERT_HEAD), lstrip=("[MASK]",))
    normalizers = [{"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
                   {"type": "Replace", "pattern": {"String": "''"}, "content": '"'}]
    if not keep_accents:
        normalizers += [{"type": "NFKD"}, {"type": "StripAccents"}]
    if do_lower_case:
        normalizers.append({"type": "Lowercase"})
    if charsmap is not None:
        normalizers.append(_precompiled(charsmap))
    normalizers.append({"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "})
    return _unigram_spec(pieces, 1, added, {"type": "Sequence", "normalizers": normalizers},
                         METASPACE, _template(("[CLS]", 2), ("[SEP]", 3), False, 1))


def albert_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `AlbertTokenizerFast.save_pretrained`
    writes beside such a tokenizer.json, `do_lower_case` and
    `keep_accents` read from it (model_max_length 512, as published)."""
    kinds = [n["type"] for n in spec["normalizer"]["normalizers"]]
    return {"added_tokens_decoder": _added_decoder(spec), "bos_token": "[CLS]",
            "clean_up_tokenization_spaces": False, "cls_token": "[CLS]",
            "do_lower_case": "Lowercase" in kinds, "eos_token": "[SEP]",
            "extra_special_tokens": {}, "keep_accents": "StripAccents" not in kinds,
            "mask_token": "[MASK]", "model_max_length": 512, "pad_token": "<pad>",
            "remove_space": True, "sep_token": "[SEP]", "tokenizer_class": "AlbertTokenizerFast",
            "unk_token": "<unk>"}


# BigBird's specials: the sentencepiece model's first four pieces, and
# its [CLS], [SEP] and [MASK] at 65-67 (google/bigbird-roberta-base's
# config.json: pad 0, bos 1, eos 2, sep 66)
BIGBIRD_HEAD = ("<pad>", "<s>", "</s>", "<unk>")
BIGBIRD_MARKS = ("[CLS]", "[SEP]", "[MASK]")
BIGBIRD_MARKS_AT = 65


def bigbird_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None) -> dict:
    """A tokenizer.json as transformers' BigBird converter and
    `BigBirdTokenizerFast` write it for a sentencepiece model whose pieces
    are BIGBIRD_HEAD (control pieces, `<unk>` the unknown one), then
    `vocab` [(piece, score)] with BIGBIRD_MARKS (control pieces) placed at
    ids 65-67 (after the vocabulary's first 61 pieces, or after all of a
    shorter one): unk_id 3; the seven specials as added tokens, `[MASK]`
    with lstrip; SpmConverter's normalizer Sequence[Precompiled (when
    `charsmap` is given), Strip(right), Replace(" {2,}", U+2581)], Metaspace
    (always, split); `[CLS] $A [SEP]`."""
    cut = min(BIGBIRD_MARKS_AT - len(BIGBIRD_HEAD), len(vocab))
    body = [[p, float(s)] for p, s in vocab]
    pieces = ([[p, 0.0] for p in BIGBIRD_HEAD] + body[:cut] + [[p, 0.0] for p in BIGBIRD_MARKS]
              + body[cut:])
    ids = {p: i for i, (p, _s) in enumerate(pieces)}
    added = _added(sorted((ids[t], t) for t in BIGBIRD_HEAD + BIGBIRD_MARKS), lstrip=("[MASK]",))
    return _unigram_spec(pieces, 3, added,
                         {"type": "Sequence", "normalizers": _spm_normalizers(charsmap)},
                         METASPACE, _template(("[CLS]", ids["[CLS]"]), ("[SEP]", ids["[SEP]"]),
                                              False, 1))


def bigbird_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `BigBirdTokenizerFast.save_pretrained`
    writes beside such a tokenizer.json (model_max_length
    google/bigbird-roberta-base's 4096)."""
    return {"added_tokens_decoder": _added_decoder(spec), "bos_token": "<s>",
            "clean_up_tokenization_spaces": False, "cls_token": "[CLS]", "eos_token": "</s>",
            "extra_special_tokens": {}, "mask_token": "[MASK]", "model_max_length": 4096,
            "pad_token": "<pad>", "sep_token": "[SEP]", "tokenizer_class": "BigBirdTokenizerFast",
            "unk_token": "<unk>"}


# XLNet's sentencepiece model opens with these nine pieces, `<eod>` and
# `<eop>` user-defined, the others control symbols
XLNET_HEAD = ("<unk>", "<s>", "</s>", "<cls>", "<sep>", "<pad>", "<mask>", "<eod>", "<eop>")
XLNET_USER = ("<eod>", "<eop>")


def xlnet_tokenizer_json(vocab: list, charsmap: Optional[bytes] = None,
                         do_lower_case: bool = False, keep_accents: bool = False) -> dict:
    """A tokenizer.json as transformers' XLNet converter and
    `XLNetTokenizerFast` write it for a sentencepiece model whose pieces
    are XLNET_HEAD then `vocab` [(piece, score)]: ALBERT's scores and
    normalizers (`albert_tokenizer_json`; cased and accent-stripping by
    default, as xlnet-base-cased), unk_id 0; the added tokens 0-8, `<mask>`
    with lstrip, the user-defined ones not special; Metaspace (always,
    split); `$A:0 <sep>:0 <cls>:2`. xlnet-base-cased's 32,000 entries take
    31,991 pieces in `vocab`."""
    spec = albert_tokenizer_json([], charsmap, do_lower_case, keep_accents)
    scored = albert_tokenizer_json(vocab)["model"]["vocab"][len(ALBERT_HEAD):]
    pieces = [[p, 0.0] for p in XLNET_HEAD] + scored
    added = _added(enumerate(XLNET_HEAD), lstrip=("<mask>",))
    for tok in added:
        tok["special"] = tok["content"] not in XLNET_USER
    seq = {"Sequence": {"id": "A", "type_id": 0}}
    single = [seq, {"SpecialToken": {"id": "<sep>", "type_id": 0}},
              {"SpecialToken": {"id": "<cls>", "type_id": 2}}]
    pair = [seq, {"SpecialToken": {"id": "<sep>", "type_id": 0}},
            {"Sequence": {"id": "B", "type_id": 1}},
            {"SpecialToken": {"id": "<sep>", "type_id": 1}},
            {"SpecialToken": {"id": "<cls>", "type_id": 2}}]
    special = {t: {"id": t, "ids": [XLNET_HEAD.index(t)], "tokens": [t]}
               for t in ("<cls>", "<sep>")}
    return _unigram_spec(pieces, 0, added, spec["normalizer"], METASPACE,
                         {"type": "TemplateProcessing", "single": single, "pair": pair,
                          "special_tokens": special})


def xlnet_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `XLNetTokenizerFast.save_pretrained`
    writes beside such a tokenizer.json, `do_lower_case` and
    `keep_accents` read from it (no model_max_length: XLNet has no
    length limit)."""
    kinds = [n["type"] for n in spec["normalizer"]["normalizers"]]
    return {"added_tokens_decoder": _added_decoder(spec),
            "additional_special_tokens": ["<eop>", "<eod>"], "bos_token": "<s>",
            "clean_up_tokenization_spaces": False, "cls_token": "<cls>",
            "do_lower_case": "Lowercase" in kinds, "eos_token": "</s>",
            "extra_special_tokens": {}, "keep_accents": "StripAccents" not in kinds,
            "mask_token": "<mask>", "pad_token": "<pad>", "remove_space": True,
            "sep_token": "<sep>", "tokenizer_class": "XLNetTokenizerFast", "unk_token": "<unk>"}


# ERNIE 3.0's vocab.txt opens with these, then its most frequent characters
ERNIE_HEAD = ("[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]")


def ernie_vocab(words: list, size: int, n_cjk: int = 6000) -> list:
    """`size` WordPiece entries laid out as ERNIE 3.0's Chinese vocab.txt
    begins (ERNIE_HEAD), then `n_cjk` CJK characters from U+4E00, the
    printable ASCII characters, `words`, every ASCII character's ## piece,
    then filler."""
    chars = [chr(c) for c in range(33, 127)]
    vocab = list(ERNIE_HEAD) + [chr(0x4E00 + i) for i in range(n_cjk)]
    vocab = list(dict.fromkeys(vocab + chars + list(words) + ["##" + c for c in chars]))
    if len(vocab) > size:
        raise ValueError(f"{len(vocab)} entries do not fit a vocabulary of {size}")
    return vocab + [f"filler{i}" for i in range(size - len(vocab))]


def _added_decoder(spec: dict) -> dict:
    """tokenizer_config.json's `added_tokens_decoder` of a tokenizer.json's
    added tokens."""
    return {str(tok["id"]): {k: tok[k] for k in ("content", "lstrip", "normalized", "rstrip",
                                                  "single_word", "special")}
            for tok in spec["added_tokens"]}


def train_merges(texts: list, n_merges: int, split: Optional[str] = None,
                 to_words: Optional[Callable] = None) -> list:
    """A small BPE trainer: up to `n_merges` merges over the ByteLevel words
    of `texts` (cut by the Split pattern `split` where given; or the
    words `to_words(text)` gives, over characters), each time the adjacent
    pair most frequent over the words (on a tie, the smallest pair), until
    no pair occurs twice."""
    pattern = None if split is None else split_pattern(split)
    words = Counter()
    for text in texts:
        words.update(byte_level_words(text, split=pattern) if to_words is None
                     else to_words(text))
    split = {w: list(w) for w in words}
    pairs: Counter = Counter()
    where: dict = {}  # pair -> the words holding it
    for w, count in words.items():
        for pair in zip(split[w], split[w][1:]):
            pairs[pair] += count
            where.setdefault(pair, set()).add(w)
    merges = []
    while len(merges) < n_merges and pairs:
        top = max(pairs.values())
        if top < 2:
            break
        a, b = min(p for p, c in pairs.items() if c == top)
        merges.append((a, b))
        for w in where.pop((a, b)):
            syms, count = split[w], words[w]
            for pair in zip(syms, syms[1:]):
                pairs[pair] -= count
                if pairs[pair] <= 0:
                    del pairs[pair]
            i, out = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            split[w] = out
            for pair in zip(out, out[1:]):
                pairs[pair] += count
                where.setdefault(pair, set()).add(w)
    return merges


def _grow_vocab(vocab: dict, head: int, texts: list, size: int, seed: int,
                n_trained: int, split: Optional[str] = None,
                to_words: Optional[Callable] = None, longest: Optional[int] = None) -> list:
    """Add to `vocab` (`head` entries that never merge, then the symbols)
    the merges of `train_merges` over `texts`, then seeded merges of two
    existing tokens (not the head; with `longest`, a token under that many
    characters and one character) into a new one, until it holds `size`
    tokens; returns the merges."""
    merges = []
    for a, b in train_merges(texts, n_trained, split, to_words):
        if a + b not in vocab and len(vocab) < size:
            vocab[a + b] = len(vocab)
            merges.append([a, b])
    rng = np.random.default_rng(seed)
    tokens = list(vocab)[head:]
    chars = [t for t in tokens if len(t) == 1]
    while len(vocab) < size:
        if longest:  # a token shorter than `longest` grows by one character
            picks = np.stack([rng.integers(0, len(tokens), 4096),
                              rng.integers(0, len(chars), 4096)], axis=1)
        else:
            picks = rng.integers(0, len(tokens), (4096, 2))
        for i, j in picks.tolist():
            a, b = tokens[i], (chars[j] if longest else tokens[j])
            if a + b in vocab or len(vocab) >= size or (longest and len(a) >= longest):
                continue
            vocab[a + b] = len(vocab)
            merges.append([a, b])
            tokens.append(a + b)
    return merges


def _bpe_model(vocab: dict, merges: list) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
            "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False,
            "ignore_merges": False, "vocab": vocab, "merges": merges}


BYTE_LEVEL = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
              "use_regex": True}


def roberta_tokenizer_json(texts: list, vocab_size: int, seed: int,
                           n_trained: int = 4096) -> dict:
    """A byte-level BPE tokenizer.json as transformers' RoBERTa converter
    writes it: `<s> <pad> </s> <unk>` at ids 0-3, the 256 byte symbols,
    the merges of `train_merges` over `texts`, then seeded merges of two
    existing tokens into a new one up to `vocab_size` - 1 tokens, and
    `<mask>` (lstrip) last; ByteLevel (no prefix space), `<s> $A </s>`."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, 4, texts, vocab_size - 1, seed, n_trained)
    vocab["<mask>"] = len(vocab)
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": t == "<mask>",
              "rstrip": False, "normalized": t != "<mask>", "special": True}
             for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>")]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None, "pre_tokenizer": BYTE_LEVEL,
        "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0],
                           "trim_offsets": True, "add_prefix_space": False},
        "decoder": BYTE_LEVEL,
        "model": _bpe_model(vocab, merges),
    }


def longformer_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json `LongformerTokenizerFast.save_pretrained`
    writes beside a `roberta_tokenizer_json` file (model_max_length
    allenai/longformer-base-4096's 4096)."""
    return {"add_prefix_space": False, "added_tokens_decoder": _added_decoder(spec),
            "bos_token": "<s>", "clean_up_tokenization_spaces": False, "cls_token": "<s>",
            "eos_token": "</s>", "errors": "replace", "extra_special_tokens": {},
            "mask_token": "<mask>", "model_max_length": 4096, "pad_token": "<pad>",
            "sep_token": "</s>", "tokenizer_class": "LongformerTokenizer", "trim_offsets": True,
            "unk_token": "<unk>"}


GPT2_EOS = "<|endoftext|>"


def gpt2_tokenizer_json(texts: list, vocab_size: int, seed: int, n_trained: int = 4096) -> dict:
    """A byte-level BPE tokenizer.json in GPT-2's layout (GPT-Neo's, GPT-J's
    and SGPT's): the 256 byte symbols at ids 0-255, the merges of
    `train_merges` over `texts`, then seeded merges up to `vocab_size` - 1
    tokens (50,257 published), and `<|endoftext|>` last; ByteLevel (no
    prefix space), a ByteLevel post-processor, which adds nothing."""
    vocab: dict = {}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, 0, texts, vocab_size - 1, seed, n_trained)
    vocab[GPT2_EOS] = len(vocab)
    added = [{"id": vocab[GPT2_EOS], "content": GPT2_EOS, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": True}]
    post = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
            "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": BYTE_LEVEL, "post_processor": post,
            "decoder": BYTE_LEVEL, "model": _bpe_model(vocab, merges)}


def gpt2_tokenizer_config(spec: dict, pad_token: Optional[str] = GPT2_EOS,
                          padding_side: Optional[str] = None) -> dict:
    """The tokenizer_config.json `GPT2TokenizerFast.save_pretrained` writes
    beside such a file (class `GPT2Tokenizer`, `<|endoftext|>` as unk, bos
    and eos, `add_bos_token` false), with `pad_token` (GPT-2 publishes none,
    batched embedding needs one; None leaves it out) and `padding_side`
    where given."""
    config = {"add_bos_token": False, "add_prefix_space": False,
              "added_tokens_decoder": _added_decoder(spec), "bos_token": GPT2_EOS,
              "clean_up_tokenization_spaces": False, "eos_token": GPT2_EOS, "errors": "replace",
              "extra_special_tokens": {}, "model_max_length": 2048,
              "tokenizer_class": "GPT2Tokenizer", "unk_token": GPT2_EOS}
    if pad_token is not None:
        config["pad_token"] = pad_token
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


BLOOM_HEAD = ("<unk>", "<s>", "</s>", "<pad>")


def bloom_tokenizer_json(texts: list, vocab_size: int, seed: int, n_trained: int = 4096) -> dict:
    """A byte-level BPE tokenizer.json in BLOOM's layout: `<unk> <s> </s>
    <pad>` at ids 0-3 (special, not normalized), the 256 byte symbols, the
    merges of `train_merges` over `texts` through BLOOM's Split pattern,
    then seeded merges, `vocab_size` tokens in all (250,680 published,
    under the model's 250,880 rows); no normalizer,
    Sequence[Split(BLOOM_SPLIT, Isolated), ByteLevel (use_regex false)], a
    ByteLevel post-processor."""
    vocab = {t: i for i, t in enumerate(BLOOM_HEAD)}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, len(BLOOM_HEAD), texts, vocab_size, seed, n_trained, BLOOM_SPLIT)
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True} for t in BLOOM_HEAD]
    post = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
            "use_regex": False}
    return _bpe_spec(vocab, merges, added, None, _split_sequence(BLOOM_SPLIT, trim_offsets=True),
                     post)


def bloom_tokenizer_config(spec: dict, padding_side: Optional[str] = "left") -> dict:
    """The tokenizer_config.json BLOOM's checkpoints publish beside such a
    file (class `BloomTokenizerFast`, its four specials, `padding_side`
    left; None leaves it out, the class's right)."""
    config = {"added_tokens_decoder": _added_decoder(spec), "bos_token": "<s>",
              "clean_up_tokenization_spaces": False, "eos_token": "</s>",
              "model_max_length": 1_000_000_000_000_000_019_884_624_838_656,
              "pad_token": "<pad>", "tokenizer_class": "BloomTokenizerFast", "unk_token": "<unk>"}
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


# GPT-NeoX-20B's vocabulary (Pythia's and BMRetriever's): two specials
# first, its byte-level BPE, then (from id 50254) 23 non-special added
# tokens, runs of 24 down to 2 spaces: 50,277 entries
GPT_NEOX_HEAD = ("<|endoftext|>", "<|padding|>")
GPT_NEOX_ADDED = tuple(" " * n for n in range(24, 1, -1))
GPT_NEOX_EOS, GPT_NEOX_PAD = GPT_NEOX_HEAD


def gpt_neox_tokenizer_json(texts: list, vocab_size: int, seed: int,
                            n_trained: int = 4096) -> dict:
    """A byte-level BPE tokenizer.json in GPT-NeoX-20B's layout:
    GPT_NEOX_HEAD (special, not normalized), the 256 byte symbols, the
    merges of `train_merges` over `texts`, then seeded merges up to the
    first added token's id, then GPT_NEOX_ADDED (normalized, not special),
    `vocab_size` entries in all (50,277 published); the NFC normalizer,
    ByteLevel without prefix space, a ByteLevel post-processor (which the
    class replaces)."""
    vocab = {t: i for i, t in enumerate(GPT_NEOX_HEAD)}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, len(GPT_NEOX_HEAD), texts, vocab_size - len(GPT_NEOX_ADDED),
                         seed, n_trained)
    for t in GPT_NEOX_ADDED:
        vocab[t] = len(vocab)
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": t in GPT_NEOX_ADDED, "special": t in GPT_NEOX_HEAD}
             for t in (*GPT_NEOX_HEAD, *GPT_NEOX_ADDED)]
    post = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
            "use_regex": True}
    return _bpe_spec(vocab, merges, added, {"type": "NFC"}, BYTE_LEVEL, post)


def gpt_neox_tokenizer_config(spec: dict, pad_token: Optional[str] = GPT_NEOX_PAD,
                              padding_side: Optional[str] = None, add_bos_token: bool = False,
                              add_eos_token: bool = False) -> dict:
    """The tokenizer_config.json Pythia's checkpoints publish beside such a
    file, as recalled (class `GPTNeoXTokenizer`, `<|endoftext|>` as unk,
    bos and eos, `add_bos_token` and `add_eos_token` false, no pad), with
    `pad_token` (`<|padding|>` by default: batched embedding needs one;
    None leaves it out), `padding_side` where given and the two flags."""
    config = {"add_bos_token": add_bos_token, "add_eos_token": add_eos_token,
              "add_prefix_space": False, "added_tokens_decoder": _added_decoder(spec),
              "bos_token": GPT_NEOX_EOS, "clean_up_tokenization_spaces": True,
              "eos_token": GPT_NEOX_EOS, "model_max_length": 1 << 60,
              "tokenizer_class": "GPTNeoXTokenizer", "unk_token": GPT_NEOX_EOS}
    if pad_token is not None:
        config["pad_token"] = pad_token
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


# ModernBERT's vocabulary extends GPT-NeoX's: after GPT_NEOX_ADDED the
# placeholders of scrubbed personal data (non-special too); then
# ModernBERT's specials from id 50280 ([MASK] lstrip) and [unused] slots
# up to its 50,368 entries
MODERNBERT_HEAD = GPT_NEOX_HEAD
MODERNBERT_ADDED = (*GPT_NEOX_ADDED, "|||IP_ADDRESS|||", "|||EMAIL_ADDRESS|||",
                    "|||PHONE_NUMBER|||")
MODERNBERT_SPECIALS = ("[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]")


def modernbert_tokenizer_json(texts: list, vocab_size: int, seed: int, n_trained: int = 4096,
                              added: tuple = MODERNBERT_ADDED, added_normalized: bool = True,
                              unused: int = 83) -> dict:
    """A byte-level BPE tokenizer.json in ModernBERT's layout:
    MODERNBERT_HEAD, the 256 byte symbols and merges built as
    `roberta_tokenizer_json` builds them up to the first added token's id,
    the non-special `added` tokens (matched on the normalized text when
    `added_normalized`), MODERNBERT_SPECIALS, then `unused` special
    `[unusedN]` slots, `vocab_size` entries in all (50,368 with the
    defaults: [CLS] 50281, [SEP] 50282, [PAD] 50283); the NFC normalizer,
    ByteLevel without prefix space, `[CLS] $A [SEP]`."""
    vocab = {t: i for i, t in enumerate(MODERNBERT_HEAD)}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    tail = [*added, *MODERNBERT_SPECIALS, *(f"[unused{i}]" for i in range(unused))]
    merges = _grow_vocab(vocab, len(MODERNBERT_HEAD), texts, vocab_size - len(tail), seed,
                         n_trained)
    for t in tail:
        if t in vocab:
            raise ValueError(f"the added token {t!r} is already a BPE token")
        vocab[t] = len(vocab)
    plain = set(added)
    added_tokens = [
        {"id": vocab[t], "content": t, "single_word": False, "lstrip": t == "[MASK]",
         "rstrip": False, "normalized": added_normalized if t in plain else False,
         "special": t not in plain}
        for t in (*MODERNBERT_HEAD, *tail)
    ]
    special = {t: {"id": t, "ids": [vocab[t]], "tokens": [t]} for t in ("[CLS]", "[SEP]")}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added_tokens,
        "normalizer": {"type": "NFC"}, "pre_tokenizer": BYTE_LEVEL,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": special,
        },
        "decoder": BYTE_LEVEL,
        "model": _bpe_model(vocab, merges),
    }


def modernbert_tokenizer_config(spec: dict) -> dict:
    """The tokenizer_config.json ModernBERT publishes beside such a
    tokenizer.json: class `PreTrainedTokenizerFast`, its specials by
    name, `model_input_names` without token types, and
    `added_tokens_decoder` with every added token's flags."""
    return {"added_tokens_decoder": _added_decoder(spec), "clean_up_tokenization_spaces": True,
            "cls_token": "[CLS]", "mask_token": "[MASK]", "pad_token": "[PAD]",
            "sep_token": "[SEP]", "unk_token": "[UNK]",
            "model_input_names": ["input_ids", "attention_mask"], "model_max_length": 8192,
            "tokenizer_class": "PreTrainedTokenizerFast"}


def _split_sequence(pattern: str, trim_offsets: bool) -> dict:
    return {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": trim_offsets,
         "use_regex": False}]}


def _single_template(single: list, vocab: dict) -> dict:
    """A TemplateProcessing of `single` (special tokens and "$A"), the pair
    template the same with $B after $A."""

    def items(seq: str, type_id: int) -> list:
        return [{"Sequence": {"id": seq, "type_id": type_id}} if t == "$A" else
                {"SpecialToken": {"id": t, "type_id": type_id}} for t in single]

    return {"type": "TemplateProcessing", "single": items("A", 0),
            "pair": items("A", 0) + items("B", 1),
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in single if t != "$A"}}


def _bpe_spec(vocab: dict, merges: list, added: list, normalizer: Optional[dict],
              pre_tokenizer: dict, post_processor: dict, ignore_merges: bool = False) -> dict:
    model = _bpe_model(vocab, merges)
    model["ignore_merges"] = ignore_merges
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": normalizer, "pre_tokenizer": pre_tokenizer,
            "post_processor": post_processor,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": model}


# Qwen2's (and Qwen2.5's and Qwen3's) specials, from id 151,643 on at the
# published size, right after the byte-level BPE; the tool-call and
# thinking tags are not special
QWEN2_SPECIALS = (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>", "<|object_ref_end|>",
    "<|box_start|>", "<|box_end|>", "<|quad_start|>", "<|quad_end|>", "<|vision_start|>",
    "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>", "<tool_call>",
    "</tool_call>", "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
    "<|repo_name|>", "<|file_sep|>", "<tool_response>", "</tool_response>", "<think>", "</think>",
)
QWEN2_PLAIN = ("<tool_call>", "</tool_call>", "<tool_response>", "</tool_response>", "<think>",
               "</think>")


def qwen2_tokenizer_json(texts: list, bpe_size: int, seed: int, n_trained: int = 4096,
                         eos_template: bool = False) -> dict:
    """A byte-level BPE tokenizer.json in Qwen2's layout: the 256 byte
    symbols at ids 0-255, merges trained on `texts` through Qwen2's Split
    pattern, then seeded merges, `bpe_size` BPE tokens in all (151,643
    published), then QWEN2_SPECIALS (`<|endoftext|>` at `bpe_size`; none
    normalized); NFC, Sequence[Split(QWEN2_SPLIT, Isolated), ByteLevel
    (use_regex false)], and a ByteLevel post-processor, which adds
    nothing, or with `eos_template` Qwen3-Embedding's `$A <|endoftext|>`."""
    vocab: dict = {}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, 0, texts, bpe_size, seed, n_trained, QWEN2_SPLIT)
    for t in QWEN2_SPECIALS:
        if t in vocab:
            raise ValueError(f"the special token {t!r} is already a BPE token")
        vocab[t] = len(vocab)
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": t not in QWEN2_PLAIN}
             for t in QWEN2_SPECIALS]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    post = _single_template(["$A", "<|endoftext|>"], vocab) if eos_template else byte_level
    return _bpe_spec(vocab, merges, added, {"type": "NFC"},
                     _split_sequence(QWEN2_SPLIT, trim_offsets=False), post)


def qwen2_tokenizer_config(spec: dict, padding_side: Optional[str] = None) -> dict:
    """The tokenizer_config.json Qwen2's and Qwen3's checkpoints publish
    beside such a tokenizer.json: class `Qwen2Tokenizer`, no bos, eos and
    pad `<|endoftext|>`, no unk, every added token's flags; `padding_side`
    where given (Qwen3-Embedding's is `left`)."""
    config = {"add_prefix_space": False, "added_tokens_decoder": _added_decoder(spec),
              "bos_token": None, "clean_up_tokenization_spaces": False,
              "eos_token": "<|endoftext|>", "errors": "replace", "model_max_length": 32768,
              "pad_token": "<|endoftext|>", "split_special_tokens": False,
              "tokenizer_class": "Qwen2Tokenizer", "unk_token": None}
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


def llama3_specials(n_reserved: int) -> tuple:
    """Llama-3.1's specials in their order, with `n_reserved` reserved ones
    in all (248 published, 256 specials from id 128,000)."""
    head = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
            "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
            "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
            "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    return (*head, *(f"<|reserved_special_token_{i}|>" for i in range(3, n_reserved)))


def llama3_tokenizer_json(texts: list, bpe_size: int, seed: int, n_trained: int = 4096,
                          n_reserved: int = 8) -> dict:
    """A byte-level BPE tokenizer.json in Llama-3's layout: the 256 byte
    symbols at ids 0-255, merges trained on `texts` through Llama-3's Split
    pattern, then seeded merges, `bpe_size` BPE tokens in all (128,000
    published), then `llama3_specials`; no normalizer,
    Sequence[Split(LLAMA3_SPLIT, Isolated), ByteLevel (use_regex false)],
    BPE with `ignore_merges`, and Sequence[ByteLevel, TemplateProcessing
    `<|begin_of_text|> $A`]."""
    vocab: dict = {}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    merges = _grow_vocab(vocab, 0, texts, bpe_size, seed, n_trained, LLAMA3_SPLIT)
    specials = llama3_specials(n_reserved)
    for t in specials:
        if t in vocab:
            raise ValueError(f"the special token {t!r} is already a BPE token")
        vocab[t] = len(vocab)
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True} for t in specials]
    post = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
        _single_template(["<|begin_of_text|>", "$A"], vocab)]}
    return _bpe_spec(vocab, merges, added, None, _split_sequence(LLAMA3_SPLIT, trim_offsets=True),
                     post, ignore_merges=True)


def llama3_tokenizer_config(spec: dict, pad_token: str = "<|finetune_right_pad_id|>",
                            padding_side: Optional[str] = None) -> dict:
    """The tokenizer_config.json Llama-3's checkpoints publish beside such a
    tokenizer.json (class `PreTrainedTokenizerFast`, bos
    `<|begin_of_text|>`, eos `<|end_of_text|>`, `model_input_names`
    without token types, every added token's flags), with `pad_token`,
    which Llama-3 does not publish and batched embedding needs, and
    `padding_side` where given."""
    config = {"added_tokens_decoder": _added_decoder(spec), "bos_token": "<|begin_of_text|>",
              "clean_up_tokenization_spaces": True, "eos_token": "<|end_of_text|>",
              "model_input_names": ["input_ids", "attention_mask"],
              "model_max_length": 131072, "pad_token": pad_token,
              "tokenizer_class": "PreTrainedTokenizerFast"}
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


SPM_PIECE_MAX = 16  # sentencepiece's max_piece_length default
SPM_DECODER = [{"type": "Replace", "pattern": {"String": SPIECE}, "content": " "},
               {"type": "ByteFallback"}, {"type": "Fuse"}]


def spm_training_words(text: str) -> list:
    """A text's words as sentencepiece trains on them: spaces as U+2581,
    one in front, each word opening with it."""
    return re.findall(f"{SPIECE}[^{SPIECE}]*|[^{SPIECE}]+", SPIECE + text.replace(" ", SPIECE))


def _spm_bpe(head: list, texts: list, vocab_size: int, seed: int, n_trained: int,
             chars: str = "") -> tuple:
    """(vocab, merges) of a seeded sentencepiece BPE: `head`, the 256
    `<0xNN>` byte pieces, U+2581, `chars` and every character of `texts`,
    then merges trained on their words and seeded merges of two pieces
    that are neither the head nor byte pieces, up to sentencepiece's 16
    characters a piece, `vocab_size` in all."""
    vocab = {t: i for i, t in enumerate(head)}
    for b in range(256):
        vocab[byte_piece(b)] = len(vocab)
    fixed = len(vocab)
    for ch in dict.fromkeys(SPIECE + chars + "".join(sorted(set("".join(texts)) - {" "}))):
        vocab.setdefault(ch, len(vocab))
    merges = _grow_vocab(vocab, fixed, texts, vocab_size, seed, n_trained,
                         to_words=spm_training_words, longest=SPM_PIECE_MAX)
    return vocab, merges


def _spm_model(vocab: dict, merges: list) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": "<unk>",
            "continuing_subword_prefix": None, "end_of_word_suffix": None, "fuse_unk": True,
            "byte_fallback": True, "ignore_merges": False, "vocab": vocab, "merges": merges}


LLAMA_HEAD = ("<unk>", "<s>", "</s>")


def llama_tokenizer_json(texts: list, vocab_size: int, seed: int, legacy: bool = True,
                         n_trained: int = 4096) -> dict:
    """A tokenizer.json as transformers' Llama converter and
    `LlamaTokenizerFast` write it for Llama-2's and Mistral's
    sentencepiece BPE: `<unk> <s> </s>` (ids 0-2, added specials), the 256
    `<0xNN>` pieces, then the seeded BPE of `_spm_bpe`, `vocab_size`
    pieces (32,000 published); BPE with byte_fallback and fuse_unk, unk
    `<unk>`; the legacy layout's normalizer Sequence[Prepend("▁"),
    Replace(" ", "▁")] and no pre-tokenizer, or (`legacy` false) no
    normalizer and Metaspace (prepend scheme first, no split); the
    template `<s> $A`."""
    vocab, merges = _spm_bpe(list(LLAMA_HEAD), texts, vocab_size, seed, n_trained)
    if legacy:
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SPIECE},
            {"type": "Replace", "pattern": {"String": " "}, "content": SPIECE}]}
        pre = None
    else:
        normalizer = None
        pre = {"type": "Metaspace", "replacement": SPIECE, "prepend_scheme": "first",
               "split": False}
    decoder = SPM_DECODER + [{"type": "Strip", "content": " ", "start": 1, "stop": 0}]
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added(enumerate(LLAMA_HEAD)), "normalizer": normalizer,
            "pre_tokenizer": pre, "post_processor": _single_template(["<s>", "$A"], vocab),
            "decoder": {"type": "Sequence", "decoders": decoder},
            "model": _spm_model(vocab, merges)}


def llama_tokenizer_config(spec: dict, pad_token: Optional[str] = "</s>",
                           add_bos_token: bool = True, add_eos_token: bool = False,
                           padding_side: Optional[str] = None,
                           legacy: Optional[bool] = None) -> dict:
    """The tokenizer_config.json `LlamaTokenizerFast.save_pretrained`
    writes beside such a tokenizer.json (class `LlamaTokenizer`, its
    specials, every added token's flags), with `pad_token` (Llama-2
    publishes none; batched embedding needs one), the template's flags,
    and `padding_side` and `legacy` where given."""
    config = {"add_bos_token": add_bos_token, "add_eos_token": add_eos_token,
              "added_tokens_decoder": _added_decoder(spec), "bos_token": "<s>",
              "clean_up_tokenization_spaces": False, "eos_token": "</s>", "extra_special_tokens": {},
              "model_max_length": 1000000000000000019884624838656, "pad_token": pad_token,
              "sp_model_kwargs": {}, "tokenizer_class": "LlamaTokenizer", "unk_token": "<unk>",
              "use_default_system_prompt": False}
    for key, value in (("padding_side", padding_side), ("legacy", legacy)):
        if value is not None:
            config[key] = value
    return config


# Phi-3's added tokens after Llama-2's 32,000 pieces, from id 32,000 (its
# config's vocab_size, 32,064, leaves the rest of the embedding unused);
# the chat markers take the whitespace after them
PHI3_ADDED = ("<|endoftext|>", "<|assistant|>", "<|placeholder1|>", "<|placeholder2|>",
              "<|placeholder3|>", "<|placeholder4|>", "<|system|>", "<|end|>",
              "<|placeholder5|>", "<|placeholder6|>", "<|user|>")


def phi3_tokenizer_json(texts: list, vocab_size: int, seed: int,
                        n_trained: int = 4096) -> dict:
    """`llama_tokenizer_json`'s legacy layout (`vocab_size` pieces) with
    PHI3_ADDED appended as special added tokens from id `vocab_size` on,
    all but `<|endoftext|>` with `rstrip`, outside the model's
    vocabulary, as Phi-3's tokenizer.json holds them (texts that would
    train one of them into the vocabulary raise ValueError: `tokenizers`
    would give it the vocabulary's id)."""
    spec = llama_tokenizer_json(texts, vocab_size, seed, n_trained=n_trained)
    inside = [t for t in PHI3_ADDED if t in spec["model"]["vocab"]]
    if inside:
        raise ValueError(f"the training texts made {inside} pieces of the vocabulary")
    spec["added_tokens"] += [{**tok, "rstrip": tok["content"] != PHI3_ADDED[0]}
                             for tok in _added(enumerate(PHI3_ADDED, vocab_size))]
    return spec


def phi3_tokenizer_config(spec: dict, padding_side: Optional[str] = None) -> dict:
    """`llama_tokenizer_config` for such a tokenizer.json with Phi-3's eos
    and pad, `<|endoftext|>`, and `padding_side` where given."""
    return {**llama_tokenizer_config(spec, pad_token=PHI3_ADDED[0], padding_side=padding_side),
            "eos_token": PHI3_ADDED[0]}


# Gemma's sentencepiece pieces open with these (unk at 3); then its
# special turn markers and, not special, some of its user-defined pieces
GEMMA_HEAD = ("<pad>", "<eos>", "<bos>", "<unk>", "<mask>", "[multimodal]")
GEMMA_TURNS = ("<start_of_turn>", "<end_of_turn>")
GEMMA_USER = ("<table>", "<h1>", "</h1>")


def gemma_tokenizer_json(texts: list, vocab_size: int, seed: int,
                         n_trained: int = 4096) -> dict:
    """A tokenizer.json as transformers' Gemma converter and
    `GemmaTokenizerFast` write it: GEMMA_HEAD (ids 0-5, `<unk>` at 3),
    GEMMA_TURNS (special) and GEMMA_USER (not special), all added tokens
    matched on the raw text; the 256 `<0xNN>` pieces, "\\t" and "\\n" and
    the seeded BPE of `_spm_bpe`, `vocab_size` pieces (262,144 in
    EmbeddingGemma); BPE with byte_fallback and fuse_unk, unk `<unk>`;
    the normalizer Replace(" ", "▁"), the pre-tokenizer Split(" ",
    MergedWithPrevious) and the template `<bos> $A`."""
    head = [*GEMMA_HEAD, *GEMMA_TURNS, *GEMMA_USER]
    vocab, merges = _spm_bpe(head, texts, vocab_size, seed, n_trained, chars="\t\n")
    added = _added(enumerate(head[:len(GEMMA_HEAD) + len(GEMMA_TURNS)]))
    added += [{**tok, "special": False} for tok in _added(
        (vocab[t], t) for t in GEMMA_USER)]
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": SPIECE},
            "pre_tokenizer": {"type": "Split", "pattern": {"String": " "},
                              "behavior": "MergedWithPrevious", "invert": False},
            "post_processor": _single_template(["<bos>", "$A"], vocab),
            "decoder": {"type": "Sequence", "decoders": SPM_DECODER},
            "model": _spm_model(vocab, merges)}


def gemma_tokenizer_config(spec: dict, add_bos_token: bool = True, add_eos_token: bool = False,
                           padding_side: Optional[str] = None) -> dict:
    """The tokenizer_config.json `GemmaTokenizerFast.save_pretrained` writes
    beside such a tokenizer.json (class `GemmaTokenizer`, its specials, the
    turn markers as additional specials, every added token's flags), with
    the template's flags and `padding_side` where given."""
    config = {"add_bos_token": add_bos_token, "add_eos_token": add_eos_token,
              "added_tokens_decoder": _added_decoder(spec),
              "additional_special_tokens": list(GEMMA_TURNS), "bos_token": "<bos>",
              "clean_up_tokenization_spaces": False, "eos_token": "<eos>",
              "extra_special_tokens": {}, "model_max_length": 2048, "pad_token": "<pad>",
              "sp_model_kwargs": {}, "spaces_between_special_tokens": False,
              "tokenizer_class": "GemmaTokenizer", "unk_token": "<unk>",
              "use_default_system_prompt": False}
    if padding_side is not None:
        config["padding_side"] = padding_side
    return config


# all-mpnet-base-v2's first ids (bos, pad, eos, and an unused <unk>: its
# unk_token is BERT's [UNK])
MPNET_HEAD = ("<s>", "<pad>", "</s>", "<unk>")


def mpnet_vocab(wordpiece: list) -> list:
    """MPNet's vocabulary as all-mpnet-base-v2's vocab.txt lays it out:
    `<s> <pad> </s> <unk>` (ids 0-3), an uncased BERT WordPiece
    vocabulary, then `<mask>` last."""
    return [*MPNET_HEAD, *wordpiece, "<mask>"]


def mpnet_tokenizer_config(vocab: list, do_lower_case: bool = True) -> dict:
    """The tokenizer_config.json `MPNetTokenizerFast.save_pretrained`
    writes for `vocab`: its special tokens, and `added_tokens_decoder`
    with their flags (every one matched on the normalized text, `<mask>`
    lstrip)."""
    specials = {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                "cls_token": "<s>", "unk_token": "[UNK]", "pad_token": "<pad>",
                "mask_token": "<mask>"}
    index = {token: i for i, token in enumerate(vocab)}
    decoder = {
        str(index[t]): {"content": t, "lstrip": t == "<mask>", "normalized": True,
                        "rstrip": False, "single_word": False, "special": True}
        for t in dict.fromkeys(specials.values())
    }
    return {"added_tokens_decoder": dict(sorted(decoder.items(), key=lambda kv: int(kv[0]))),
            **specials, "do_lower_case": do_lower_case, "strip_accents": None,
            "tokenize_chinese_chars": True, "model_max_length": 512,
            "tokenizer_class": "MPNetTokenizer"}


# XLM's and FlauBERT's vocab.json open with their specials (pad_index 2,
# unk_index 3); both classes' tokenizer_config.json name them
MOSES_HEAD = ("<s>", "</s>", "<pad>", "<unk>", *(f"<special{i}>" for i in range(10)))
MOSES_PIECE_MAX = 16  # characters of a seeded piece before it grows no more


def moses_training_words(text: str, lang: str = "en", lowercase: bool = True) -> list:
    """A text's Moses tokens as BPE symbol tuples (the last character with
    `</w>`), lowercased and stripped of accents as XLM's flag does."""
    tokens = moses_tokenize(text.lower() if lowercase else text, lang)
    if lowercase:
        tokens = lowercase_and_remove_accent(tokens)
    return [tuple(t[:-1]) + (t[-1] + "</w>",) for t in tokens if t]


def moses_bpe_files(texts: list, vocab_size: int, seed: int, lang: str = "en",
                    lowercase: bool = True, n_trained: int = 4096,
                    counts: bool = False) -> tuple:
    """(vocab.json's dict, merges.txt's text) of a seeded BPE in XLM's
    layout: MOSES_HEAD at ids 0-13, every character of the texts' Moses
    tokens (`moses_training_words`) inside a word and with `</w>`, the
    merges of `train_merges` over those tokens, then seeded merges of a
    piece that ends no word (under MOSES_PIECE_MAX characters) and one
    character, until `vocab_size` entries; merges.txt one pair a line,
    with a count after it where `counts` (as XLM's files carry), ending
    with a newline."""
    vocab = {t: i for i, t in enumerate(MOSES_HEAD)}
    words = [w for text in texts for w in moses_training_words(text, lang, lowercase)]
    chars = sorted({c for w in words for sym in w for c in sym.removesuffix("</w>")})
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for a, b in train_merges(texts, n_trained,
                             to_words=lambda t: moses_training_words(t, lang, lowercase)):
        if a + b not in vocab and len(vocab) < vocab_size:
            vocab[a + b] = len(vocab)
            merges.append((a, b))
    rng = np.random.default_rng(seed)
    inner = [t for t in list(vocab)[len(MOSES_HEAD):] if not t.endswith("</w>")]
    symbols = [t for t in list(vocab)[len(MOSES_HEAD):] if len(t.removesuffix("</w>")) == 1]
    while len(vocab) < vocab_size:
        picks = np.stack([rng.integers(0, len(inner), 4096),
                          rng.integers(0, len(symbols), 4096)], axis=1)
        for i, j in picks.tolist():
            a, b = inner[i], symbols[j]
            if a + b in vocab or len(vocab) >= vocab_size or len(a) >= MOSES_PIECE_MAX:
                continue
            vocab[a + b] = len(vocab)
            merges.append((a, b))
            if not b.endswith("</w>"):
                inner.append(a + b)
    lines = [f"{a} {b} {len(merges) - i}" if counts else f"{a} {b}"
             for i, (a, b) in enumerate(merges)]
    return vocab, "".join(line + "\n" for line in lines)


def moses_tokenizer_config(tokenizer_class: str = "XLMTokenizer", **flags) -> dict:
    """The tokenizer_config.json `XLMTokenizer.save_pretrained` (or
    `FlaubertTokenizer`'s) writes over MOSES_HEAD's ids: the specials and
    `added_tokens_decoder` (no token stripped or normalized), and `flags`
    (`do_lowercase_and_remove_accent`, `do_lowercase`; each class's default
    where not given)."""
    decoder = {str(i): {"content": t, "lstrip": False, "normalized": False, "rstrip": False,
                        "single_word": False, "special": True} for i, t in enumerate(MOSES_HEAD)}
    own = ({"do_lowercase": False} if tokenizer_class == "FlaubertTokenizer"
           else {"do_lowercase_and_remove_accent": True})
    return {"added_tokens_decoder": decoder, "additional_special_tokens": list(MOSES_HEAD[4:]),
            "bos_token": "<s>", "cls_token": "</s>", "id2lang": None, "lang2id": None,
            "mask_token": "<special1>", "pad_token": "<pad>", "sep_token": "</s>",
            "unk_token": "<unk>", **own, **flags, "tokenizer_class": tokenizer_class}

