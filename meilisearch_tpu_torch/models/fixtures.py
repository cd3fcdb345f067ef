"""Writers of the files the port's tokenizers read, for tests and smoke
runs that build their own checkpoints (nothing is downloaded):
`build_charsmap` compiles a `Precompiled` character map,
`xlmr_tokenizer_json` lays out a `tokenizer.json` as transformers'
XLM-RoBERTa converter writes it, `roberta_tokenizer_json` a seeded
byte-level BPE one as its RoBERTa converter writes it,
`modernbert_tokenizer_json` and `modernbert_tokenizer_config` a seeded one
in ModernBERT's layout and the config published beside it, and `mpnet_vocab`
and `mpnet_tokenizer_config` an MPNet WordPiece vocabulary and the
tokenizer_config.json `MPNetTokenizerFast.save_pretrained` writes beside
it. No serving path calls them.
"""

from __future__ import annotations

import base64
import struct
from collections import Counter
from typing import Optional

import numpy as np

from .bpe import byte_level_words, bytes_to_unicode
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


def train_merges(texts: list, n_merges: int) -> list:
    """A small BPE trainer: up to `n_merges` merges over the ByteLevel words
    of `texts`, each time the adjacent pair most frequent over the words
    (on a tie, the smallest pair), until no pair occurs twice."""
    words = Counter()
    for text in texts:
        words.update(byte_level_words(text))
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
                n_trained: int) -> list:
    """Add to `vocab` (`head` specials, then the 256 byte symbols) the
    merges of `train_merges` over `texts`, then seeded merges of two
    existing tokens (not specials) into a new one, until it holds `size`
    tokens; returns the merges."""
    merges = []
    for a, b in train_merges(texts, n_trained):
        if a + b not in vocab and len(vocab) < size:
            vocab[a + b] = len(vocab)
            merges.append([a, b])
    rng = np.random.default_rng(seed)
    tokens = list(vocab)[head:]
    while len(vocab) < size:
        for i, j in rng.integers(0, len(tokens), (4096, 2)).tolist():
            a, b = tokens[i], tokens[j]
            if a + b in vocab or len(vocab) >= size:
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


# ModernBERT's vocabulary extends GPT-NeoX's: two specials first, its
# byte-level BPE, then (from id 50254) non-special added tokens: runs of
# 24 down to 2 spaces and the placeholders of scrubbed personal data; then
# ModernBERT's specials from id 50280 ([MASK] lstrip) and [unused] slots
# up to its 50,368 entries
MODERNBERT_HEAD = ("<|endoftext|>", "<|padding|>")
MODERNBERT_ADDED = (*(" " * n for n in range(24, 1, -1)), "|||IP_ADDRESS|||",
                    "|||EMAIL_ADDRESS|||", "|||PHONE_NUMBER|||")
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
    decoder = {str(tok["id"]): {k: tok[k] for k in ("content", "lstrip", "normalized", "rstrip",
                                                     "single_word", "special")}
               for tok in spec["added_tokens"]}
    return {"added_tokens_decoder": decoder, "clean_up_tokenization_spaces": True,
            "cls_token": "[CLS]", "mask_token": "[MASK]", "pad_token": "[PAD]",
            "sep_token": "[SEP]", "unk_token": "[UNK]",
            "model_input_names": ["input_ids", "attention_mask"], "model_max_length": 8192,
            "tokenizer_class": "PreTrainedTokenizerFast"}


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
