"""The port's SentencePiece-Unigram tokenizer (`models/unigram.py`) against
`AutoTokenizer` and the `tokenizers` library, id for id.

Nothing is downloaded. A seeded vocabulary of pieces (Latin with accents,
Cyrillic, CJK, Arabic, pieces tied in score) and a precompiled charsmap
(NFKC's mappings of the test's characters, multi-character keys, keys that
map to nothing) are written as a `tokenizer.json` the way transformers'
XLM-RoBERTa converter writes it, beside a `tokenizer_config.json`; the
reference is `AutoTokenizer.from_pretrained` on that directory, called as
the JAX package's encoder calls it. Variants of the file cover each
Metaspace prepend scheme (and the legacy `add_prefix_space`), `split:
false`, `RobertaProcessing` and the other normalizers. `Precompiled` is
also held alone against `tokenizers.normalizers.Precompiled` on charsmaps
built here, with seeded random strings of the characters that make
grapheme clusters (combining marks, ZWJ sequences, Hangul jamo, regional
indicators, CR LF, prepend and spacing marks)."""

import copy
import json
import os
import unicodedata

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from meilisearch_tpu_torch.models.fixtures import (  # noqa: E402
    build_charsmap,
    xlmr_tokenizer_json,
)
from meilisearch_tpu_torch.models.unigram import Precompiled, Unigram, graphemes  # noqa: E402

LATIN = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-()éèêëàâäôöûüùçñß"
CYRILLIC = "абвгдежзийклмнопрстуфхцчшщъыьэюя"
CJK = "中文字日本語検索引擎数据库東京"
ARABIC = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"
WORDS = [
    "hello", "world", "search", "engine", "café", "naïve", "résumé", "über", "straße",
    "привет", "мир", "поиск", "база", "данных", "中文", "日本語", "検索", "数据库",
    "مرحبا", "بحث", "the", "of", "and", "data", "base", "database", "learn", "ing",
    "un", "able", "unable", "new", "york", "newyork",
]
TEXTS = [
    "Hello world",
    "Café naïve résumé — déjà vu",
    "Привет, мир! Поиск в базе данных.",
    "中文字 search中文 日本語の検索",
    "مرحبا بالعالم بحث",
    "été café Ａｂｃ ﬁne ½ ①",
    "   leading and trailing spaces   ",
    "runs    of     spaces\tand\ttabs\nnew\r\nlines",
    "unknown ✈ glyphs 🚀🚀 and 𝔘𝔫𝔦 zzz͸",
    "",
    " ",
    "unable newyork database",
    "ZWJ 👨‍👩‍👧 skin 👍🏽 flags 🇫🇷🇩🇪🇮",
    "jamo 각 가 각 한국어",
    "marks aःb ؀x q́̈ ©‍© กำ",
    "specials <s> inside </s> and <mask> here<mask> <pad>",
    "x" * 40 + " " + "straße " * 30,
    "MiXeD CaSe İstanbul ΣΑΣ",
    "zero​width﻿bom­soft",
    "a",
    "tie tie tietie",
]


def _pieces(seed: int = 7) -> list:
    """(piece, score): every character of the scripts alone and after ▁,
    the words and their halves after ▁; scores seeded, a few tied."""
    rng = np.random.default_rng(seed)
    pieces = ["▁"] + list(dict.fromkeys(LATIN + CYRILLIC + CJK + ARABIC))
    pieces += ["▁" + c for c in LATIN + CYRILLIC + CJK + ARABIC]
    for w in WORDS:
        pieces += ["▁" + w, w, w[: len(w) // 2], w[len(w) // 2:], "▁" + w[: len(w) // 2]]
    pieces = list(dict.fromkeys(pieces))
    scores = {p: float(-rng.uniform(1.0, 12.0)) for p in pieces}
    # ties: "tietie" splits as tie+tie or ti+etie, both at -8.0
    for p, s in (("▁tie", -4.0), ("tie", -4.0), ("▁ti", -2.0), ("etie", -6.0),
                 ("▁tietie", -8.0)):
        scores[p] = s
    return list(scores.items())


def _charsmap() -> bytes:
    """NFKC's mappings of the test characters, a composition of a
    two-character cluster, a key to nothing, and a key that is a prefix
    of a longer cluster."""
    chars = set("".join(TEXTS) + "ＡＢＣａｂｃﬁﬂ½①²™")
    mapping = {c: unicodedata.normalize("NFKC", c) for c in chars
               if unicodedata.normalize("NFKC", c) != c}
    mapping.update({"é": "é", "​": "", "﻿": "", "\r": " ",
                    "͸": "?", "©": "(c)"})
    return build_charsmap(mapping)


SPEC = xlmr_tokenizer_json(_pieces(), _charsmap())
CONFIG = {"tokenizer_class": "XLMRobertaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
          "unk_token": "<unk>", "sep_token": "</s>", "cls_token": "<s>",
          "pad_token": {"__type": "AddedToken", "content": "<pad>", "lstrip": False,
                        "normalized": False, "rstrip": False, "single_word": False},
          "mask_token": "<mask>"}


def _write(path, spec, config=CONFIG) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return str(path)


def _read(path) -> Unigram:
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        return Unigram(json.load(f), CONFIG)


def _compare(path, texts, max_len=512):
    ref = transformers.AutoTokenizer.from_pretrained(path)
    want = ref(texts, padding=True, truncation=True, max_length=max_len)
    ids, mask = _read(path)(texts, max_len)
    assert ids.tolist() == want["input_ids"], [t for t, a, b in zip(
        texts, ids.tolist(), want["input_ids"]) if a != b]
    assert mask.tolist() == want["attention_mask"]
    return ids


@pytest.fixture(scope="module")
def xlmr_dir(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("xlmr"), SPEC)


@pytest.mark.parametrize("case", range(len(TEXTS)))
def test_each_text_matches_autotokenizer(xlmr_dir, case):
    ids = _compare(xlmr_dir, [TEXTS[case]])
    assert ids[0, 0] == 0 and ids[0, -1] == 2


def test_the_reference_is_the_fast_xlmr_tokenizer(xlmr_dir):
    ref = transformers.AutoTokenizer.from_pretrained(xlmr_dir)
    assert type(ref).__name__ == "XLMRobertaTokenizerFast"
    # the vocabulary is reached: unknowns fuse, known words are one piece
    tok = _read(xlmr_dir)
    ids = tok.ids("zzz ✈✈")
    assert ids == ref("zzz ✈✈", add_special_tokens=False)["input_ids"]
    assert ids[-2:] == [tok.pieces["▁"], 3]  # the two unknown characters: one <unk>


def test_tied_paths_keep_the_first_found(xlmr_dir):
    """tie+tie and ti+etie both score -8.0; so does the single piece."""
    tok = _read(xlmr_dir)
    ids = tok.ids("tietie")
    ref = transformers.AutoTokenizer.from_pretrained(xlmr_dir)
    assert ids == ref("tietie", add_special_tokens=False)["input_ids"]
    assert [tok.scores[i] for i in ids] and sum(tok.scores[i] for i in ids) == -8.0


@pytest.mark.parametrize("max_len", [512, 9, 3])
def test_a_padded_and_truncated_batch(xlmr_dir, max_len):
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice(WORDS, size=n)) for n in (0, 3, 40, 300)] + TEXTS[:6]
    _compare(xlmr_dir, texts, max_len)


def _variant(tmp_path, name, change):
    spec = copy.deepcopy(SPEC)
    change(spec)
    return _write(tmp_path / name, spec)


PRE_TOKENIZERS = {
    "first": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    "never": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": True},
    "legacy": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
    "legacy_never": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False,
                     "prepend_scheme": "never"},
    "no_split": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": False},
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZERS))
def test_metaspace_schemes(tmp_path, name):
    def change(spec):
        spec["pre_tokenizer"] = PRE_TOKENIZERS[name]

    path = _variant(tmp_path, name, change)
    _compare(path, TEXTS + ["<s>hello world", "hello<s>world </s>  x", "<mask>a"])


def test_a_false_legacy_prefix_space_beside_another_scheme_is_refused():
    spec = copy.deepcopy(SPEC)
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False}
    with pytest.raises(Exception, match="add_prefix_space"):
        tokenizers.Tokenizer.from_str(json.dumps(spec))
    with pytest.raises(ValueError, match="add_prefix_space"):
        Unigram(spec, CONFIG)


NORMALIZERS = {
    "precompiled_alone": lambda s: [s[0]],
    "nfkc_lowercase_nmt": lambda s: [{"type": "Nmt"}, {"type": "NFKC"}, {"type": "Lowercase"},
                                     {"type": "Strip", "strip_left": True, "strip_right": True}],
    "replace_string": lambda s: s + [{"type": "Replace", "pattern": {"String": "ab"},
                                      "content": "▁ba"}],
    "none": None,
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizers(tmp_path, name):
    def change(spec):
        make = NORMALIZERS[name]
        spec["normalizer"] = None if make is None else {
            "type": "Sequence", "normalizers": make(spec["normalizer"]["normalizers"])}

    _compare(_variant(tmp_path, name, change), TEXTS + ["abab cab \x01\x7f x▁y"])


def test_roberta_processing(tmp_path):
    def change(spec):
        spec["post_processor"] = {"type": "RobertaProcessing", "sep": ["</s>", 2],
                                  "cls": ["<s>", 0], "trim_offsets": True,
                                  "add_prefix_space": True}

    _compare(_variant(tmp_path, "roberta", change), TEXTS, max_len=7)


@pytest.mark.parametrize("change, match", [
    (lambda s: s["model"].update(type="BPE"), "BPE"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s.update(pre_tokenizer={"type": "ByteLevel"}), "ByteLevel"),
    (lambda s: s.update(normalizer={"type": "BertNormalizer"}), "BertNormalizer"),
    (lambda s: s.update(post_processor={"type": "ByteLevel"}), "ByteLevel"),
])
def test_other_tokenizers_are_refused(change, match):
    spec = copy.deepcopy(SPEC)
    change(spec)
    with pytest.raises(ValueError, match=match):
        Unigram(spec, CONFIG)


# -- Precompiled alone ----------------------------------------------------------

# characters that make clusters, and plain ones
POOL = list("ae©®\r\n\x07 ") + [
    "́", "̈", "‍", "‌", "\U0001F3FB", "\U0001F600", "\U0001F1E6",
    "\U0001F1E7", "ᄀ", "ᅡ", "ᆨ", "가", "각", "؀", "ः", "ါ",
    "ำ", "­", "️", "Ａ", "ﬁ", "क", "्", "\U000E0041", "⁥", "ﾞ",
    "ְ", "ก", "​", "\x85", "ß", "⃝",
]


def test_precompiled_matches_tokenizers_on_named_cases():
    blob = build_charsmap({"a": "A", "é": "E", "é": "É", "‍": "", "©": "(c)",
                           "Ａ": "A", "ﬁ": "fi", "\r": " ", "ab": "X", "́̈": "2"})
    ref, mine = tokenizers.normalizers.Precompiled(blob), Precompiled(blob)
    cases = ["ab", "cab", "é", "é", "á", "ﬁ́", "\r\n", "©‍©",
             "©‍", "Ａ\U0001F3FBb", "q́̈", "각", "👍🏽",
             "🇫🇷🇩", "xः", "؀a", "plain text", ""]
    for s in cases:
        assert mine(s) == ref.normalize_str(s), s
    assert mine("ﬁ́") == "fi"  # the shortest key's string replaces the cluster
    assert mine("é") == "E" and mine("é") == "É"


def test_graphemes_of_named_sequences():
    assert graphemes("\r\n\r") == ["\r\n", "\r"]
    assert graphemes("é̈x") == ["é̈", "x"]
    assert graphemes("👨‍👩‍👧!") == ["👨‍👩‍👧", "!"]
    assert graphemes("각ᄀ") == ["각", "ᄀ"]
    assert graphemes("🇫🇷🇩🇪🇮") == ["🇫🇷", "🇩🇪", "🇮"]
    assert graphemes("\x07́") == ["\x07", "́"]
    assert graphemes("؀ab") == ["؀a", "b"]


@pytest.mark.parametrize("seed", range(6))
def test_precompiled_fuzz(seed):
    """Seeded random strings of POOL against tokenizers' Precompiled:
    seed 0 maps every character of the pool (so every cluster under 6
    bytes shows its boundary), the others a random half with values that
    are empty, longer or shorter, and a few multi-character keys."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        keys = {c: f"<{ord(c):x}>" for c in POOL}
    else:
        keys = {c: str(rng.choice(["", "X", "yz", c + c])) for c in POOL if rng.random() < 0.5}
        for _ in range(10):
            keys["".join(rng.choice(POOL, size=int(rng.integers(2, 4))))] = "{multi}"
    blob = build_charsmap(keys)
    ref, mine = tokenizers.normalizers.Precompiled(blob), Precompiled(blob)
    for _ in range(3000):
        s = "".join(rng.choice(POOL, size=int(rng.integers(1, 10))))
        assert mine(s) == ref.normalize_str(s), (s, keys)


def test_the_ascii_table_matches_the_walk():
    """An ASCII text without CR goes through one translate table; it must
    give what the grapheme walk and tokenizers give, multi-character keys,
    empty values and the other control characters included."""
    rng = np.random.default_rng(7)
    ascii_pool = list("abcxyz .,\t\n\x07\x7f")
    blob = build_charsmap({"a": "A", "x": "", "\t": " ", "\x07": "", "ab": "X",
                           "yz": "{yz}", " ": "  "})
    ref, mine = tokenizers.normalizers.Precompiled(blob), Precompiled(blob)
    for _ in range(2000):
        s = "".join(rng.choice(ascii_pool, size=int(rng.integers(0, 12))))
        assert mine(s) == mine.walk(s) == ref.normalize_str(s), s


def test_precompiled_blob_layout():
    blob = build_charsmap({"x": "yy"})
    (trie_bytes,) = np.frombuffer(blob[:4], "<u4")
    assert trie_bytes % (4 * 256) == 0 and blob.endswith(b"yy\0")
    assert Precompiled(blob)("axb") == "ayyb"
    with pytest.raises(ValueError):
        Precompiled(b"\x08\x00")


def test_the_word_cache_is_exact(xlmr_dir):
    tok = _read(xlmr_dir)
    first = tok(TEXTS)[0]
    assert tok._words  # words were cached
    assert tok(TEXTS)[0].tolist() == first.tolist()
    tok._words.clear()
    assert tok(TEXTS)[0].tolist() == first.tolist()
