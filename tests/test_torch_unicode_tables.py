"""Fault 3.11: the port's tokenizers answer with `tokenizers`' own Unicode
tables, not Python's `unicodedata`.

`meilisearch_tpu_torch/models/_unicode_tables.py` is generated by
`tools/unicode_tables.py` from `tokenizers`; models/unicode.py reads it.
Every table (and NFD, NFC, NFKC, NFKD, StripAccents and Lowercase built
on them) is held here against `tokenizers` on every code point from U+0000 to U+10FFFF
(surrogates excepted), in two contexts, each batched into long strings:
alone (code points joined by newlines, which neither compose nor reorder
with anything) and between two letters ("a{c}b").
Then seeded fuzz texts drawn from the code points where Python's tables
and `tokenizers`' differ, combining-mark runs and Hangul go through the
port's WordPiece against `BertTokenizerFast` and its Unigram with `NFKC`
and `Lowercase` against `tokenizers`."""

import ast
import json
import string
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from tokenizers import normalizers, pre_tokenizers  # noqa: E402

from meilisearch_tpu_torch.models import (  # noqa: E402
    _unicode_tables,
    bpe,
    unicode,
    unigram,
    wordpiece,
)
from meilisearch_tpu_torch.models.wordpiece import WordPiece  # noqa: E402

MODELS = Path(wordpiece.__file__).parent
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CHUNK = 1 << 15


def _contexts(sep: str = "\n"):
    """(alone, between two letters) strings over every code point, in
    chunks; alone: the code points joined by `sep`."""
    for i in range(0, len(CODE_POINTS), CHUNK):
        chars = [chr(c) for c in CODE_POINTS[i:i + CHUNK]]
        yield sep.join(chars)
        yield "".join(f"a{c}b" for c in chars)


def _first_difference(got, want) -> str:
    i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w), min(len(got), len(want)))
    return f"at {i}: port {got[i:i + 3]!r}, tokenizers {want[i:i + 3]!r}"


def test_the_tables_name_their_source():
    assert _unicode_tables.SOURCE == f"tokenizers {tokenizers.__version__}"


def test_the_host_unicode_version_is_the_checked_one():
    """models/unigram.py's grapheme walk still reads `unicodedata`'s
    categories; it was held against `tokenizers` under this version."""
    assert unicodedata.unidata_version == _unicode_tables.CHECKED_UNIDATA


def test_bert_normalizer_on_every_code_point():
    """BertNormalizer's control, whitespace and CJK classes, NFD with the
    non-spacing marks dropped, and Lowercase (bge's defaults)."""
    ref = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                     strip_accents=None, lowercase=True)
    port = WordPiece(["[PAD]", "[UNK]", "[CLS]", "[SEP]"], do_lower_case=True)
    for text in _contexts():
        got, want = port._normalize(text), ref.normalize_str(text)
        assert got == want, _first_difference(got, want)


def test_bert_pre_tokenizer_on_every_code_point():
    """BertPreTokenizer's punctuation and whitespace classes."""
    ref = pre_tokenizers.BertPreTokenizer()
    rx = wordpiece._words_pattern()
    for text in _contexts():
        got, want = rx.findall(text), [w for w, _ in ref.pre_tokenize_str(text)]
        assert got == want, _first_difference(got, want)


@pytest.mark.parametrize("form", ["NFD", "NFC", "NFKC", "Lowercase", "NFKD", "StripAccents"])
def test_normalization_forms_on_every_code_point(form):
    """NFC is ModernBERT's BPE normalizer (models/bpe.py); NFKD and
    StripAccents are ALBERT's and RemBERT's (models/unigram.py)."""
    ref = getattr(normalizers, form)()
    port = {"NFD": unicode.nfd, "NFC": unicode.nfc, "NFKC": unicode.nfkc,
            "Lowercase": unicode.lowercase, "NFKD": unicode.nfkd,
            "StripAccents": unicode.strip_accents}[form]
    for text in _contexts():
        got, want = port(text), ref.normalize_str(text)
        assert got == want, _first_difference(got, want)


def test_byte_level_classes_on_every_code_point():
    """The ByteLevel split regex's \\p{L}, \\p{N} and \\s, through GPT-2's
    pattern over every code point: alone, each class of the port's tables
    as one run (a code point `tokenizers` puts in another class cuts it),
    and every code point between two letters."""
    ref = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    classes = [unicode.ranges(f"BYTE_LEVEL_{c}") for c in ("LETTER", "NUMBER", "SPACE")]
    runs = [[], [], [], []]
    for cp in CODE_POINTS:
        runs[next((i for i, r in enumerate(classes) if cp in r), 3)].append(chr(cp))
    texts = ["".join(run[i:i + CHUNK]) for run in runs for i in range(0, len(run), CHUNK)]
    texts += [t for i, t in enumerate(_contexts()) if i % 2]
    for text in texts:
        got, want = bpe.byte_level_words(text), [w for w, _ in ref.pre_tokenize_str(text)]
        assert got == want, _first_difference(got, want)


# -- seeded fuzz -----------------------------------------------------------------


def _differing() -> list:
    """Code points where Python's tables answer otherwise than `tokenizers`':
    punctuation, control, non-spacing marks, lowercase and NFKC."""
    punct, control = unicode.ranges("BERT_PUNCT"), unicode.ranges("BERT_CONTROL")
    marks = unicode.ranges("NONSPACING_MARK")
    alone = "\n".join(map(chr, CODE_POINTS))
    nfkc = unicode.nfkc(alone).split("\n")
    py_nfkc = unicodedata.normalize("NFKC", alone).split("\n")
    lower = unicode.lowercase(alone).split("\n")
    out = []
    for cp, k, py_k, low in zip(CODE_POINTS, nfkc, py_nfkc, lower):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        if (k != py_k or ch.lower() != low
                or cat[0] in "PCM" and (cat[0] == "P" and cp > 127) != (cp in punct)
                or cat[0] == "C" and (cat != "Cn") != (cp in control) and not ch.isspace()
                or cat[0] == "M" and (cat == "Mn") != (cp in marks) and ch == unicode.nfd(ch)):
            out.append(ch)
    return out


@pytest.fixture(scope="module")
def fuzz_texts():
    rng = np.random.default_rng(311)
    differing = _differing()
    assert len(differing) > 300
    marks = sorted(unicode.tables().ccc)
    hangul = ([chr(c) for c in range(0xAC00, 0xD7A4, 37)] + [chr(c) for c in range(0x1100, 0x1113)]
              + [chr(c) for c in range(0x1161, 0x1176)] + [chr(c) for c in range(0x11A8, 0x11C3)])
    words = ["search", "Engine", "café", "ΣΑΣ", "İstanbul", "naïve", "中文", "a⹃b", "x", "q"]

    def draw(pool, k):
        return "".join(pool[i] for i in rng.integers(0, len(pool), k))

    texts = []
    for _ in range(400):
        parts = []
        for _ in range(int(rng.integers(1, 8))):
            kind = rng.integers(0, 4)
            if kind == 0:
                parts.append(draw(differing, int(rng.integers(1, 4))))
            elif kind == 1:
                parts.append(draw(string.ascii_letters, 1) + draw(marks, int(rng.integers(1, 5))))
            elif kind == 2:
                parts.append(draw(hangul, int(rng.integers(1, 5))))
            else:
                parts.append(words[int(rng.integers(0, len(words)))])
        texts.append(("" if rng.random() < 0.3 else " ").join(parts))
    return texts


def _wordpiece_vocab(texts: list) -> list:
    """Specials, every character of the texts' words alone and as a
    continuation, and every third word whole."""
    norm = normalizers.BertNormalizer(lowercase=True)
    split = pre_tokenizers.BertPreTokenizer()
    words = [w for t in texts for w, _ in split.pre_tokenize_str(norm.normalize_str(t))]
    chars = sorted({c for w in words for c in w})
    return list(dict.fromkeys(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *chars,
                               *("##" + c for c in chars), *words[::3]]))


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_fuzz_matches_bert_tokenizer_fast(fuzz_texts, lower, tmp_path):
    vocab = _wordpiece_vocab(fuzz_texts)
    (tmp_path / "vocab.txt").write_text("".join(f"{t}\n" for t in vocab), encoding="utf-8")
    ref = transformers.BertTokenizerFast(str(tmp_path / "vocab.txt"), do_lower_case=lower)
    want = ref(fuzz_texts, padding=True, truncation=True, max_length=512)
    ids, mask = WordPiece(vocab, do_lower_case=lower)(fuzz_texts, 512)
    assert ids.tolist() == want["input_ids"]
    assert mask.tolist() == want["attention_mask"]


def test_a_u2e43_b_is_one_unknown_word(tmp_path):
    """U+2E43 is punctuation to Python's Unicode 15.0 but not to
    `tokenizers`: "a⹃b" is one word, [CLS] [UNK] [SEP], not a [UNK] b."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "b", "##a", "##b"]
    (tmp_path / "vocab.txt").write_text("".join(f"{t}\n" for t in vocab), encoding="utf-8")
    want = transformers.BertTokenizerFast(str(tmp_path / "vocab.txt"))(["a⹃b"])["input_ids"]
    assert want == [[2, 1, 3]]
    assert WordPiece(vocab)(["a⹃b"])[0].tolist() == want


def test_unigram_nfkc_and_lowercase_fuzz_match_tokenizers(fuzz_texts):
    normalized = [normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase()])
                  .normalize_str(t) for t in fuzz_texts]
    chars = sorted({c for t in normalized for c in t.replace(" ", "")})
    rng = np.random.default_rng(7)
    pieces = [["▁" + c, -5.0] for c in chars] + [[c, float(-rng.uniform(6, 12))] for c in chars]
    words = sorted({w for t in normalized for w in t.split()})
    pieces += [["▁" + w, -2.0] for w in words[::4]]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])],
        "normalizer": {"type": "Sequence", "normalizers": [{"type": "NFKC"},
                                                           {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0],
                           "trim_offsets": True, "add_prefix_space": True},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": 3, "byte_fallback": False,
                  "vocab": [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
                  + pieces},
    }
    ref = tokenizers.Tokenizer.from_str(json.dumps(spec))
    want = [e.ids for e in ref.encode_batch(fuzz_texts)]
    port = unigram.Unigram(spec)
    assert [[0, *port.ids(t), 2] for t in fuzz_texts] == want


class _Refuses:
    def __getattr__(self, name):
        raise AssertionError(f"unicodedata.{name} was asked")


def test_wordpiece_and_bpe_answer_without_unicodedata(monkeypatch, fuzz_texts):
    """No module of the word-piece and byte-level paths imports
    `unicodedata`, and both tokenize non-ASCII texts with it replaced by an
    object that raises on any use."""
    for name in ("wordpiece.py", "bpe.py", "unicode.py", "_unicode_tables.py"):
        tree = ast.parse((MODELS / name).read_text(encoding="utf-8"))
        imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                    for a in node.names}
        imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
        assert "unicodedata" not in imported, name
    vocab = _wordpiece_vocab(fuzz_texts)
    want_wp = WordPiece(vocab)(fuzz_texts, 512)[0].tolist()
    want_bl = [bpe.byte_level_words(t) for t in fuzz_texts]
    for module in (wordpiece, bpe, unicode):
        monkeypatch.setattr(module, "unicodedata", _Refuses(), raising=False)
    monkeypatch.setitem(sys.modules, "unicodedata", _Refuses())
    unicode.tables.cache_clear()
    unicode.ranges.cache_clear()
    wordpiece._words_pattern.cache_clear()
    bpe.split_pattern.cache_clear()
    try:
        assert WordPiece(vocab)(fuzz_texts, 512)[0].tolist() == want_wp
        assert [bpe.byte_level_words(t) for t in fuzz_texts] == want_bl
    finally:
        unicode.tables.cache_clear()
        unicode.ranges.cache_clear()
        wordpiece._words_pattern.cache_clear()
        bpe.split_pattern.cache_clear()
