"""BLOOM's Split pre-tokenizer on every code point (models/bpe.py).

BLOOM's tokenizer.json cuts text with `Split(Regex(" ?[^(\\s|[.,!?…。，、।۔،])]+"),
Isolated)` before a ByteLevel without its own regex. The pattern nests a
class inside a negated class: Oniguruma, `tokenizers`' engine, reads the
nesting as a union, so the pattern matches an optional space and then a
run of characters that are none of `\\s`, `(`, `|`, `)` and the marks;
Python's `re` cannot parse it at all. The port builds one flat negated
class over models/unicode.py's `\\s` table (`bpe.split_pattern`) and keeps
the runs its matches leave between them (`! (` in `world! (a`) as pieces
of their own, as Isolated does (`bpe.isolated`).

Held here against `tokenizers.pre_tokenizers.Split` on every code point
(alone, between two letters, and after a space, where ` ?` decides), and
the whole tokenizer, a seeded BPE in BLOOM's layout
(`fixtures.bloom_tokenizer_json`), against AutoTokenizer's
`BloomTokenizerFast` ids on every code point."""

import json
import os
import re

import pytest

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from meilisearch_tpu_torch.models import bpe, fixtures  # noqa: E402

CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CHUNK = 1 << 15
CORPUS = ["Hello, world! (a|b) x.y 你好。ok", "it's we'll DON'T café naïve",
          "search engine for the cloud… really? yes! no.",
          "中文，日本語、हिन्दी। اردو۔ عربي،"] * 20


def _split_ref():
    return tokenizers.pre_tokenizers.Split(tokenizers.Regex(bpe.BLOOM_SPLIT),
                                           behavior="isolated", invert=False)


def _code_point_texts():
    """Every code point alone (joined by newlines), between two letters,
    and after a space before a letter."""
    for i in range(0, len(CODE_POINTS), CHUNK):
        chars = [chr(c) for c in CODE_POINTS[i:i + CHUNK]]
        yield "\n".join(chars)
        yield "".join(f"a{c}b" for c in chars)
        yield "".join(f" {c}x" for c in chars)


def test_the_split_matches_tokenizers_on_every_code_point():
    ref, port = _split_ref(), bpe.split_pattern(bpe.BLOOM_SPLIT)
    for text in _code_point_texts():
        got, want = bpe.isolated(port, text), [w for w, _ in ref.pre_tokenize_str(text)]
        if got != want:
            i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"piece {i}: port {got[i:i + 3]!r}, tokenizers {want[i:i + 3]!r}")


def test_the_runs_between_matches_are_pieces():
    """`! (` lies between two matches and is one piece; the marks, the
    brackets and `|` stand alone; a space goes with the word after it."""
    text = "Hello, world! (a|b) x.y 你好。ok"
    want = ["Hello", ",", " world", "! (", "a", "|", "b", ")", " x", ".", "y", " 你好", "。",
            "ok"]
    assert [w for w, _ in _split_ref().pre_tokenize_str(text)] == want
    assert bpe.isolated(bpe.split_pattern(bpe.BLOOM_SPLIT), text) == want
    assert bpe.split_pattern(bpe.BLOOM_SPLIT).findall(text) != want  # the runs are needed


def test_pythons_re_cannot_read_the_published_pattern():
    """Mutation guard: handed to `re` as the file writes it, the nested
    class closes early and the pattern does not compile; the port never
    compiles the file's string."""
    with pytest.raises(re.error, match="unbalanced parenthesis"):
        re.compile(bpe.BLOOM_SPLIT)
    assert bpe.split_pattern(bpe.BLOOM_SPLIT).pattern != bpe.BLOOM_SPLIT


@pytest.fixture(scope="module")
def bloom_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("bloom_tok")
    spec = fixtures.bloom_tokenizer_json(CORPUS, 1500, seed=6)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.bloom_tokenizer_config(spec), f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bloom", "vocab_size": 1500}, f)
    return str(path), spec


def test_the_tokenizer_gives_autotokenizers_ids_on_every_code_point(bloom_dir):
    """BloomTokenizerFast's ids, every code point in the split's three
    contexts, text by text (no template, no truncation)."""
    path, spec = bloom_dir
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == "BloomTokenizerFast"
    port = bpe.BPE(spec, fixtures.bloom_tokenizer_config(spec), "bloom")
    for text in _code_point_texts():
        got = port.ids(text)
        want = ref(text, add_special_tokens=True)["input_ids"]
        if got != want:
            i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                     min(len(got), len(want)))
            raise AssertionError(f"id {i}: port {got[i:i + 4]}, AutoTokenizer {want[i:i + 4]}")
