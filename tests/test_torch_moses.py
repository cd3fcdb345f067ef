"""The port's Moses (models/moses.py over the frozen models/_moses_tables.py)
against sacremoses 0.1.1 and transformers' copies of Moses' scripts, as
XLMTokenizer and FlaubertTokenizer run them.

`meilisearch_tpu_torch/models/_moses_tables.py` is generated by
`tools/moses_tables.py` from sacremoses. Each character class is held
here against sacremoses on every code point from U+0000 to U+10FFFF, both
as a set and as the regular-expression class sacremoses compiles from it;
each prefix list line for line. Then `replace_unicode_punct`,
`remove_non_printing_char`, `MosesPunctNormalizer(lang)` and
`MosesTokenizer(lang).tokenize(..., escape=False)` are held against the
reference, for "en" and "fr", on curated cases (each rule the pipeline
names) and on hypothesis strings over letters, digits, every character
the rules name, control characters, CJK and combining marks."""

import re
from importlib.metadata import version

import pytest

sacremoses = pytest.importorskip("sacremoses")
transformers = pytest.importorskip("transformers")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from sacremoses.corpus import NonbreakingPrefixes  # noqa: E402
from transformers.models.xlm import tokenization_xlm  # noqa: E402

from meilisearch_tpu_torch.models import _moses_tables, moses  # noqa: E402
from meilisearch_tpu_torch.models.unicode import Ranges  # noqa: E402

CLASSES = ("IsN", "IsAlnum", "IsSc", "IsSo", "IsAlpha", "IsLower")
LANGS = ("en", "fr")
EVERY_CODE_POINT = "".join(map(chr, range(0x110000)))
# each rule of the pipeline, and the texts the encoder meets
CASES = [
    "", "   ", "Hello, World. Café", "hello, world. café", "Mr. Smith went to Washington.",
    "mr. smith", "hello\nworld", "tab\there\r\nand\x0bthere", "« bonjour » et « salut »",
    "l'homme aujourd'hui, c'est qu'il", "No. 5 and No. 12, Art. 3, pp. 7", "No. five", "1,000.5",
    "5,300 and A,B,C,D,E and 3,", "wait... what.... ok. . .", "x...y", "Say <special1> and </s>",
    "It's don't we'll they're I've I'd 90's 'tis 'twas cannot gimme gonna gotta lemme wanna",
    "'quoted' \"double\" ``penn'' `single'", "U.S.A. is big. Dr. Who? Prof. X!", "e.g. i.e. etc.",
    "a--b -- c - d", "(paren) [square] {curly} <angle>", "@user #tag $5 %20 &amp; 100 %",
    "„German“ — em – en ‘single’ ’tis ´acute´´", "ｆｕｌｌ，ｗｉｄｔｈ：？！（）０１２３。  next",
    "“quoted”，【bracket】〈angle〉～━…", "5 000 km : x nº 1 20 ºC 3 cm",
    "a ? b ! c ; d, e %", 'He said "yes," then "no."',
    'Il a dit ,"oui" puis "non". Fin', "ΣΑΣ ΟΔΟΣ. Straße İstanbul ǅ", "中文 search 中文。日本語",
    "नमस्ते दुनिया", "été café", "​﻿\x00\x07zero width",
    "Art. 5", "art. 5", "No.5", "The end.'", "The end. '", "Ph.D. M.Sc.", "a/b and/or c\\d",
    "3.14 and 2,5 and -7 and +8 = 9", "x'y x'1 1'x 1's 's", "« Ça va ? » « Oui ! »",
    # the period rule: the token after (lowercase, titlecase, uppercase,
    # digit, none), a prefix with a period and a letter, numeric-only ones
    "x. é", "x. É", "x. ǅ", "x. ſ", "x. 1", "x.", "a.b. C", "1.2. C", "A. B", "pp. 5",
    "pp. x", "Art. C", "Nr. 5", "No. Five", "M. Dupont", "Mme. Curie", "av. J.-C.",
]
ALPHABET = (
    "aAzZéÉçÇœŒßſΣσİı0123456789   　\n\t\r\x00\x07\x1f\x7f\x85"
    ".,;:!?'\"`-_/\\|()[]{}<>@#$%&*+=~^"
    "«»„“”–—´‘’‚…，。、∶：？《》）！（；０１２３４５６７８９．～━〈〉【】％ºn"
    "中文日本語한국्்́̈​﻿\U0001F680"
)
WORDS = ("Mr", "mr", "No", "Art", "pp", "Dr", "U.S", "cm", "ºC", "l'homme", "aujourd'hui",
         "<special1>", "...", "1,000", "n't", "'s", "'ll", "cannot", "'tis")


def _reference(text: str, lang: str) -> list:
    normalizer = sacremoses.MosesPunctNormalizer(lang=lang)
    text = tokenization_xlm.replace_unicode_punct(text)
    text = tokenization_xlm.remove_non_printing_char(normalizer.normalize(text))
    return sacremoses.MosesTokenizer(lang=lang).tokenize(text, return_str=False, escape=False)


# -- the frozen tables -------------------------------------------------------------


def test_the_tables_name_their_source():
    assert _moses_tables.SOURCE == f"sacremoses {version('sacremoses')}"


@pytest.mark.parametrize("name", CLASSES)
def test_each_class_on_every_code_point(name):
    """The frozen ranges hold exactly sacremoses' characters (its trailing
    newlines included), and the character class built from them matches
    the same code points as the one sacremoses compiles from its string."""
    theirs = getattr(sacremoses.MosesTokenizer, name)
    ours = Ranges(getattr(_moses_tables, name.upper()))
    assert {cp for cp in range(0x110000) if cp in ours} == set(map(ord, theirs))
    got = re.findall(f"[{ours.char_class()}]", EVERY_CODE_POINT)
    assert got == re.findall(f"[{theirs}]", EVERY_CODE_POINT)


@pytest.mark.parametrize("lang", LANGS)
def test_each_prefix_list_line_for_line(lang):
    """The nonbreaking prefixes as `NonbreakingPrefixes.words(lang)` yields
    them, and the tokenizer's numeric-only prefixes as MosesTokenizer
    derives them."""
    assert list(getattr(_moses_tables, f"NONBREAKING_PREFIXES_{lang.upper()}")) == list(
        NonbreakingPrefixes().words(lang))
    ref = sacremoses.MosesTokenizer(lang=lang)
    ours = moses.MosesTokenizer(lang)
    assert ours.numeric_only == ref.NUMERIC_ONLY_PREFIXES
    assert ours.prefix_set == set(ref.NONBREAKING_PREFIXES) - set(ref.NUMERIC_ONLY_PREFIXES)


# -- the steps -----------------------------------------------------------------------


def test_replace_unicode_punct_on_every_code_point():
    """transformers' copy of replace-unicode-punctuation.perl, its order."""
    for i in range(0, len(EVERY_CODE_POINT), 1 << 16):
        text = " ".join(EVERY_CODE_POINT[i:i + (1 << 16)])
        assert moses.replace_unicode_punct(text) == tokenization_xlm.replace_unicode_punct(text)


def test_remove_non_printing_char_on_every_code_point():
    """Every `C*` character goes, `\\n` and `\\t` among them."""
    assert moses.remove_non_printing_char(EVERY_CODE_POINT) == (
        tokenization_xlm.remove_non_printing_char(EVERY_CODE_POINT))
    assert moses.remove_non_printing_char("hello\nworld\tx") == "helloworldx"


@pytest.mark.parametrize("lang", LANGS)
def test_the_normalizer_on_every_code_point(lang):
    """MosesPunctNormalizer(lang)'s defaults over every code point between
    two letters and between two spaces."""
    ref, ours = sacremoses.MosesPunctNormalizer(lang=lang), moses.MosesPunctNormalizer(lang)
    for i in range(0, len(EVERY_CODE_POINT), 1 << 15):
        chars = EVERY_CODE_POINT[i:i + (1 << 15)]
        for text in ("".join(f"a{c}b" for c in chars), "".join(f" {c} 1" for c in chars)):
            assert ours.normalize(text) == ref.normalize(text)


@pytest.mark.parametrize("lang", LANGS)
def test_the_tokenizer_on_every_code_point(lang):
    """MosesTokenizer(lang) on every code point after a letter and before
    an apostrophe, after the apostrophe and before a comma and a digit: the
    padding rule's `IsAlnum`, the comma rules' `IsN` and the apostrophe
    rules' `IsAlpha` and `IsN` meet each character on both sides (the
    period rule's `IsAlpha` and `IsLower` are held above, its cases
    below)."""
    ref, ours = sacremoses.MosesTokenizer(lang=lang), moses.MosesTokenizer(lang)
    for i in range(0, len(EVERY_CODE_POINT), 1 << 14):
        chars = EVERY_CODE_POINT[i:i + (1 << 14)]
        text = " ".join(f"a{c}'{c},1" for c in chars)
        assert ours.tokenize(text) == ref.tokenize(text, return_str=False, escape=False)


@pytest.mark.parametrize("lang", LANGS)
@pytest.mark.parametrize("text", CASES)
def test_the_pipeline_on_each_case(text, lang):
    assert moses.moses_tokenize(text, lang) == _reference(text, lang)


def test_the_quirks_the_encoder_meets():
    """A newline joins its words; a lowercase word after a period keeps
    the period on its token; an English `No.` before a number stays whole,
    a French one does not; the French elision splits after the
    apostrophe, the English one before it."""
    assert moses.moses_tokenize("hello\nworld", "en") == ["helloworld"]
    assert moses.moses_tokenize("hello, world. café", "en") == ["hello", ",", "world.", "café"]
    assert moses.moses_tokenize("Hello, World. Café", "en") == [
        "Hello", ",", "World", ".", "Café"]
    assert moses.moses_tokenize("No. 5", "en") == ["No.", "5"]
    assert moses.moses_tokenize("No. 5", "fr") == ["No", ".", "5"]
    assert moses.moses_tokenize("l'homme", "fr") == ["l'", "homme"]
    assert moses.moses_tokenize("l'homme", "en") == ["l", "'homme"]


@pytest.mark.parametrize("lang", LANGS)
@settings(max_examples=400, deadline=None)
@given(text=st.lists(st.one_of(st.text(alphabet=ALPHABET, max_size=6), st.sampled_from(WORDS)),
                     max_size=12).map(" ".join))
def test_the_pipeline_on_drawn_texts(lang, text):
    assert moses.moses_tokenize(text, lang) == _reference(text, lang)


@pytest.mark.parametrize("lang", ["de", "ro", "zh", None])
def test_other_languages_are_refused(lang):
    with pytest.raises(ValueError, match="not in the port"):
        moses.MosesTokenizer(lang)
    with pytest.raises(ValueError, match="not in the port"):
        moses.moses_tokenize("hello", lang)
