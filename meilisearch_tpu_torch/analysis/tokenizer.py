"""Tokenizer / normalizer — the charabia equivalent.

Reference behavior: charabia 0.9 as used by milli
(the Meilisearch source, crates/milli — tokenizer built at
`update/new/extract/searchable/tokenize_document.rs:tokenizer_builder` and
`search/new/mod.rs:extract_tokens`).

Pipeline (Latin path):
  1. segmentation: runs of word characters separated by separator runs
  2. separator classification: soft (whitespace, quotes, dashes...) vs hard
     (sentence punctuation: . ; , ! ? ( ) ...) — hard separators introduce a
     position gap of MAX_DISTANCE(=8) between surrounding words
     (tokenize_document.rs:process_tokens) and +7 on the query side
     (query_term/parse_query.rs:119)
  3. normalization: compatibility decomposition, combining-mark removal,
     lowercasing (charabia's lowercase + nonspacing-mark normalizers)
  4. classification: Word vs StopWord (against the index stop-word set)

This is a host-side component: tokenization is irregular string work that has
no place on the MXU/VPU. A C++ implementation can replace this module behind
the same interface; the Python version is the semantic reference.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from enum import Enum
from typing import Iterable, Optional, Sequence

# Position gap introduced by a hard separator between two indexed words.
# Reference: tokenize_document.rs process_tokens — a word following a hard
# separator advances the position by MAX_DISTANCE (proximity.rs:7, = 4)
# instead of 1. (The QUERY side uses +8: parse_query.rs:119.)
HARD_SEPARATOR_GAP = 4

# The maximum byte length of an indexed word.
# Reference: milli/src/lib.rs:146 (`MAX_WORD_LENGTH = 500/2`).
MAX_WORD_LENGTH = 250


class TokenKind(Enum):
    WORD = "word"
    STOP_WORD = "stop_word"
    SEPARATOR_SOFT = "separator_soft"
    SEPARATOR_HARD = "separator_hard"
    UNKNOWN = "unknown"


class SeparatorKind(Enum):
    SOFT = "soft"
    HARD = "hard"


@dataclass
class Token:
    kind: TokenKind
    lemma: str  # normalized form
    original: str  # original slice of the input
    char_start: int  # char offsets into the original text
    char_end: int
    byte_start: int = 0
    byte_end: int = 0

    def is_separator(self) -> bool:
        return self.kind in (TokenKind.SEPARATOR_SOFT, TokenKind.SEPARATOR_HARD)

    def is_word(self) -> bool:
        return self.kind in (TokenKind.WORD, TokenKind.STOP_WORD)

    @property
    def separator_kind(self) -> Optional[SeparatorKind]:
        if self.kind is TokenKind.SEPARATOR_SOFT:
            return SeparatorKind.SOFT
        if self.kind is TokenKind.SEPARATOR_HARD:
            return SeparatorKind.HARD
        return None


# Hard separators delimit phrases / sentences (charabia's SeparatorKind::Hard).
# Whitespace (incl. newlines) is always a soft separator.
_HARD_SEPARATORS = frozenset(
    ".;,!?()[]{}|"
    "。，！？；：、"  # CJK punctuation 。，！？；：、
    "…"  # …
    "¡¿"  # ¡ ¿
)

# Soft separators: everything else that is not a word character. Explicitly
# includes whitespace, quotes, dashes, slashes, etc.


def _is_word_char(ch: str) -> bool:
    if ch == "_":
        # charabia treats underscore as part of words? No: it segments on it
        # being non-alphanumeric. Underscore is a separator in charabia.
        return False
    cat = unicodedata.category(ch)
    # Letters, numbers, and combining marks stay inside words.
    return cat[0] in ("L", "N") or cat in ("Mn", "Mc")


def classify_separator(text: str) -> SeparatorKind:
    for ch in text:
        if ch in _HARD_SEPARATORS:
            return SeparatorKind.HARD
    return SeparatorKind.SOFT


def _strip_marks(text: str) -> str:
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(c for c in decomposed if not unicodedata.combining(c))


def normalize_word(text: str, lang: Optional[str] = None) -> str:
    """charabia-equivalent normalization, script-aware: the Latin pipeline
    is compatibility decomposition + diacritic removal + lowercase; tokens
    containing CJK normalize with NFKC COMPOSITION instead — NFKD mark
    stripping would conflate Japanese voiced kana with their base forms
    (が decomposes to か + combining dakuten) and mangle Hangul syllables
    (charabia ships per-script normalizers for the same reason).

    `lang` selects charabia's per-language normalizers
    (tests/search/locales.rs semantics):
      cmn — traditional->simplified folding (zh_norm.py)
      swe — keep å/ä/ö distinct (no deaccent; charabia's swedish
            normalizer preserves them: 'trä' must NOT equal 'tra')
      ell — fold final sigma ς onto σ before deaccenting"""
    if any(_script(ch) for ch in text):
        out = unicodedata.normalize("NFKC", text).lower()
        if lang == "cmn":
            from .zh_norm import to_simplified

            out = to_simplified(out)
        return out
    if lang == "swe":
        kept = {"å", "ä", "ö"}
        decomposed = unicodedata.normalize("NFKD", text.lower())
        out = []
        i = 0
        while i < len(decomposed):
            ch = decomposed[i]
            j = i + 1
            while j < len(decomposed) and unicodedata.combining(decomposed[j]):
                j += 1
            comp = unicodedata.normalize("NFC", decomposed[i:j])
            out.append(comp if comp in kept else ch)
            i = j
        return "".join(out)
    if lang == "ell":
        # fold AFTER lowercasing: Python lower() maps a final Σ to ς
        return _strip_marks(text).lower().replace("ς", "σ")
    out = _strip_marks(text).lower()
    if any("֐" <= ch <= "׿" for ch in text):
        # Hebrew: niqqud went with the combining marks above; fold the
        # five final letter forms onto their base forms so word-final
        # spellings match mid-word queries (charabia's hebrew normalizer)
        out = out.translate(_HEBREW_FINALS)
    if "ς" in out:
        # Greek: final sigma folds onto σ for Greek-script text even
        # without a declared locale (charabia's greek normalizer runs on
        # script detection; ς exists only in Greek so the char test IS
        # the script test — and .lower() maps a capital final Σ to ς)
        out = out.replace("ς", "σ")
    return out


_HEBREW_FINALS = str.maketrans("ךםןףץ", "כמנפצ")


# script classes for segmentation (charabia Script detection equivalent)
_HAN = 1  # Chinese hanzi / Japanese kanji
_KANA = 2  # hiragana + katakana
_HANGUL = 3
_THAI = 4
_KHMER = 5

_SCRIPT_RANGES = (
    (0x4E00, 0x9FFF, _HAN),
    (0x3400, 0x4DBF, _HAN),
    (0xF900, 0xFAFF, _HAN),
    (0x3040, 0x309F, _KANA),  # hiragana
    (0x30A0, 0x30FF, _KANA),  # katakana
    (0x31F0, 0x31FF, _KANA),  # katakana phonetic extensions
    (0xAC00, 0xD7AF, _HANGUL),
    (0x1100, 0x11FF, _HANGUL),  # jamo
    (0x0E00, 0x0E7F, _THAI),
    (0x1780, 0x17FF, _KHMER),
)


def _script(ch: str) -> int:
    cp = ord(ch)
    for lo, hi, s in _SCRIPT_RANGES:
        if lo <= cp <= hi:
            return s
    return 0


def _is_cjk(ch: str) -> bool:
    return _script(ch) != 0


_jieba_tokenizer = None


def _han_segments(run: str):
    """Dictionary-based segmentation of a Han run via the bundled jieba
    dictionary (charabia's zh pipeline uses jieba too). Falls back to
    per-character unigrams if jieba is unavailable. Yields (start, end)
    offsets relative to the run."""
    global _jieba_tokenizer
    if _jieba_tokenizer is None:
        try:
            import logging

            import jieba

            jieba.setLogLevel(logging.ERROR)
            tok = jieba.Tokenizer()
            tok.initialize()
            _jieba_tokenizer = tok
        except Exception:
            _jieba_tokenizer = False
    if _jieba_tokenizer is False:
        for i in range(len(run)):
            yield (i, i + 1)
        return
    pos = 0
    # default (accurate) mode: segments concatenate back to the input
    for seg in _jieba_tokenizer.lcut(run):
        yield (pos, pos + len(seg))
        pos += len(seg)


def _khmer_syllables(run: str):
    """Khmer orthographic-syllable segmentation (offsets into the run).

    Khmer text has no inter-word spaces; the reference segments it via
    charabia's khmer feature (milli/Cargo.toml). No Khmer dictionary
    ships in this environment, so the unit is the orthographic syllable
    — base consonant (U+1780-17A2) or independent vowel (U+17A3-17B3)
    plus its coeng-stacked consonants (U+17D2 + consonant), dependent
    vowels (U+17B6-17C5) and diacritic signs (U+17C6-17D1, U+17DD) —
    applied identically at index and query time, like the Thai
    grapheme-cluster strategy above."""
    n = len(run)
    i = 0
    COENG = 0x17D2
    while i < n:
        j = i + 1
        while j < n:
            cp = ord(run[j])
            if cp == COENG and j + 1 < n and 0x1780 <= ord(run[j + 1]) <= 0x17A2:
                j += 2  # stacked subscript consonant
            elif 0x17B6 <= cp <= 0x17D1 or cp == 0x17DD:
                j += 1  # dependent vowel / sign
            else:
                break
        yield (i, j)
        i = j


def _kana_subruns(run: str):
    """Split a kana run at hiragana <-> katakana boundaries: katakana
    runs are (loanword) nouns and hiragana runs are particles/inflections
    — the standard dictionary-free ja segmentation heuristic (charabia's
    lindera splits 'クーポンで' into クーポン + で). The prolonged sound
    mark ー extends whichever run it follows."""
    def kclass(ch: str) -> int:
        return 1 if 0x3040 <= ord(ch) <= 0x309F else 2

    start = 0
    cur = kclass(run[0])
    for idx in range(1, len(run)):
        if ord(run[idx]) == 0x30FC:  # ー
            continue
        c = kclass(run[idx])
        if c != cur:
            yield (start, idx)
            start = idx
            cur = c
    yield (start, len(run))


def _kana_segments(run: str):
    """Character bigrams per hiragana/katakana sub-run (the Lucene CJK
    strategy): no open Japanese dictionary ships in this environment, and
    overlapping bigrams applied identically at index and query time give
    far better precision than unigrams. A length-1 sub-run stays a
    unigram; bigrams never straddle a hiragana/katakana boundary."""
    for s, e in _kana_subruns(run):
        n = e - s
        if n == 1:
            yield (s, s + 1)
            continue
        for i in range(s, e - 1):
            yield (i, i + 2)


def _bigram_segments(n: int):
    """Overlapping character bigrams over a length-n run (Japanese kanji
    under the jpn locale: the ja dictionary pipeline isn't available, and
    bigrams — the Lucene CJKAnalyzer strategy — applied identically at
    index and query time segment DIFFERENTLY from the zh jieba pipeline,
    which is what the reference's locale suite pins: a doc indexed under
    jpn must not match a cmn-tokenized phrase, locales.rs:429)."""
    if n == 1:
        yield (0, 1)
        return
    for i in range(n - 1):
        yield (i, i + 2)


# 2-letter -> canonical 3-letter locale codes for the languages whose
# pipelines differ (reference meilisearch-types/src/locales.rs lists both)
_LOCALE_ALIASES = {
    "ja": "jpn", "zh": "cmn", "zho": "cmn", "sv": "swe", "de": "deu",
    "el": "ell", "he": "heb", "ko": "kor", "th": "tha", "km": "khm",
}


def canonical_locale(code: str) -> str:
    return _LOCALE_ALIASES.get(code, code)


# compact German morpheme vocabulary for compound decomposition
# (charabia's german feature splits compounds so the parts are searchable;
# locales.rs:1308 german_search pins 'organisation' matching
# 'Wissensorganisation'). A part is valid when it IS a stem or extends a
# stem by a short derivational suffix; a linking -s joins parts.
_GERMAN_STEMS = frozenset(
    """
    inter kultur organisation wissen arbeit haus kranken wagen schaft
    verein versicherung geschwindigkeit begrenzung donau dampf schiff
    fahrt kapitän gesell unter über haupt stadt land bahn hof straße
    strasse platz markt buch schule hoch zeit punkt spiel feld werk
    zeug fahr flug wasser feuer wehr kraft stoff hand schuh sonne
    blume licht schalter nacht tisch lampe kinder garten grund lage
    stück ver aus ein auf mit nach vor zusammen bundes länder minister
    präsident kanzler regierung politik wirtschaft technik informations
    computer daten netz system analyse methode theorie praxis forschung
    entwicklung produktion industrie energie umwelt schutz natur
    """.split()
)


def _german_decompose(word: str) -> list[str]:
    """Greedy recursive compound decomposition; [] when no split."""
    def valid(part: str) -> bool:
        if len(part) < 3:
            return False
        if part in _GERMAN_STEMS:
            return True
        return any(
            len(s) >= 4 and part.startswith(s) and len(part) - len(s) <= 8
            for s in _GERMAN_STEMS
        )

    def rec(w: str, depth: int) -> Optional[list[str]]:
        if depth > 4:
            return None
        if valid(w):
            return [w]
        for i in range(min(len(w) - 3, 14), 2, -1):
            left = w[:i]
            ok = valid(left) or (
                left.endswith("s") and valid(left[:-1])
            )
            if ok:
                rest = rec(w[i:], depth + 1)
                if rest:
                    return [left] + rest
        return None

    if len(word) < 7:
        return []
    parts = rec(word, 0)
    return parts if parts and len(parts) > 1 else []


class Tokenizer:
    """Configurable tokenizer (stop words, custom separators, dictionary).

    Mirrors charabia's TokenizerBuilder surface used by milli:
    stop_words, separators, words_dict, allow_list(locales).
    """

    def __init__(
        self,
        stop_words: Optional[Iterable[str]] = None,
        separators: Optional[Sequence[str]] = None,
        dictionary: Optional[Iterable[str]] = None,
        locales: Optional[Sequence[str]] = None,
    ) -> None:
        self.stop_words = frozenset(stop_words) if stop_words else frozenset()
        self.custom_separators = (
            sorted((s for s in separators if s), key=len, reverse=True)
            if separators
            else None
        )
        self.dictionary = (
            sorted((w for w in dictionary if w), key=len, reverse=True)
            if dictionary
            else None
        )
        self.locales = (
            [canonical_locale(loc) for loc in locales] if locales else None
        )

    # -- language resolution ----------------------------------------------

    def _han_lang(self, text: str) -> str:
        """Language of Han runs for one tokenize() call: the locales
        allow-list decides when unambiguous; otherwise detection over the
        WHOLE text (kana present => Japanese — charabia/whatlang detect at
        text granularity, which is why 進撃 inside 進撃の巨人 indexes as
        Japanese while the bare query 進撃 detects as Chinese,
        locales.rs:91 simple_search)."""
        locs = self.locales or ()
        has_j = "jpn" in locs
        has_c = "cmn" in locs
        if has_j and not has_c:
            return "jpn"
        if has_c and not has_j:
            return "cmn"
        return (
            "jpn"
            if any(_script(c) == _KANA for c in text)
            else "cmn"
        )

    def _latin_lang(self) -> Optional[str]:
        for loc in self.locales or ():
            if loc in ("swe", "deu", "ell"):
                return loc
        return None

    # -- segmentation ------------------------------------------------------

    def _segment(self, text: str, han_lang: str = "cmn"):
        """Yield (start, end, is_word) character spans."""
        if self.custom_separators is not None:
            yield from self._segment_custom(text)
            return
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if _is_word_char(ch):
                j = i
                script = _script(ch)
                while (
                    j < n
                    and _is_word_char(text[j])
                    and _script(text[j]) == script
                ):
                    j += 1
                run = text[i:j]
                if script == _HAN and han_lang == "jpn":
                    # Japanese kanji: overlapping bigrams (no ja
                    # dictionary in this environment; differs from the
                    # zh pipeline, which locales.rs pins)
                    for s, e in _bigram_segments(len(run)):
                        yield (i + s, i + e, True)
                elif script == _HAN:
                    # dictionary segmentation (charabia zh: jieba) over
                    # the SIMPLIFIED text: trad->simp is char-per-char so
                    # offsets map 1:1, and segmenting post-normalization
                    # keeps traditional queries aligned with simplified
                    # documents (進撃 -> 进击 segments as one word)
                    from .zh_norm import to_simplified

                    for s, e in _han_segments(to_simplified(run)):
                        yield (i + s, i + e, True)
                elif script == _KANA:
                    # overlapping bigrams (no ja dictionary available;
                    # identical at index and query time)
                    for s, e in _kana_segments(run):
                        yield (i + s, i + e, True)
                elif script == _KHMER:
                    # orthographic syllables (no Khmer dictionary in
                    # this environment; identical at index + query time)
                    for s, e in _khmer_syllables(run):
                        yield (i + s, i + e, True)
                elif script == _THAI:
                    # no Thai dictionary available: grapheme-cluster
                    # unigrams (base char + combining vowels/tone marks)
                    # keep searches functional
                    k = i
                    while k < j:
                        e = k + 1
                        # Thai vowels/tone marks are Mn with combining
                        # class 0 — test the category, not combining()
                        while e < j and unicodedata.category(text[e]) in (
                            "Mn",
                            "Mc",
                        ):
                            e += 1
                        yield (k, e, True)
                        k = e
                else:
                    # Latin/other and HANGUL (Korean words are
                    # whitespace-delimited) keep whole runs
                    yield (i, j, True)
                i = j
            else:
                j = i
                while j < n and not _is_word_char(text[j]):
                    j += 1
                yield (i, j, False)
                i = j

    def _segment_custom(self, text: str):
        """Segmentation with a user-defined separator list: only the given
        strings separate words (reference: charabia `separators()` — milli
        settings `separatorTokens`/`nonSeparatorTokens`)."""
        n = len(text)
        i = 0
        word_start = -1
        while i < n:
            matched = None
            for sep in self.custom_separators:
                if text.startswith(sep, i):
                    matched = sep
                    break
            if matched is not None:
                if word_start >= 0:
                    yield (word_start, i, True)
                    word_start = -1
                yield (i, i + len(matched), False)
                i += len(matched)
            else:
                if word_start < 0:
                    word_start = i
                i += 1
        if word_start >= 0:
            yield (word_start, n, True)

    def _split_dictionary(self, start: int, end: int, text: str):
        """Split a word span on dictionary words (charabia words_dict)."""
        if not self.dictionary:
            yield (start, end)
            return
        i = start
        while i < end:
            matched = None
            for w in self.dictionary:
                if text.startswith(w, i) and i + len(w) <= end:
                    matched = w
                    break
            if matched:
                yield (i, i + len(matched))
                i += len(matched)
            else:
                # advance until the next dictionary match inside the span
                j = i + 1
                while j < end:
                    if any(
                        text.startswith(w, j) and j + len(w) <= end
                        for w in self.dictionary
                    ):
                        break
                    j += 1
                yield (i, j)
                i = j

    # -- public API ---------------------------------------------------------

    def tokenize(self, text: str) -> list[Token]:
        tokens: list[Token] = []
        han_lang = self._han_lang(text)
        latin_lang = self._latin_lang()
        for start, end, is_word in self._segment(text, han_lang):
            original = text[start:end]
            if is_word:
                for ws, we in self._split_dictionary(start, end, text):
                    worig = text[ws:we]
                    is_han = _script(worig[0]) == _HAN if worig else False
                    lemma = normalize_word(
                        worig,
                        han_lang if is_han else latin_lang,
                    )
                    # Stop-word classification is case sensitive on the raw
                    # token (reference: stop_words.rs "they are case
                    # sensitive" — charabia classifies before normalizing).
                    kind = (
                        TokenKind.STOP_WORD
                        if worig in self.stop_words
                        else TokenKind.WORD
                    )
                    if (
                        latin_lang == "deu"
                        and kind is TokenKind.WORD
                        and not is_han
                    ):
                        parts = _german_decompose(lemma)
                        if parts:
                            # compound parts become consecutive tokens
                            # sharing the original span (german_search:
                            # 'organisation' finds Wissensorganisation)
                            for part in parts:
                                tokens.append(
                                    Token(kind, part, worig, ws, we)
                                )
                            continue
                    tokens.append(Token(kind, lemma, worig, ws, we))
            else:
                sep_kind = classify_separator(original)
                kind = (
                    TokenKind.SEPARATOR_HARD
                    if sep_kind is SeparatorKind.HARD
                    else TokenKind.SEPARATOR_SOFT
                )
                tokens.append(Token(kind, original, original, start, end))
        return tokens

    def indexed_words(self, text: str) -> list[tuple[str, int]]:
        """Return (word, relative_position) pairs for one field value.

        Mirrors tokenize_document.rs:process_tokens — positions advance by 1
        between words, and by HARD_SEPARATOR_GAP across a hard separator.
        Stop words are NOT indexed but still occupy a position (reference:
        stop_words.rs test_stop_words_not_indexed + the `is_word()` filter in
        process_tokens).
        """
        # the native fast path folds Latin accents and knows nothing of
        # per-language pipelines: bypass it when a Latin-affecting locale
        # is active (swe keeps å/ä/ö; deu splits compounds; ell folds
        # sigma). CJK locales are safe — native rejects non-Latin text.
        if (
            self.custom_separators is None
            and self.dictionary is None
            and self._latin_lang() is None
        ):
            from .native import native_indexed_words

            result = native_indexed_words(text, self.stop_words)
            if result is not None:
                return result
        out: list[tuple[str, int]] = []
        position = 0
        prev: Optional[TokenKind] = None
        for token in self.tokenize(text):
            if token.is_word() and token.lemma:
                if prev is None:
                    pass
                elif prev is TokenKind.SEPARATOR_HARD:
                    position += HARD_SEPARATOR_GAP
                else:
                    position += 1
                prev = token.kind
                word = token.lemma.strip()
                if (
                    token.kind is TokenKind.WORD
                    and word
                    and len(word.encode("utf-8")) <= MAX_WORD_LENGTH
                ):
                    out.append((word, position))
            elif token.kind is TokenKind.SEPARATOR_HARD:
                # leading separators are ignored (reference process_tokens
                # skip_while(is_separator))
                if prev is not None:
                    prev = TokenKind.SEPARATOR_HARD
            elif token.kind is TokenKind.SEPARATOR_SOFT:
                if prev is not None and prev is not TokenKind.SEPARATOR_HARD:
                    prev = TokenKind.SEPARATOR_SOFT
        return out
