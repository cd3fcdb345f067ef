"""Highlighting, crop, and match positions.

Reference: milli/src/search/new/matches/ —
  - MatchingWords (matching_words.rs): token vs derivation matching; prefix
    terms highlight only the typed prefix length (original_char_count);
    phrases/split-words/synonyms match runs of consecutive tokens
    (PartialMatch)
  - Match (match.rs): one match is a word OR a whole phrase run, carrying
    (word_positions, token_positions) so a phrase highlights as ONE tag
  - best_match_interval.rs: the crop window centers on the interval of
    matches maximizing (unique term ids, -distance, ordered count) within
    crop_size words
  - Matcher (mod.rs): crop grows token-by-token around the interval with
    separator-kind arbitration; `_matchesPosition` byte ranges

Golden suite: tests/golden/test_matches_format.py (port of mod_test.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..analysis.tokenizer import SeparatorKind, Token, TokenKind, Tokenizer
from .query_terms import LocatedQueryTerm


@dataclass
class WordMatcher:
    words: set[str]
    is_prefix: bool
    original_char_count: int
    term_id_start: int
    term_id_end: int


@dataclass
class PhraseMatcher:
    words: tuple  # Optional[str] sequence (None = stop word slot)
    term_id_start: int
    term_id_end: int


class MatchingWords:
    def __init__(self, located_terms: list[LocatedQueryTerm]):
        self.word_matchers: list[WordMatcher] = []
        self.phrase_matchers: list[PhraseMatcher] = []
        # word-id space for interval scoring: one id per TYPED word, so a
        # quoted phrase counts one id per word (the reference's
        # located_term.positions, matching_words.rs:48 — the scorer's
        # term-id space assigns one id per TERM and must not leak here:
        # best_match_interval ranks intervals by unique WORD coverage)
        next_id = 0
        for lt in located_terms:
            term = lt.term
            width = (
                sum(1 for _w in term.phrase) if term.phrase is not None else 1
            )
            id_start, id_end = next_id, next_id + width - 1
            next_id += width
            words: set[str] = set()
            for cls in (0, 1, 2):
                words.update(term.words_for_class(cls))
                for p in term.phrases_for_class(cls):
                    self.phrase_matchers.append(
                        PhraseMatcher(tuple(p), id_start, id_end)
                    )
            if term.use_prefix_db:
                words.add(term.use_prefix_db)
            if words:
                self.word_matchers.append(
                    WordMatcher(
                        words,
                        term.is_prefix,
                        len(term.original),
                        id_start,
                        id_end,
                    )
                )
        # prefixes at the bottom, prioritizing exact matches
        # (matching_words.rs:60)
        self.word_matchers.sort(key=lambda m: (m.is_prefix, -(m.term_id_end - m.term_id_start + 1)))

    def match_word_token(self, token: Token) -> Optional[tuple[int, int, int]]:
        """Returns (highlight_char_len, id_start, id_end) or None."""
        lemma = token.lemma
        for m in self.word_matchers:
            for word in m.words:
                if m.is_prefix and lemma.startswith(word):
                    # highlight only the typed prefix length
                    prefix_chars = min(len(word), m.original_char_count)
                    # at least the typed chars, at most the token
                    return (min(prefix_chars, len(lemma)), m.term_id_start, m.term_id_end)
                if lemma == word:
                    return (len(lemma), m.term_id_start, m.term_id_end)
        return None


def _phrase_slot_matches(slot: Optional[str], token: Token) -> bool:
    # a None slot is a stop word (matching_words.rs PartialMatch)
    if slot is None:
        return token.kind is TokenKind.STOP_WORD
    return token.lemma == slot


@dataclass
class Match:
    """One match: a single word token or a whole phrase run
    (reference match.rs MatchPosition::{Word, Phrase})."""

    char_count: int  # chars to highlight from the match's first char
    id_start: int
    id_end: int
    is_phrase: bool
    word_positions: tuple[int, int]  # (first, last) word positions
    token_positions: tuple[int, int]  # (first, last) indices into tokens

    @property
    def first_word_pos(self) -> int:
        return self.word_positions[0]

    @property
    def last_word_pos(self) -> int:
        return self.word_positions[1]

    @property
    def first_token_pos(self) -> int:
        return self.token_positions[0]

    @property
    def last_token_pos(self) -> int:
        return self.token_positions[1]

    @property
    def word_count(self) -> int:
        return self.word_positions[1] - self.word_positions[0] + 1


def _interval_score(matches: list[Match]) -> tuple[int, int, int]:
    """(unique ids, distance score, order score) — best_match_interval.rs
    get_interval_score, compared lexicographically."""
    ids: set[int] = set()
    order_score = 0
    distance_score = 0
    for i, m in enumerate(matches):
        if i + 1 < len(matches):
            nxt = matches[i + 1]
            if nxt.id_start > m.id_start:
                order_score += 1
            if m.is_phrase:
                span = m.last_word_pos - m.first_word_pos
                order_score += span
                distance_score -= span
            distance_score -= min(nxt.first_word_pos - m.last_word_pos, 7)
        elif m.is_phrase:
            span = m.last_word_pos - m.first_word_pos
            order_score += span
            distance_score -= span
        ids.update(range(m.id_start, m.id_end + 1))
    return (len(ids), distance_score, order_score)


def find_best_match_interval(
    matches: list[Match], crop_size: int
) -> tuple[Match, Match]:
    """Sliding-window interval search (best_match_interval.rs:63)."""
    best: Optional[tuple[tuple[int, int, int], int, int]] = None

    def save(first: int, last: int) -> None:
        nonlocal best
        score = _interval_score(matches[first : last + 1])
        if best is None or score > best[0]:
            best = (score, first, last)

    interval_first = 0
    first_wp = matches[0].first_word_pos
    for index, nxt in enumerate(matches):
        nlwp = nxt.last_word_pos
        if nlwp - first_wp >= crop_size:
            if index != 0:
                save(interval_first, index - 1)
            # advance the window start until the next match fits
            while True:
                interval_first += 1
                if interval_first == len(matches):
                    interval_first -= 1
                    break
                first_wp = matches[interval_first].first_word_pos
                if first_wp > nlwp or nlwp - first_wp < crop_size:
                    break
    interval_last = len(matches) - 1
    if (
        interval_first != interval_last
        or matches[interval_first].word_count < crop_size
    ):
        save(interval_first, interval_last)
    if best is None:
        return matches[0], matches[0]
    return matches[best[1]], matches[best[2]]


class Matcher:
    def __init__(
        self,
        matching_words: MatchingWords,
        tokenizer: Tokenizer,
        text: str,
    ):
        self.text = text
        self.mw = matching_words
        self.tokens = tokenizer.tokenize(text)
        self.matches = self._compute_matches()

    def _compute_matches(self) -> list[Match]:
        """mod.rs compute_matches: phrases first (consuming their run),
        then unique words."""
        tokens = self.tokens
        wp: list[tuple[int, int, Token]] = []  # (token_pos, word_pos, token)
        word_pos = 0
        for token_pos, tok in enumerate(tokens):
            if not tok.is_separator():
                wp.append((token_pos, word_pos, tok))
                word_pos += 1

        matches: list[Match] = []
        i = 0
        while i < len(wp):
            tpos, wpos, tok = wp[i]
            consumed_to: Optional[int] = None
            for pm in self.mw.phrase_matchers:
                slots = pm.words
                if not slots or not _phrase_slot_matches(slots[0], tok):
                    continue
                if len(slots) == 1:
                    # a one-word phrase resolves as a word match
                    matches.append(
                        Match(
                            tok.char_end - tok.char_start,
                            pm.term_id_start,
                            pm.term_id_end,
                            False,
                            (wpos, wpos),
                            (tpos, tpos),
                        )
                    )
                    consumed_to = i
                    break
                j = i + 1
                k = 1
                while j < len(wp):
                    t2 = wp[j][2]
                    if not _phrase_slot_matches(slots[k], t2):
                        break
                    k += 1
                    if k == len(slots):
                        matches.append(
                            Match(
                                t2.char_end - tok.char_start,
                                pm.term_id_start,
                                pm.term_id_end,
                                True,
                                (wpos, wp[j][1]),
                                (tpos, wp[j][0]),
                            )
                        )
                        consumed_to = j
                        break
                    j += 1
                if consumed_to is not None:
                    break
            if consumed_to is not None:
                i = consumed_to + 1
                continue
            m = self.mw.match_word_token(tok)
            if m is not None:
                hl, ids, ide = m
                matches.append(
                    Match(hl, ids, ide, False, (wpos, wpos), (tpos, tpos))
                )
            i += 1
        return matches

    # -- crop ----------------------------------------------------------------

    def _crop_bounds(self, crop_size: int) -> tuple[int, int]:
        """(char_start, char_end) of the crop window — mod.rs crop_bounds:
        two cursors grow outward from the best match interval, arbitrating
        word vs separator-kind at each step."""
        tokens = self.tokens
        matches = self.matches
        if matches:
            mf, ml = find_best_match_interval(matches, crop_size)
            matches_size = ml.last_word_pos - mf.first_word_pos + 1
            gte = crop_size >= matches_size
            forward = matches_size == 0 or gte
            remaining = (
                crop_size - matches_size if gte else matches_size - crop_size
            )
            after_start = (
                0
                if matches_size == 0
                else min(ml.last_token_pos + 1, len(tokens))
            )
            before_start = mf.first_token_pos if forward else 0
        else:
            remaining, forward = crop_size, True
            before_start, after_start = 0, 0

        bi = before_start - 1  # next "before" token (walking backwards)
        if forward:
            ai = after_start
            a_step = 1
        else:
            # over-long single match: walk the end cursor BACKWARDS to trim
            ai = min(after_start, len(tokens) - 1)
            a_step = -1

        def a_valid(ix: int) -> bool:
            return 0 <= ix < len(tokens)

        while remaining > 0:
            b = tokens[bi] if bi >= 0 else None
            a = tokens[ai] if a_valid(ai) else None
            if b is not None and a is not None:
                bk = b.separator_kind
                ak = a.separator_kind
                if bk is not None and ak is not None:
                    if bk == ak:
                        bi -= 1
                        # avoid an ending separator before the crop marker
                        if remaining > 1:
                            ai += a_step
                    elif bk is SeparatorKind.HARD:
                        ai += a_step
                    else:
                        bi -= 1
                elif bk is None and ak is not None:
                    bi -= 1
                    remaining -= 1
                elif bk is not None and ak is None:
                    ai += a_step
                    remaining -= 1
                else:
                    bi -= 1
                    remaining -= 1
                    if remaining > 0:
                        ai += a_step
                        remaining -= 1
            elif b is not None:
                bi -= 1
                if b.separator_kind is None:
                    remaining -= 1
            elif a is not None:
                ai += a_step
                if a.separator_kind is None:
                    remaining -= 1
            else:
                break

        start_char = tokens[bi].char_end if bi >= 0 else 0
        end_char = tokens[ai].char_start if a_valid(ai) else len(self.text)
        return (start_char, end_char)

    # -- format ----------------------------------------------------------------

    def format(
        self,
        highlight: bool = False,
        crop: Optional[int] = None,
        pre_tag: str = "<em>",
        post_tag: str = "</em>",
        crop_marker: str = "…",
    ) -> str:
        text = self.text
        tokens = self.tokens
        start_char, end_char = 0, len(text)
        if crop is not None and crop > 0:
            start_char, end_char = self._crop_bounds(crop)
        parts: list[str] = []
        if start_char > 0 and crop_marker:
            parts.append(crop_marker)
        cursor = start_char
        if highlight:
            for m in self.matches:
                ftp, ltp = m.token_positions
                m_start = tokens[ftp].char_start
                m_end = tokens[ltp].char_end
                # skip matches out of the crop window
                if m_end < start_char or m_start > end_char:
                    continue
                ms = max(m_start, start_char)
                me = min(m_end, end_char)
                if cursor < ms:
                    parts.append(text[cursor:ms])
                # highlight char_count chars from the match start (a
                # prefix match tags only the typed prefix)
                hl_end = min(m_start + m.char_count, me)
                if hl_end > ms:
                    parts.append(pre_tag + text[ms:hl_end] + post_tag)
                if me > hl_end:
                    parts.append(text[hl_end:me])
                cursor = max(cursor, me)
        if cursor < end_char:
            parts.append(text[cursor:end_char])
        if end_char < len(text) and crop_marker:
            parts.append(crop_marker)
        return "".join(parts)

    def matches_position(self) -> list[dict]:
        """_matchesPosition entries: byte offsets into the original text."""
        out = []
        text = self.text
        for m in self.matches:
            cs = self.tokens[m.first_token_pos].char_start
            prefix = text[:cs].encode("utf-8")
            matched = text[cs : cs + m.char_count].encode("utf-8")
            out.append({"start": len(prefix), "length": len(matched)})
        return out
