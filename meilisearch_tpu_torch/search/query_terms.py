"""Query parsing and typo derivations.

Semantic port of the reference's query-term machinery:
  - located_query_terms_from_tokens  (search/new/query_term/parse_query.rs:28)
  - partially_initialized_term_from_word + one/two-typo derivation search
    (search/new/query_term/compute_derivations.rs)
  - make_ngram                        (parse_query.rs:227)

Typo classification rules (compute_derivations.rs:75-168):
  - one-typo derivations must share the query's first character
  - candidates with a different first character and distance <= 1 are
    classified as two typos; different first char at distance 2 is excluded
  - caps: MAX_PREFIX_COUNT=1000, MAX_ONE_TYPO_COUNT=150, MAX_TWO_TYPOS_COUNT=50
    applied in lexicographic dictionary order (FST iteration order)

The distance computation runs as one batched pass over the packed dictionary
(ops/levenshtein.py) instead of DFA-FST intersection — the TPU-native
formulation of the same automaton.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..analysis.tokenizer import Tokenizer, TokenKind, SeparatorKind
from ..index.store import MAX_DISTANCE

# Reference: search/new/limits.rs
MAX_TOKEN_COUNT = 1_000
MAX_PREFIX_COUNT = 1_000
MAX_ONE_TYPO_COUNT = 150
MAX_TWO_TYPOS_COUNT = 50
MAX_SYNONYM_PHRASE_COUNT = 50
MAX_SYNONYM_WORD_COUNT = 100

# Reference: milli/src/lib.rs:146
MAX_WORD_LENGTH = 250


Phrase = tuple  # tuple of Optional[str] words (None = stop word placeholder)


@dataclass
class QueryTerm:
    original: str
    ngram_words: Optional[list[str]] = None
    max_typo: int = 0
    is_prefix: bool = False
    # zero-typo
    phrase: Optional[Phrase] = None
    exact: Optional[str] = None  # the word itself when in the dictionary
    prefix_of: list[str] = field(default_factory=list)
    synonyms: list[Phrase] = field(default_factory=list)
    use_prefix_db: Optional[str] = None
    # one-typo
    split_words: Optional[Phrase] = None
    one_typo: list[str] = field(default_factory=list)
    # two-typo
    two_typos: list[str] = field(default_factory=list)

    def zero_typo_words(self) -> list[str]:
        out = []
        if self.exact is not None:
            out.append(self.exact)
        out.extend(self.prefix_of)
        return out

    def words_for_class(self, cls: int) -> list[str]:
        if cls == 0:
            return self.zero_typo_words()
        if cls == 1:
            return list(self.one_typo)
        return list(self.two_typos)

    def phrases_for_class(self, cls: int) -> list[Phrase]:
        if cls == 0:
            out = []
            if self.phrase is not None:
                out.append(self.phrase)
            out.extend(self.synonyms)
            return out
        if cls == 1:
            return [self.split_words] if self.split_words is not None else []
        return []

    def max_typo_cost(self) -> int:
        """Reference: query_term/mod.rs:340 max_typo_cost — STRUCTURAL, not
        realized: it checks the NTypoTermSubset selectors (All unless a rule
        restricted them) and `allows_split_words()` (= no phrase), never the
        computed derivation lists. A 0-typo plain word therefore still
        contributes a class-1 slot for the split-words POSSIBILITY even when
        no split exists in the corpus — this feeds maxTypoCount and the
        global ranking score (pinned by tests/search/mod.rs test_score)."""
        if self.max_typo == 0:
            return 0 if self.phrase is not None else 1
        return self.max_typo

    def _class_nonempty(self, cls: int) -> bool:
        return bool(self.words_for_class(cls)) or bool(self.phrases_for_class(cls))

    def is_empty(self) -> bool:
        return not any(self._class_nonempty(c) for c in (0, 1, 2)) and (
            self.use_prefix_db is None
        )


@dataclass
class LocatedQueryTerm:
    term: QueryTerm
    # inclusive position range in the query (charabia token positions)
    start_position: int
    end_position: int
    # inclusive term-id range (ngram terms span several ids)
    start_term_id: int = 0
    end_term_id: int = 0

    @property
    def term_ids_len(self) -> int:
        return self.end_term_id - self.start_term_id + 1


class DerivationContext:
    """Per-search derivation engine over one index snapshot.

    Incremental across MINOR writes (store.VocabSnapshot, VERDICT r2 #2):
    the expensive structures — the sorted base vocabulary, its packed OSA
    codepoint matrix, and per-term base derivations — anchor to the
    snapshot's base_id and survive writes; each query merges in the (tiny)
    delta vocabulary exactly. A capped base candidate list plus the FULL
    delta list re-cut at the caps over the merged lexicographic stream
    equals the true capped scan over the merged vocabulary, because every
    true selection's base element is among the first-N base matches."""

    def __init__(self, store, settings) -> None:
        self.store = store
        self.settings = settings
        self._word_freq_cache: dict[tuple[str, str], int] = {}
        self.snap = store.vocab_snapshot()
        # base caches: anchored to the vocabulary snapshot's base
        base = getattr(store, "_derivation_store_cache", None)
        if base is None or base.get("base_id") != self.snap.base_id:
            base = {
                "base_id": self.snap.base_id,
                "packed": None,
                "base_terms": {},
                "base_prefix_db": {},
            }
            store._derivation_store_cache = base
        self._base = base
        # merged layer: exact current-state results, per generation
        merged = getattr(store, "_derivation_merge_cache", None)
        if merged is None or merged.get("generation") != store.generation:
            merged = {
                "generation": store.generation,
                "terms": {},
                "prefix_db": {},
                "delta_packed": None,
                "delta_version": self.snap.version,
            }
            store._derivation_merge_cache = merged
        self._cache = merged

    # -- dictionary access -------------------------------------------------

    @property
    def sorted_words(self) -> list[str]:
        """BASE vocabulary only (aligned with the packed OSA matrix);
        delta words merge in per consumer."""
        return self.snap.base_words

    def _packed_dict(self):
        if self._base["packed"] is None:
            from ..ops.levenshtein import pack_words

            self._base["packed"] = pack_words(self.snap.base_words)
        return self._base["packed"]

    def _delta_packed(self):
        if self._cache["delta_packed"] is None:
            from ..ops.levenshtein import pack_words

            self._cache["delta_packed"] = pack_words(self.snap.delta_words)
        return self._cache["delta_packed"]

    def prefix_range(self, prefix: str) -> tuple[int, int]:
        """Range in the BASE vocabulary."""
        words = self.snap.base_words
        lo = bisect_left(words, prefix)
        hi = bisect_left(words, prefix + "￿")
        return lo, hi

    def _delta_with_prefix(self, prefix: str) -> list[str]:
        dw = self.snap.delta_words
        if not dw:
            return []
        lo = bisect_left(dw, prefix)
        hi = bisect_left(dw, prefix + "￿")
        return dw[lo:hi]

    def words_with_prefix(self, prefix: str, limit: Optional[int] = None) -> list[str]:
        lo, hi = self.prefix_range(prefix)
        if limit is not None:
            hi = min(hi, lo + limit)
        base = self.snap.base_words[lo:hi]
        delta = self._delta_with_prefix(prefix)
        if not delta:
            return base
        import heapq

        merged = list(heapq.merge(base, delta))
        if limit is not None:
            merged = merged[:limit]
        return merged

    # -- typo budget ---------------------------------------------------------

    def number_of_typos_allowed(self, word: str) -> int:
        """Reference: parse_query.rs:204 number_of_typos_allowed."""
        tt = self.settings.typo_tolerance
        if not tt.enabled:
            return 0
        if word in tt.disable_on_words:
            return 0
        if tt.disable_on_numbers and _is_number_like(word):
            return 0
        n = len(word)
        if n < tt.min_word_size_for_typos.one_typo:
            return 0
        if n < tt.min_word_size_for_typos.two_typos:
            return 1
        return 2

    # -- synonyms -----------------------------------------------------------

    def synonyms_for(self, words: tuple[str, ...]) -> list[Phrase]:
        """Normalized synonym lookup by word sequence
        (reference: index.synonyms keyed by Vec<String> of normalized words)."""
        raw = self.settings.synonyms
        if not raw:
            return []
        tokenizer = self.store.make_tokenizer()
        key = tuple(w for w, _ in tokenizer.indexed_words(" ".join(words)))
        out: list[Phrase] = []
        word_budget = MAX_SYNONYM_WORD_COUNT
        for src, dests in raw.items():
            src_words = tuple(w for w, _ in tokenizer.indexed_words(src))
            if src_words != key:
                continue
            for dest in dests[:MAX_SYNONYM_PHRASE_COUNT]:
                dwords = tuple(w for w, _ in tokenizer.indexed_words(dest))
                if not dwords:
                    continue
                if word_budget - len(dwords) < 0:
                    continue
                word_budget -= len(dwords)
                out.append(tuple(dwords))
        return out

    # -- split words ----------------------------------------------------------

    def pair_frequency(self, left: str, right: str) -> int:
        key = (left, right)
        if key not in self._word_freq_cache:
            docids = self.store.word_pair_proximity_docids.get((1, left, right))
            self._word_freq_cache[key] = len(docids) if docids else 0
        return self._word_freq_cache[key]

    def find_split_words(self, word: str) -> Optional[Phrase]:
        """Reference: compute_derivations.rs:363 split_best_frequency."""
        best = None
        for i in range(1, len(word)):
            left, right = word[:i], word[i:]
            freq = self.pair_frequency(left, right)
            if freq > 0 and (best is None or freq > best[0]):
                best = (freq, left, right)
        if best is None:
            return None
        return (best[1], best[2])

    # -- prefix db ------------------------------------------------------------

    def in_prefix_db(self, word: str) -> bool:
        """Whether the word is a precomputed frequent prefix.

        Reference: index.rs:1884 PrefixSettings { max_prefix_length: 4,
        prefix_count_threshold: 100 } + word_fst_builder.rs:102-135 — prefixes
        of byte length <= 4 shared by >= 100 distinct indexed words.
        """
        if self.settings.prefix_search == "disabled":
            return False
        if len(word.encode("utf-8")) > 4:
            return False
        cached = self._cache["prefix_db"].get(word)
        if cached is None:
            lo, hi = self.prefix_range(word)
            cached = hi - lo + len(self._delta_with_prefix(word)) >= 100
            self._cache["prefix_db"][word] = cached
        return cached

    def _base_in_prefix_db(self, word: str) -> bool:
        """in_prefix_db against the BASE vocabulary only (for the cached
        base derivation pass; the merge layer re-evaluates with delta)."""
        if self.settings.prefix_search == "disabled":
            return False
        if len(word.encode("utf-8")) > 4:
            return False
        cached = self._base["base_prefix_db"].get(word)
        if cached is None:
            lo, hi = self.prefix_range(word)
            cached = hi - lo >= 100
            self._base["base_prefix_db"][word] = cached
        return cached

    # -- derivations ------------------------------------------------------------

    def term_from_word(
        self, word: str, max_typo: int, is_prefix: bool, is_ngram: bool
    ) -> QueryTerm:
        """Reference: compute_derivations.rs:170
        partially_initialized_term_from_word + full initialization (we compute
        eagerly; laziness is an LMDB-era optimization the batched distance
        pass doesn't need)."""
        import copy

        cache_key = (word, max_typo, is_prefix, is_ngram)
        cached = self._cache["terms"].get(cache_key)
        if cached is not None:
            return copy.deepcopy(cached)
        base_term = self._base["base_terms"].get(cache_key)
        if base_term is None:
            base_term = self._base_term_uncached(
                word, max_typo, is_prefix, is_ngram
            )
            if len(self._base["base_terms"]) < 10_000:
                self._base["base_terms"][cache_key] = base_term
        term = copy.deepcopy(base_term)
        self._apply_current_state(term, word, max_typo, is_prefix)
        if len(self._cache["terms"]) < 10_000:
            self._cache["terms"][cache_key] = copy.deepcopy(term)
        return term

    def _base_term_uncached(
        self, word: str, max_typo: int, is_prefix: bool, is_ngram: bool
    ) -> QueryTerm:
        """Derivations against the BASE vocabulary only — the expensive
        pass (whole-vocabulary OSA), cached across minor writes. Current
        table state (exact word, split words) and delta-vocabulary matches
        are layered on by _apply_current_state."""
        if len(word) > MAX_WORD_LENGTH:
            return QueryTerm(original=word)

        term = QueryTerm(original=word, max_typo=max_typo, is_prefix=is_prefix)

        use_prefix_db = is_prefix and self._base_in_prefix_db(word)
        if use_prefix_db:
            term.use_prefix_db = word

        if is_prefix and not use_prefix_db:
            # zero-typo prefix derivations, capped, lexicographic order
            for w in self.snap.base_words[slice(*self.prefix_range(word))]:
                if w != word:
                    term.prefix_of.append(w)
                    if len(term.prefix_of) >= MAX_PREFIX_COUNT:
                        break

        if not is_ngram:
            term.synonyms = self.synonyms_for((word,))

        if max_typo >= 1:
            self._compute_typo_derivations(term, word, max_typo, is_prefix)

        return term

    def _apply_current_state(
        self, term: QueryTerm, word: str, max_typo: int, is_prefix: bool
    ) -> None:
        """Exact current-state layer over a base-vocabulary term: table
        lookups (exact word, split words) plus delta-vocabulary merges."""
        if len(word) > MAX_WORD_LENGTH:
            return
        if self.store.contains_word(word):
            term.exact = word
        if term.phrase is None:
            # split words are computed regardless of the typo budget
            # (reference: "split words are never disabled", words_tms tests)
            split = self.find_split_words(word)
            if split is not None:
                term.split_words = split

        if not self.snap.delta_words:
            return
        if is_prefix:
            if term.use_prefix_db is None and self.in_prefix_db(word):
                # the delta pushed this prefix over the frequency
                # threshold: it becomes a prefix-DB walk, not a word list
                term.use_prefix_db = word
                term.prefix_of = []
            elif term.use_prefix_db is None:
                extra = [
                    w for w in self._delta_with_prefix(word) if w != word
                ]
                if extra:
                    import heapq

                    term.prefix_of = list(
                        heapq.merge(term.prefix_of, extra)
                    )[:MAX_PREFIX_COUNT]
        if max_typo >= 1:
            self._merge_delta_typos(term, word, max_typo, is_prefix)

    def _delta_typo_candidates(self, word: str, max_typo: int, is_prefix: bool):
        """[(word, dist)] over the delta vocabulary, lexicographic order —
        the small-side mirror of _compute_typo_derivations' base pass."""
        dw = self.snap.delta_words
        if not dw:
            return []
        from ..ops.levenshtein import MAX_LEN, osa_distances

        mat, lens = self._delta_packed()
        m = len(word)
        K = min(MAX_LEN, m + max_typo)
        full, prefix_d = osa_distances(
            word, mat[:, :K], np.minimum(lens, K)
        )
        dist = prefix_d if is_prefix else full
        sel = np.flatnonzero(dist <= max_typo)
        return [(dw[i], int(dist[i])) for i in sel.tolist()]

    def _merge_delta_typos(
        self, term: QueryTerm, word: str, max_typo: int, is_prefix: bool
    ) -> None:
        cands = self._delta_typo_candidates(word, max_typo, is_prefix)
        if not cands:
            return
        first = word[0] if word else ""
        if max_typo == 1:
            import heapq

            extra = [w for w, d in cands if d == 1 and w[:1] == first]
            if extra:
                term.one_typo = list(heapq.merge(term.one_typo, extra))[
                    :MAX_ONE_TYPO_COUNT
                ]
            return
        # re-run the joint one/two-typo cap scan over the merged stream
        # (base words and delta words are disjoint, so a plain sort is the
        # lexicographic merge)
        items = [(w, 1) for w in term.one_typo] + [
            (w, 2) for w in term.two_typos
        ]
        for w, d in cands:
            same = w[:1] == first
            if not same:
                if d <= 1:
                    items.append((w, 2))
            elif d == 1:
                items.append((w, 1))
            elif d == 2:
                items.append((w, 2))
        items.sort()
        one: list[str] = []
        two: list[str] = []
        for w, b in items:
            if b == 1:
                if len(one) < MAX_ONE_TYPO_COUNT:
                    one.append(w)
            elif len(two) < MAX_TWO_TYPOS_COUNT:
                two.append(w)
        term.one_typo = one
        term.two_typos = two

    def _compute_typo_derivations(
        self, term: QueryTerm, word: str, max_typo: int, is_prefix: bool
    ) -> None:
        words_all = self.sorted_words
        if not words_all:
            return
        mat, lens = self._packed_dict()
        from ..ops.levenshtein import MAX_LEN, osa_distances

        m = len(word)
        # device path: the whole-vocabulary OSA DP as ONE launch over the
        # resident codepoint matrix (ops/device_osa.py, K3) — at a 1M-word
        # vocabulary the host pass costs ~1.7 s per cold term. A device
        # failure raises (counted in device_errors); the host pass serves
        # small vocabularies and stays the oracle.
        from ..ops.device_osa import device_osa_available, osa_distances_device

        dist = None
        if device_osa_available(self.store, len(words_all)):
            from .device_batch import _stats_add

            try:
                full_d, prefix_d = osa_distances_device(
                    self.store, mat, lens, word
                )
            except Exception:
                _stats_add(device_errors=1)
                raise
            dist_all = prefix_d if is_prefix else full_d
            cand_idx = np.flatnonzero(dist_all <= max_typo)
            dist = dist_all[cand_idx]
        # host pass: column trim — an edit path using a dictionary prefix
        # longer than m + max_typo costs more than max_typo, so the DP
        # never needs more than K columns
        K = min(MAX_LEN, m + max_typo)
        if dist is not None:
            pass  # device pass already produced cand_idx/dist
        elif is_prefix:
            # prefix terms match against every word of length >= m-2 — at
            # a 1M-doc vocabulary that is the whole dictionary, and the
            # full-width pass measured minutes. Two structural cuts:
            # the DP runs once per UNIQUE K-truncated prefix (the packed
            # matrix is in sorted-word order, so uniques are consecutive
            # runs), because prefix_min over columns <= K is a pure
            # function of the truncated row.
            trunc = mat[:, :K]
            n = len(trunc)
            change = np.empty(n, dtype=bool)
            change[0] = True
            if n > 1:
                np.any(trunc[1:] != trunc[:-1], axis=1, out=change[1:])
            rep_idx = np.flatnonzero(change)
            rep_lens = np.minimum(lens[rep_idx], K)
            keep = rep_lens >= max(m - max_typo, 1)
            if not keep.any():
                return
            _, prefix_r = osa_distances(word, trunc[rep_idx[keep]], rep_lens[keep])
            dist_rep = np.full(len(rep_idx), 127, dtype=np.int32)
            dist_rep[keep] = prefix_r
            gid = np.cumsum(change) - 1
            dist_all = dist_rep[gid]
            cand_idx = np.flatnonzero(dist_all <= max_typo)
            dist = dist_all[cand_idx]
        else:
            # band prefilter: a full match within <=max_typo edits has a
            # length within max_typo of the query
            band = (lens >= m - max_typo) & (lens <= m + max_typo)
            cand_idx = np.flatnonzero(band)
            if len(cand_idx) == 0:
                return
            full, _ = osa_distances(
                word, mat[cand_idx][:, :K], np.minimum(lens[cand_idx], K)
            )
            sel = full <= max_typo
            dist = full[sel]
            cand_idx = cand_idx[sel]
        if len(cand_idx) == 0:
            return
        firsts_same = mat[cand_idx, 0] == (ord(word[0]) if word else -1)
        words = [words_all[i] for i in cand_idx.tolist()]

        if max_typo == 1:
            # one-typo only: candidates must share the first char
            # (compute_derivations.rs:75 find_one_typo_derivations)
            idxs = np.nonzero((dist == 1) & firsts_same)[0]
            for i in idxs[:MAX_ONE_TYPO_COUNT]:
                term.one_typo.append(words[i])
        else:
            # one + two typos in one lexicographic scan
            # (compute_derivations.rs:109 find_one_two_typo_derivations)
            cand = np.nonzero(
                ((dist <= 1) & ~firsts_same) | ((dist <= 2) & (dist >= 1) & firsts_same)
            )[0]
            one_c, two_c = 0, 0
            for i in cand:
                if one_c >= MAX_ONE_TYPO_COUNT and two_c >= MAX_TWO_TYPOS_COUNT:
                    break
                w = words[i]
                if not firsts_same[i]:
                    if two_c < MAX_TWO_TYPOS_COUNT:
                        term.two_typos.append(w)
                        two_c += 1
                    continue
                d = int(dist[i])
                if d == 1:
                    if one_c < MAX_ONE_TYPO_COUNT:
                        term.one_typo.append(w)
                        one_c += 1
                elif d == 2:
                    if two_c < MAX_TWO_TYPOS_COUNT:
                        term.two_typos.append(w)
                        two_c += 1

    def phrase_term(self, words: list[Optional[str]], start: int, end: int) -> LocatedQueryTerm:
        phrase = tuple(words)
        desc = " ".join(w for w in words if w)
        return LocatedQueryTerm(
            term=QueryTerm(original=desc, phrase=phrase),
            start_position=start,
            end_position=end,
        )


@dataclass
class ExtractedTokens:
    query_terms: list[LocatedQueryTerm]
    negative_words: list[str]
    negative_phrases: list[Phrase]


def located_query_terms_from_tokens(
    ctx: DerivationContext,
    tokenizer: Tokenizer,
    query: str,
    words_limit: Optional[int] = None,
    allow_prefix: bool = True,
) -> ExtractedTokens:
    """Reference: parse_query.rs:28 located_query_terms_from_tokens."""
    query_terms: list[LocatedQueryTerm] = []
    negative_words: list[str] = []
    negative_phrases: list[Phrase] = []

    phrase: Optional[list] = None  # [words, start, end]
    negative_phrase = False
    negative_next_token = False
    encountered_whitespace = True
    position = -1
    parts_limit = words_limit if words_limit is not None else 10**9

    allow_prefix = allow_prefix and ctx.settings.prefix_search != "disabled"

    tokens = [t for t in tokenizer.tokenize(query) if t.lemma != ""][:MAX_TOKEN_COUNT]

    def effective_lemma(token) -> str:
        """The zh pipeline folds Han traditional->simplified; when the
        folded word is unknown to the corpus but the RAW form is indexed
        (a Japanese document holding the same kanji), search the raw form
        instead. Pins reference language.rs kanji detection (東京 finds
        the ja document) alongside locales.rs folding (進撃 finds the
        folded zh document when 进击 exists)."""
        lemma = token.lemma
        import unicodedata as _ud

        from ..analysis.zh_norm import has_han

        if not has_han(lemma):
            return lemma
        raw = _ud.normalize("NFKC", token.original).lower()
        if (
            raw != lemma
            and not ctx.snap.contains(lemma)
            and ctx.snap.contains(raw)
        ):
            return raw
        return lemma

    def finish_phrase(ph):
        nonlocal negative_phrase
        if ph and any(w is not None for w in ph[0]):
            lt = ctx.phrase_term(ph[0], ph[1], ph[2])
            if negative_phrase:
                negative_phrases.append(lt.term.phrase)
            else:
                query_terms.append(lt)

    for idx, token in enumerate(tokens):
        if len(query_terms) >= parts_limit:
            break
        is_last = idx == len(tokens) - 1
        if token.kind in (TokenKind.WORD, TokenKind.STOP_WORD):
            position += 1
            if phrase is not None:
                if not phrase[0]:
                    phrase[1] = position
                phrase[2] = position
                phrase[0].append(
                    None
                    if token.kind is TokenKind.STOP_WORD
                    else effective_lemma(token)
                )
            elif negative_next_token:
                negative_words.append(effective_lemma(token))
                negative_next_token = False
            elif not is_last:
                if token.kind is TokenKind.WORD:
                    lemma = effective_lemma(token)
                    term = ctx.term_from_word(
                        lemma,
                        ctx.number_of_typos_allowed(lemma),
                        is_prefix=False,
                        is_ngram=False,
                    )
                    query_terms.append(
                        LocatedQueryTerm(term, position, position)
                    )
                # stop words are skipped (non-last)
            else:
                lemma = effective_lemma(token)
                term = ctx.term_from_word(
                    lemma,
                    ctx.number_of_typos_allowed(lemma),
                    is_prefix=allow_prefix,
                    is_ngram=False,
                )
                query_terms.append(LocatedQueryTerm(term, position, position))
        elif token.is_separator():
            if token.separator_kind is SeparatorKind.HARD:
                position += 7
                if phrase is not None:
                    finish_phrase(phrase)
                    # immediately restart a phrase (keep negative flag)
                    phrase = [[], -1, -1]
            quote_count = token.lemma.count('"')
            if quote_count > 0:
                if phrase is not None:
                    quote_count -= 1
                    finish_phrase(phrase)
                    negative_phrase = False
                    phrase = None
                if quote_count % 2 == 1:
                    negative_phrase = negative_next_token
                    phrase = [[], -1, -1]
                else:
                    phrase = phrase
            # A `-` introducing a negative term: charabia yields it as its own
            # separator token after whitespace; our separator runs group the
            # whitespace in, so accept a run of whitespace ending with `-`.
            lemma = token.lemma
            negative_next_token = phrase is None and (
                (lemma == "-" and encountered_whitespace)
                or (lemma.endswith("-") and lemma[:-1].strip() == "" and len(lemma) > 1)
            )
        encountered_whitespace = bool(token.lemma) and token.lemma[-1].isspace()

    if phrase is not None:
        finish_phrase(phrase)

    return ExtractedTokens(query_terms, negative_words, negative_phrases)


def make_ngram(
    ctx: DerivationContext,
    terms: list[LocatedQueryTerm],
) -> Optional[LocatedQueryTerm]:
    """Reference: parse_query.rs:227 make_ngram."""
    assert terms
    for t in terms:
        if t.term.phrase is not None:
            return None
        if t.term.ngram_words is not None:
            return None
    for t1, t2 in zip(terms, terms[1:]):
        if t1.end_position != t2.start_position - 1:
            return None
    words = [t.term.original for t in terms]
    ngram_str = "".join(words)
    if len(ngram_str) > MAX_WORD_LENGTH:
        return None

    max_typo = max(
        0, ctx.number_of_typos_allowed(ngram_str) - (len(terms) - 1)
    )
    is_prefix = terms[-1].term.is_prefix

    term = ctx.term_from_word(ngram_str, max_typo, is_prefix, is_ngram=True)
    term.ngram_words = words
    term.synonyms = ctx.synonyms_for(tuple(words))
    # Reference: compute_derivations.rs:300 — drop split_words equal to the
    # ngram's own component words.
    if term.split_words is not None and list(term.split_words) == words:
        term.split_words = None

    return LocatedQueryTerm(
        term,
        start_position=terms[0].start_position,
        end_position=terms[-1].end_position,
        start_term_id=terms[0].start_term_id,
        end_term_id=terms[-1].end_term_id,
    )


def _is_number_like(word: str) -> bool:
    try:
        float(word)
        return True
    except ValueError:
        return False
