"""Batched typo-tolerant term matching.

The reference intersects per-word Levenshtein DFAs with an FST of all indexed
words (milli `build_dfa`, crates/milli/src/search/mod.rs:565, using the
`levenshtein_automata` crate with `transposition=true`, i.e. the restricted
Damerau / optimal-string-alignment distance).

The TPU-native equivalent is a *batched distance computation*: the whole term
dictionary is packed into a fixed-stride (n_words, MAX_LEN) codepoint matrix,
and one data-parallel DP computes, for every dictionary word at once:

  - the OSA distance to the query word, and
  - the min distance over all dictionary-word prefixes (for prefix search).

This file holds the numpy reference implementation; `ops/device.py` lowers the
same recurrence to JAX for the TPU path (same outputs, differentially tested).
The per-cell work is pure elementwise select/min over n_words-wide vectors —
a textbook VPU workload.
"""

from __future__ import annotations

import numpy as np

MAX_LEN = 32  # covers any word that can meaningfully match with <=2 typos
INF = np.int32(127)


def pack_words(words: list[str], max_len: int = MAX_LEN) -> tuple[np.ndarray, np.ndarray]:
    """Pack words into (n, max_len) int32 codepoints (0-padded) + lengths.

    Words longer than max_len are truncated for the matrix; their true length
    is clamped — callers must handle exact-match for oversized words on host
    (they cannot be typo-matched anyway: >32 chars vs <=2 edits keeps length
    within 2, and query words above MAX_WORD_LENGTH get 0 typos).
    """
    n = len(words)
    if n == 0:
        return np.zeros((n, max_len), dtype=np.int32), np.zeros(
            (n,), dtype=np.int32
        )
    # one UTF-32 decode of the NUL-padded concatenation: the per-word
    # Python loop measured ~10 s on a 1M-word vocabulary, and
    # np.repeat-based index construction another ~13 s (this numpy's
    # repeat runs ~1 us/element here) — string-level padding + a single
    # reshape avoids both. The matrix is a read-only frombuffer view;
    # every consumer only reads it.
    lens = np.fromiter(
        (len(w) if len(w) < max_len else max_len for w in words),
        dtype=np.int32,
        count=n,
    )
    # join EXISTING string objects (per-word padding/slicing allocated a
    # million small strings and dominated the cost); ASCII vocabularies
    # (the overwhelming case) decode via latin-1 at 1 byte/char
    joined = "".join(
        [w if len(w) <= max_len else w[:max_len] for w in words]
    )
    if joined.isascii():
        cps = np.frombuffer(joined.encode("latin1"), dtype=np.uint8)
    else:
        cps = np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32)
    total = len(cps)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    # row index per character: +1 at each word start, cumsum. Distinct
    # start offsets take the fancy-store fast path; zero-length words
    # (possible in ad-hoc inputs, never in an index vocabulary) duplicate
    # offsets and need accumulation.
    starts = np.zeros(total + 1, dtype=np.int64)
    if lens.all():
        starts[offs[:-1]] = 1
    else:
        # a zero-length word shares its start offset with the next word
        # (and trailing empties land at offset == total, hence the +1 slot)
        np.add.at(starts, offs[:-1], 1)
    rows = np.cumsum(starts[:total]) - 1
    cols = np.arange(total, dtype=np.int64) - offs[rows]
    mat = np.zeros((n, max_len), dtype=np.int32)
    mat[rows, cols] = cps
    return mat, lens


def osa_distances(
    query: str,
    dict_mat: np.ndarray,
    dict_lens: np.ndarray,
    max_dist: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched restricted-Damerau (OSA) distance, query vs every dict word.

    Returns (full, prefix_min):
      full[i]       = OSA(query, dict[i]) clipped to max_dist+1
      prefix_min[i] = min over prefixes p of dict[i] with len(p) >= len(q)-max_dist
                      of OSA(query, p), clipped — the `build_prefix_dfa`
                      equivalent (candidate word extends the query).
    """
    q = np.array([ord(c) for c in query[:MAX_LEN]], dtype=np.int32)
    m = len(q)
    n, L = dict_mat.shape
    big = np.int16(INF)

    # dp rows over candidate length dimension j (vector over all words);
    # int16 state: every DP value is bounded by i + j <= 2*MAX_LEN + INF,
    # and the memory traffic of these (n, L+1) rows IS the runtime on a
    # large vocabulary
    prev = np.empty((n, L + 1), dtype=np.int16)
    prev[:] = np.arange(L + 1, dtype=np.int16)[None, :]  # D[0][j] = j
    prev2 = np.zeros_like(prev)

    jidx = np.arange(1, L + 1, dtype=np.int32)[None, :]  # (1, L)
    valid_j = jidx <= dict_lens[:, None]  # (n, L)

    full = np.where(dict_lens == 0, np.int16(m), big).astype(np.int16)
    # prefix distance: min over j >= max(m - max_dist, 0) of D[m][j] for j <= len
    prefix_min = np.full((n,), big, dtype=np.int16)

    col16 = np.arange(L + 1, dtype=np.int16)[None, :]
    for i in range(1, m + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = i
        qc = q[i - 1]
        sub_cost = (dict_mat != qc).astype(np.int16)  # (n, L)
        # deletion (from query): prev[j] + 1 ; insertion: cur[j-1] + 1 ;
        # substitution: prev[j-1] + sub_cost
        del_ = prev[:, 1:] + np.int16(1)
        sub = prev[:, :-1] + sub_cost
        best = np.minimum(del_, sub)
        if i >= 2:
            # transposition: q[i-2]==w[j-1] and q[i-1]==w[j-2]
            trans_ok = np.zeros((n, L), dtype=bool)
            trans_ok[:, 1:] = (dict_mat[:, 1:] == q[i - 2]) & (
                dict_mat[:, :-1] == qc
            )
            trans = np.where(trans_ok, np.concatenate(
                [np.full((n, 1), big, dtype=np.int16), prev2[:, :-2] + np.int16(1)],
                axis=1,
            ), big)
            best = np.minimum(best, trans)
        # insertion needs a sequential scan along j; emulate with loop over L
        # in a vectorized prefix-min fashion:
        # cur[j] = min(best[j], cur[j-1] + 1)
        # => cur[j] = min over k<=j of (best[k] + (j-k)), with cur[0]=i
        shifted = np.minimum.accumulate(
            np.concatenate([cur[:, :1], best], axis=1) - col16,
            axis=1,
        )
        cur[:, 1:] = shifted[:, 1:] + col16[:, 1:]
        prev2, prev = prev, cur

    # full distance at j = len
    full = np.take_along_axis(prev, dict_lens[:, None].astype(np.intp), axis=1)[:, 0]
    # prefix distance: min over valid j of D[m][j] where j ranges over all
    # prefix lengths of the word (including j < m); the automaton only gains
    # from j >= m - max_dist but min over all j is equivalent since shorter
    # prefixes cost at least the length difference.
    row = prev[:, 1:]
    row_masked = np.where(valid_j, row, big)
    prefix_min = np.minimum(row_masked.min(axis=1), full)
    if m <= max_dist:
        # the empty prefix is within range too (delete all query chars)
        prefix_min = np.minimum(prefix_min, m)
    return (
        np.minimum(full, max_dist + 1).astype(np.int32),
        np.minimum(prefix_min, max_dist + 1).astype(np.int32),
    )
