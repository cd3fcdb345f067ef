"""Synthetic corpus generation for benchmarks and smoke runs.

The reference benches replay the hackernews workload (~1M news posts with
title/url/author/points/comments, workloads/hackernews.json). With zero
network egress we synthesize a corpus with a similar shape: Zipfian title
vocabulary, numeric facets, author facet, timestamps.

`generate_large_vocab` makes a corpus whose index vocabulary is large
(2^19 distinct words by default, the size at which the typo pass runs on
the device), with typo queries over it.
"""

from __future__ import annotations

import numpy as np

WORDS = """
show tell launch open source rust python golang javascript react database
search engine fast scalable distributed systems cloud startup funding google
apple microsoft amazon facebook meta twitter tesla spacex ai machine learning
deep neural network model training inference gpu tpu chip silicon compiler
kernel linux windows macos security privacy encryption blockchain bitcoin
crypto web app mobile ios android framework library tool cli api graphql rest
http server client network protocol performance benchmark memory cache disk
ssd latency throughput query index data analytics visualization dashboard
monitoring logging tracing debugging testing deployment docker kubernetes
container serverless lambda edge cdn dns tls quantum research paper science
math physics biology chemistry space astronomy climate energy battery solar
electric vehicle robot drone hardware firmware embedded iot sensor arduino
raspberry history book review interview podcast video stream music game
design art typography font color layout css html dom browser chrome firefox
safari extension plugin update release version bug fix feature request issue
""".split()


def generate_hackernews_like(n_docs: int, seed: int = 42) -> list[dict]:
    rng = np.random.default_rng(seed)
    vocab = np.array(WORDS)
    # zipfian word frequencies
    ranks = np.arange(1, len(vocab) + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()

    authors = [f"user{i}" for i in range(max(10, n_docs // 200))]
    docs = []
    title_lens = rng.integers(3, 12, size=n_docs)
    for i in range(n_docs):
        words = rng.choice(vocab, size=title_lens[i], p=probs)
        docs.append(
            {
                "id": i,
                "title": " ".join(words.tolist()),
                "url": f"https://example.com/{i}",
                "author": authors[int(rng.integers(0, len(authors)))],
                "points": int(rng.integers(0, 5000)),
                "num_comments": int(rng.integers(0, 500)),
                "created_at": int(1500000000 + rng.integers(0, 200000000)),
            }
        )
    return docs


QUERY_SET = [
    "rust",
    "machine learning",
    "open source database",
    "show tell",
    "python web framework",
    "distributed systems",
    "searhc engine",  # typo
    "kubernets",  # typo
    "deep neural network training",
    "performance benchark memory",  # typo
    "javascrit",  # typo (prefix-ish)
    "ai",
    "quantum research paper",
    "google",
    "security privacy encryption",
]


_ONSETS = list("bcdfghjklmnprstvz") + ["br", "ch", "dr", "gr", "kr", "sh", "st", "tr"]
_VOWELS = list("aeiou") + ["ai", "ou"]


def pseudo_words(n: int, seed: int) -> list[str]:
    """`n` distinct lowercase pseudo-words of 2-5 consonant-vowel syllables
    (about 4-15 letters), in a seeded random order."""
    rng = np.random.default_rng(seed)
    syll = np.array([o + v for o in _ONSETS for v in _VOWELS])
    words: set[str] = set()
    out: list[str] = []
    while len(out) < n:
        k = 2 * (n - len(out)) + 64
        lens = rng.integers(2, 6, size=k)
        picks = rng.integers(0, len(syll), size=(k, 5))
        for row, ln in zip(picks.tolist(), lens.tolist()):
            w = "".join(syll[i] for i in row[:ln])
            if w not in words:
                words.add(w)
                out.append(w)
                if len(out) == n:
                    break
    return out


def _typo(word: str, rng, edits: int) -> str:
    """`word` with `edits` letters substituted, never the first one (a
    one-typo derivation keeps the first letter)."""
    chars = list(word)
    for pos in rng.choice(np.arange(1, len(word)), size=edits, replace=False):
        choices = [c for c in "aeioubdgkmst" if c != chars[pos]]
        chars[pos] = choices[int(rng.integers(0, len(choices)))]
    return "".join(chars)


def generate_large_vocab(
    n_words: int = 1 << 19, seed: int = 7, words_per_doc: int = 8
) -> tuple[list[str], list[dict], list[dict]]:
    """(vocabulary, documents, typo queries). Every vocabulary word is in
    at least one document's title (half of each title covers the
    vocabulary in a seeded order); the other title words follow a Zipf law
    over the vocabulary. The queries hold one typo, two typos, a typo in a
    prefix last word, and a typo inside a multi-word chain, four of each."""
    rng = np.random.default_rng(seed)
    vocab = pseudo_words(n_words, seed)
    cover = words_per_doc // 2
    n_docs = -(-n_words // cover)
    order = rng.permutation(n_docs * cover) % n_words
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    zipf = rng.choice(n_words, size=(n_docs, words_per_doc - cover), p=probs)
    idx = np.concatenate([order.reshape(n_docs, cover), zipf], axis=1)
    words = np.array(vocab, dtype=object)
    docs = [
        {"id": i, "title": " ".join(words[row].tolist())}
        for i, row in enumerate(idx)
    ]

    def pick(lo: int, hi: int) -> str:
        while True:
            w = vocab[int(rng.integers(0, n_words))]
            if lo <= len(w) <= hi:
                return w

    queries = []
    for _ in range(4):
        queries.append({"q": _typo(pick(5, 8), rng, 1)})
        queries.append({"q": _typo(pick(9, 15), rng, 2)})
        # the last word is a prefix (cut to 6 letters) with one typo
        queries.append({"q": pick(4, 8) + " " + _typo(pick(9, 15)[:6], rng, 1)})
        queries.append(
            {"q": " ".join([pick(4, 8), _typo(pick(6, 8), rng, 1), pick(4, 8)])}
        )
    return vocab, docs, queries
