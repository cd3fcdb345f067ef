#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meilisearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--docs N] [--enc-docs N]

Run from the root of the repository, on a machine with a CUDA device.
Phases, each fatal on failure:
  1. build K1 (csrc/chain_keys.cu), K3 (csrc/osa.cu), K4h
     (csrc/hamming.cu) and K6 (csrc/chain_dp.cu: the DP and the merge
     of its top-k survivors) with nvcc, one process per source, into one
     library; print ptxas registers/spills;
  2. kernels: K1 against its plain torch version on the card, bit for
     bit, for every T of the ladder at D = 2^14 and 2^20, B = 32; K3
     against its plain version byte for byte over a 2^20-word seeded
     vocabulary (lengths 0-32, non-ASCII codepoints, padding rows) kept
     resident with its length order, 19 query words (m = 0 and 32 among
     them, 32 distinct codepoints, 32 codepoints that collide under the
     query table's first multiplier) at max_dist 1 and 2, and three of
     them against the host pass (ops/levenshtein.py) on 2^16 words; K4h
     in both modes against its plain versions element for element (the
     keyed mode's cosines and keys bit for bit, at n_live = 1, n - 5 and
     n) at n = 2^18 + 3 rows for W = 1, 3, 4, 12, 24 and 48 sign words,
     aligned and not; K6 in its three modes against its plain versions
     bit for bit (costs, keys, and chain_query_topk's docids and keys at
     k = 1, 10, 32, 33, tile - 1 and tile, the top-k mode and the merge of
     its survivors, and at tile + 1 and N, the keys mode and the sort of
     all N) for T = 1, 2, 3, 4, 8 and 16 at N = 2^14 + 3, 2^19 and
     355,439, each in the unpadded layout (the direct path at an odd N) and the
     callers' padded one (the bulk path), with INF addends, unmatched and
     invalid columns and docids above 2^23;
  3. keyword path: the port's App ingests N synthetic hackernews documents
     (default 500,000, so D = 2^19) over POST /indexes/hn/documents,
     then 32 client threads send a fixed query set to
     POST /indexes/hn/search; every response must equal the port's host
     scorer, K1 must have launched, and the device path must have served
     with no device error;
  4. typo path: a second App ingests a corpus whose vocabulary holds
     2^20 distinct words (utils/synthetic.py::generate_large_vocab) over
     POST /indexes/typo/documents, then 32 client threads send typo
     queries to POST /indexes/typo/search; every response must equal the
     same store's answer with the host OSA pass, K3 must have launched,
     and no device error may occur;
  5. vector path (hn150k-bge768): a third App ingests 150,000 synthetic
     hackernews documents with a 768-dimension userProvided embedder
     (every 7th document two vectors: 171,429 rows, padded to 2^18 on the
     card) over POST /indexes/vec/documents, uploads the matrix
     (App.warm_devices), and 32 client threads send 20 hybrid searches
     (semanticRatio 1.0 and 0.5, with and without a filter) and 4
     /similar requests. Against the same store's numpy host pass: the
     float round must give the same hits (a group whose host scores lie
     within 1e-6 compared as a set), scores within 1e-5 and the same
     semanticHitCount, through the float leg; after PATCH settings
     switches the embedder to binaryQuantized, every response must be
     equal, through K4h; no device error may occur;
  6. timing: K1 and its plain version at D = 2^20, B = 32, T = 3, K1 per
     launch from the profiler's trace, cold (the L2 cache flushed first)
     and warm, five repeats; K3 and its plain version (byte for byte
     equal again) on the typo path's own resident vocabulary (n = 2^20,
     max_dist 2) for every word the typo pass put through K3, each launch
     timed from the profiler's trace of the pass's own call, cold and
     warm, beside the bound the function needs; the vocabulary's upload
     with its length order; and for the words nearest 5 and 10 letters
     the whole typo-pass device call split into query table, kernel,
     readback and numpy, and the host pass; K4h per launch in each mode
     (ham over every row; keyed, the mode of the binary leg's top-k,
     over the path's live rows), cold and warm, on the vector path's
     resident sign words (n = 2^18, W = 24), its plain versions (equal
     again) and each mode's bound; the float leg's device work, its
     torch.matmul alone, its bound; both legs' kernels by device time
     and their launches per call; both legs' whole search_async call and
     their numpy host passes;
  7. encoder path (hn150k-bgebase-hf): a checkpoint at
     BAAI/bge-base-en-v1.5's published width (BERT, vocab 30,522, hidden
     768, 12 layers, 12 heads, intermediate 3,072; seeded random weights,
     nothing downloaded) is written to a temporary directory; the port's
     encoder on the card must agree with the same checkpoint on the CPU
     within ENC_TOL on 80 texts; a fourth App ingests ENC_DOCS synthetic
     hackernews documents (100,000 of the configuration's 150,000) over HTTP with a huggingFace embedder on that
     checkpoint and Meilisearch's default documentTemplate, every document
     embedded at indexing on the card (wall time, tokens, tokens/s, peak
     device memory); the query texts are embedded on the card, then 8
     hybrid searches with a text q (semanticRatio 1.0 and 0.5, with and
     without a filter) are served one at a time and from 32 threads and
     must agree with the same store's host pass by the float round's rule;
     after a write of 1,000 documents and the scheduler's device warm, the
     new generation's matrix must be resident before the first search,
     whose time is printed beside the same request with the upload on its
     path; one query's forward and one indexing chunk are timed on the
     device clock, the chunk against its float32 bound;
  8. chain scorer and scatter-gather (run right after phase 3, on its
     store): `entry.entry()` once against the plain version;
     `entry.dryrun_multichip(1)` in a one-rank NCCL group over 500,000
     documents (keyword, typo, tie-block and filter top-10, facet
     histogram and vector top-10, each against the host), then each
     collective it made timed alone in a one-rank NCCL group; the executor
     path with MEILI_TPU_DEVICE=1 over the dry run's queries and QUERIES
     on phase 3's store (bound to the card), every response equal to
     MEILI_TPU_DEVICE=0 and K6 launched; K6 per launch in each mode,
     cold and warm, at T = 4 and the broadest query's candidate count
     (the cost mode on both paths), its bound and plain version, the
     whole chain_query_topk at k = 10 beside the keys mode and the sort
     of all N, and the whole run_device call against the host pass's
     run_raw; the survivors' merge (K6's select_kernel) per pass at the
     same shapes, its launches counted over entry() and the dry run; its
     wall time;
  9. XLM-R encoder path (hn50k-me5base-hf): a checkpoint at
     intfloat/multilingual-e5-base's published width (XLM-RoBERTa, vocab
     250,002, hidden 768, 12 layers, 12 heads, intermediate 3,072, 514
     positions, pad id 1; seeded random weights) with a seeded 250,002-piece
     SentencePiece-Unigram tokenizer.json (NFKC and NMT's precompiled
     character map, Strip, Replace, Metaspace, <s> $A </s>), both written
     here; the port's encoder on the card must agree with the CPU within
     ENC_TOL on 80 texts (accents, Cyrillic, CJK, Arabic, combining marks,
     runs of spaces, unknown characters, the empty string); a fifth App
     ingests 50,000 synthetic hackernews documents over HTTP with a
     huggingFace embedder on that checkpoint, every document embedded at
     indexing on the card (host tokenization apart from the forwards, wall
     time, tokens, tokens/s, peak device memory); 8 hybrid searches with a
     text q against the same store's host pass by the float round's rule,
     one at a time and from 32 threads; one query's forward and one
     indexing chunk on the device clock, the chunk against its float32
     bound;
  10. workloads: the 7 declarative workloads (workloads/tests/*.json)
     through meilisearch_tpu_torch.xtask.run_workload with every App
     bound to the card (its stores are under the device thresholds, so
     the batcher may answer every search on the host); any failure is
     fatal.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. The run fails if any
module of jax or of the JAX package is loaded at its end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import resource
import statistics
import subprocess
import sys
import threading
import time

K1_SOURCE = "meilisearch_tpu_torch/csrc/chain_keys.cu"
K1_REPLACES = "meilisearch_tpu/ops/pallas_scorer.py:256"
K3_SOURCE = "meilisearch_tpu_torch/csrc/osa.cu"
K3_REPLACES = "meilisearch_tpu/ops/device_osa.py:50"
K4H_SOURCE = "meilisearch_tpu_torch/csrc/hamming.cu"
K4H_REPLACES = "meilisearch_tpu/vector/store.py:388"
K6_SOURCE = "meilisearch_tpu_torch/csrc/chain_dp.cu"
K6_REPLACES = "meilisearch_tpu/ops/device_scorer.py:56"
# the survivors' merge replaces chain_query_topk's lax.sort of all N
K6_SELECT_REPLACES = "meilisearch_tpu/ops/device_scorer.py:206"
# the card's peaks for the bounds: HBM3 bytes/s (data sheet), int32 lanes
# (Hopper white paper: 64 INT32 units per SM, 132 SMs, 1.98 GHz), 32-bit
# population counts (16 per clock per SM, the CUDA C++ programming guide's
# throughput table for compute capability 9.0) and float32 outside the
# tensor cores (data sheet)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
POPC_OPS_S = 16 * 132 * 1.98e9
FP32_FLOP_S = 67e12
THREADS = 32
# the integer instructions per letter read of csrc/osa.cu's recurrence,
# counted in its sm_90a SASS (cuobjdump -sass): the transposition and
# diagonal-zero vectors and the deltas (nine LOP3, one add, three shifts)
# and the score at bit m - 1 (two shifts, two ands, one add) with its
# running minimum. Not counted: the match-mask lookup (a hash, a shared
# load, a compare), which another way of finding the mask could spare,
# and the loop's cut test and branch
OSA_OPS_PER_LETTER = 19
# the kernels, by name in a profiler trace
K1_KERNEL, K3_KERNEL, K4H_KERNEL = "chain_keys_kernel", "osa_kernel", "hamming_kernel"
K6_KERNEL = "chain_dp_kernel"
L2_FLUSH_BYTES = 256 << 20  # written before a cold launch: 5x the 50 MB L2
REPEATS = 5  # repeats of a kernel's cold and warm launches in the timing phase
# K4h's checked widths: 32, 96, 100, 384, 768 and 1536 dimensions
HAM_WIDTHS = (1, 3, 4, 12, 24, 48)
# launches that open a traced session, not timed, the first followed by a
# wait (launch_ms): the whole script's later sessions lost up to 26
SENTINELS = 32
TRACE_SETTLE_S = 0.25
# the chain scorer's checks: K6 at every T of this ladder, at these widths
# and at K6_BROAD_N, the candidates of the executor's broadest query
# ('show tell' on the keyword phase's 500,000 documents)
K6_TERMS = (1, 2, 3, 4, 8, 16)
K6_WIDTHS = ((1 << 14) + 3, 1 << 19)
K6_BROAD_N = 355_439
K6_TOPK = 10  # the k at which the top-k mode and chain_query_topk are timed
# K6's int32 operations per column, counted in csrc/chain_dp.cu with each
# compare folded into its predicate (ISETP with a predicate operand): the
# first term's 3 visits of 6 adds; each later term's 9 visits of 6 adds,
# 9 lexicographic mins of 12 compares and 6 selects, 3 mask selects and
# 4 skip adds; the final 3 mins and the clip; the keys mode's packing
K6_OPS_FIRST, K6_OPS_TERM, K6_OPS_FINAL, K6_OPS_PACK = 18, 223, 60, 30
# the dry run's depth: the keyword phase's
DRYRUN_DOCS = 500_000
# the dry run's queries (meilisearch_tpu_torch/entry.py), served through
# the executor with MEILI_TPU_DEVICE=1 beside QUERIES
CHAIN_QUERIES = [
    {"q": "rust database"}, {"q": "machin learnin"}, {"q": "zebra stripe"},
    {"q": "python", "filter": "points > 2500"}, {"q": "rust"},
]
# the typo path's vocabulary: above the device gate (2^19 words), and the
# n = 2^20 rows at which K3 is timed
TYPO_VOCAB_WORDS = 1 << 20
# the vector path's configuration, hn150k-bge768: 150,000 hackernews-like
# documents and a userProvided embedder of 768 dimensions, the width of
# BAAI/bge-base-en-v1.5 (Meilisearch's default huggingFace model); the
# vectors are seeded draws around 512 centres, every 7th document two
VEC_DOCS, VEC_DIM, VEC_CENTRES, VEC_BATCH, VEC_SEED = 150_000, 768, 512, 10_000, 2024
VEC_SETTINGS = {
    "searchableAttributes": ["title", "url", "author"],
    "filterableAttributes": ["points"],
    "embedders": {"default": {"source": "userProvided", "dimensions": VEC_DIM}},
}
VEC_TEXT = ["rust", "database", "machine learning", "cloud", "python web"]
# the encoder path, hn150k-bgebase-hf: the vector path's corpus with a
# huggingFace embedder at BAAI/bge-base-en-v1.5's published width (random
# weights from a seed, nothing downloaded) and Meilisearch's default
# documentTemplate; every document is embedded at indexing on the card.
# 100,000 of its 150,000 documents: the depth cut to keep the whole
# script near half of its time limit
BGE_CONFIG = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}
BGE_INIT_STD = 0.02  # BERT's initializer_range
ENC_DOCS, ENC_WRITE, ENC_SEED = 100_000, 1_000, 2025
ENC_TOL = 1e-4  # max abs error of normalized embeddings, card against the CPU
ENC_TEXT = ["rust compiler", "machine learning database", "cloud security", "python web"]
ENC_TIMED_TOKENS = 128  # tokens per text of the timed indexing chunk
# the XLM-R path, hn50k-me5base-hf: intfloat/multilingual-e5-base's
# published config.json (xlm-roberta-base's widths) with seeded random
# weights, a seeded 250,002-piece SentencePiece-Unigram tokenizer.json
# written as transformers' XLM-R converter writes it (NFKC and NMT's
# character map, Strip, Replace, Metaspace, <s> $A </s>), and 50,000
# hackernews documents embedded at indexing on the card
E5_CONFIG = {
    "model_type": "xlm-roberta", "vocab_size": 250_002, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu",
}
E5_DOCS, E5_SEED = 50_000, 2026
E5_TEXT = ["rust compiler", "machine learning database", "поиск cloud security",
           "python web 検索"]
# multilingual texts of the card-against-CPU check (accents, Cyrillic, CJK,
# Arabic, combining marks, runs of spaces, characters no piece holds, and
# the empty string)
E5_CHECK_TEXT = [
    "Café naïve résumé — déjà vu", "Ünïcödé façade coöperate",
    "Привет, мир! Поиск в базе данных", "Москва — столица России", "中文字 搜索引擎 数据库",
    "東京の検索エンジン 日本語", "한국어 검색 엔진", "مرحبا بالعالم بحث", "قاعدة البيانات",
    "élève q́̈", "ﬁne ½ ① Ａｂｃ ™",
    "runs    of     spaces\tand\ttabs\nnew\r\nlines", "   leading and trailing   ", "",
    "emoji \U0001F468‍\U0001F469‍\U0001F467 \U0001F44D\U0001F3FD \U0001F1EB\U0001F1F7"
    " ✈ \U0001D518\U0001D52B\U0001D526",
    "zero​width﻿bom", "Ελληνικά κείμενα", "हिन्दी खोज", "ქართული ტექსტი",
    "straße über " * 8, "<mask> and <s> inside </s>", "Ǆ ǅ ǆ İstanbul ΣΑΣ",
    "tab\there\x07bell\x01", "rust \U0001F680 machine learning ✨ data",
]
# the float round: a run of hits whose host scores lie within SCORE_TIE of
# each other is compared as a set (cuBLAS and numpy sum in other orders,
# which moves a float32 cosine by a few ulps); scores within SCORE_ATOL
SCORE_TIE, SCORE_ATOL = 1e-6, 1e-5
SETTINGS = {
    "searchableAttributes": ["title", "url", "author"],
    "filterableAttributes": ["author", "points", "num_comments"],
    "sortableAttributes": ["points", "created_at"],
}
QUERIES = [
    {"q": "rust"},  # one word
    {"q": "machine learning", "limit": 20},  # multi-word
    {"q": "open source database"},
    {"q": "deep neural network training"},
    {"q": "searhc engine"},  # typo
    {"q": "kubernets"},  # typo
    {"q": "performance benchark memory"},  # typo in a chain
    {"q": '"machine learning" model'},  # phrase
    {"q": "rust", "filter": "points > 1000"},  # filter
    {"q": "python web", "filter": "num_comments < 100", "limit": 30},
    {"q": "ai", "facets": ["author"]},  # facets
    {"q": "cloud", "facets": ["points"], "filter": "points > 2500"},
    {"q": "database", "sort": ["points:desc"]},  # sort
    {"q": "google", "sort": ["created_at:asc"], "limit": 15},
    {"q": "distributed systems", "matchingStrategy": "all"},
    {"q": "security privacy encryption", "matchingStrategy": "all"},
    {"q": "quantum research paper", "showRankingScore": True},
    {"q": "show tell", "showRankingScore": True, "offset": 5, "limit": 10},
]
COMPARED = ("estimatedTotalHits", "facetDistribution")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_phase() -> None:
    from meilisearch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    say(f"K1 + K3 + K4h + K6 build: {time.perf_counter() - t0:.3f} s"
        f" (nvcc {_build.build_seconds:.3f} s; 0 = already built)")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")


def kernel_phase(device) -> int:
    """K1 against chain_keys_torch on the card; returns the max abs error
    (0 when bit-exact; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs
    from meilisearch_tpu_torch.search.device_batch import T_LADDER

    worst = 0
    for D in (1 << 14, 1 << 20):
        for T in T_LADDER:
            args = kernel_args(scorer_inputs(T, D, 32, seed=1000 + T), device)
            got = chain_keys(*args, T=T)
            torch.cuda.synchronize()
            want = chain_keys_torch(*args, T=T)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            say(f"kernel D={D} B=32 T={T}: keys/candw/counts bit-exact={same}"
                f" max_abs_err={err} candidates={int(got[2].sum())}")
            if not same:
                raise AssertionError(f"K1 disagrees with chain_keys_torch at D={D} T={T}")
            worst = max(worst, err)
    return worst


def hamming_kernel_phase(device) -> int:
    """K4h's two modes against their plain versions on the card at
    n = 2^18 + 3 rows (not a multiple of a tile) of seeded words, bit 31
    set on half of them, for W = 1, 3, 4, 12, 24 and 48: the matrix
    16-byte aligned and, on a view one word in, not; the keyed mode at
    n_live = 1, n - 5 and n. Returns the max abs error (0 when equal,
    cosines and keys bit for bit; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops import hamming

    n, worst = (1 << 18) + 3, 0
    for W in HAM_WIDTHS:
        gen = torch.Generator().manual_seed(4000 + W)
        flat = torch.randint(-(1 << 31), 1 << 31, (n * W + 1,), generator=gen,
                             dtype=torch.int64).to(torch.int32).to(device)
        q = flat[-W:].clone()
        for mat in (flat[: n * W].view(n, W), flat[1:].view(n, W)):
            got = hamming.hamming_rows(mat, q)
            torch.cuda.synchronize()
            worst = max(worst, k4h_err(got, hamming.hamming_rows_torch(mat, q), f"ham W={W}"))
            for n_live in (1, n - 5, n):
                got = hamming.hamming_keyed(mat, q, 32 * W, n_live)
                torch.cuda.synchronize()
                want = hamming.hamming_keyed_torch(mat, q, 32 * W, n_live)
                worst = max(worst, k4h_err(got, want, f"keyed W={W} n_live={n_live}"))
    say(f"K4h n={n} W={','.join(map(str, HAM_WIDTHS))}, aligned and not: ham, and keyed at"
        f" n_live = 1, n - 5, n, bit for bit equal to the plain versions, max_abs_err={worst}")
    return worst


def k4h_err(got, want, what: str) -> float:
    """K4h's output, `ham` or the keyed mode's (cos, key), against its
    plain version's: raises unless every tensor is equal bit for bit;
    returns the max abs error (0)."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    bits = [(g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
            for g, w in pairs]
    if not all(torch.equal(g, w) for g, w in bits):
        raise AssertionError(f"K4h ({what}) disagrees with its plain version")
    return max(float((g.double() - w.double()).abs().max()) for g, w in pairs)


def osa_vocab(n: int, seed: int):
    """(mat (n, 32) int32, lens (n,) int32) numpy: seeded pseudo-words of
    lengths 0-32 over a small alphabet with a few non-ASCII codepoints
    (so matches and transpositions occur), zero rows past each length,
    and padding rows (length 0) at the end and at random."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.array([ord(c) for c in "abcdefghijklmn"] + [0xE9, 0xDF, 0x436, 0x1F600])
    weights = np.r_[np.full(14, 1.0), np.full(4, 0.25)]
    mat = alphabet[rng.choice(len(alphabet), size=(n, 32), p=weights / weights.sum())]
    lens = np.where(rng.random(n) < 0.8, rng.integers(3, 13, n), rng.integers(0, 33, n))
    lens[-4096:] = 0
    mat = np.where(np.arange(32)[None, :] < lens[:, None], mat, 0)
    return mat.astype(np.int32), lens.astype(np.int32)


def osa_queries(mat, lens, seed: int) -> list:
    """19 query words as codepoint lists: the empty word, a 32-letter
    word, 32 distinct codepoints up to U+1F600, 32 codepoints that share
    one slot under the query table's first multiplier (so the table must
    find another), and words taken from the vocabulary with 0-3 edits."""
    import numpy as np

    from meilisearch_tpu_torch.ops.device_osa import FIRST_MULT, SLOT_BITS

    def slot(c: int) -> int:
        return ((c * FIRST_MULT) & 0xFFFFFFFF) >> (32 - SLOT_BITS)

    rng = np.random.default_rng(seed)
    distinct = [ord(c) for c in "abcdefghijklmn"] + [0xE9, 0xDF, 0x436, 0x1F600]
    distinct += [0x41 + k for k in range(14)]
    collide = [c for c in range(0x61, 0x40000) if slot(c) == slot(0x61)][:32]
    out = [[], mat[int(np.flatnonzero(lens == 32)[0])].tolist(), distinct, collide]
    rows = rng.choice(np.flatnonzero(lens >= 4), size=15, replace=False)
    for k, r in enumerate(rows):
        w = mat[r, : lens[r]].tolist()
        for _ in range(k % 4):
            i = int(rng.integers(1, len(w)))
            if rng.random() < 0.5:
                w[i - 1], w[i] = w[i], w[i - 1]  # a transposition
            else:
                w[i] = int(mat[int(rng.integers(0, len(mat))), 0] or 0x61)
        out.append(w)
    return out


def osa_kernel_phase(device) -> int:
    """K3 against osa_device_torch on the card at n = 2^20 (the rows
    resident with their length order, as the typo path keeps them), and
    three queries against the host pass on 2^16 words; returns the max abs
    error (0 when byte-exact; anything else raises)."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops.device_osa import DeviceVocab, osa_device, osa_device_torch
    from meilisearch_tpu_torch.ops.levenshtein import osa_distances

    mat_np, lens_np = osa_vocab(1 << 20, seed=11)
    say(f"K3 edge-case vocabulary, 2^20 rows: {warp_lengths(lens_np)}")
    dv = DeviceVocab(mat_np, lens_np, device)
    mat, lens = dv.mat, dv.lens
    worst, checked = 0, 0
    for qi, word in enumerate(osa_queries(mat_np, lens_np, seed=12)):
        q = np.zeros(32, np.int32)
        q[: len(word)] = word
        qt = torch.from_numpy(q)  # the kernel takes the query on the host
        for max_dist in (1, 2):
            got = osa_device(mat, lens, qt, len(word), max_dist, dv.order)
            torch.cuda.synchronize()
            want = osa_device_torch(mat, lens, qt.to(device), len(word), max_dist)
            err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K3 disagrees with osa_device_torch: m={len(word)}")
            worst = max(worst, err)
            checked += 1
            if qi in (3, 4, 11):
                # the host pass on real (non-padding) rows of a 2^16 slice
                sl = slice(0, 1 << 16)
                real = lens_np[sl] > 0
                text = "".join(map(chr, word))
                full_h, prefix_h = osa_distances(text, mat_np[sl], lens_np[sl], max_dist)
                for g, h in zip(got, (full_h, prefix_h)):
                    if not np.array_equal(g[sl].cpu().numpy()[real], h[real]):
                        raise AssertionError(
                            f"K3 disagrees with the host pass: m={len(word)}"
                        )
                say(f"K3 m={len(word)} max_dist={max_dist}: equal to the host pass"
                    f" on {int(real.sum())} words of a 2^16 slice")
    say(f"K3 n=2^20: {checked} (query, max_dist) cases byte-exact against"
        f" osa_device_torch, max_abs_err={worst}")
    return worst


def _strip(res: dict) -> dict:
    hits = res["hits"]
    out = {
        "ids": [h["id"] for h in hits],
        "scores": [h.get("_rankingScore") for h in hits],
    }
    for key in COMPARED:
        out[key] = res.get(key)
    return out


def ingest(app, client, n_docs: int):
    """Index `n_docs` synthetic hackernews documents as "hn" over
    POST /indexes/hn/documents; returns the index's store."""
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.search.device_batch import _plane_docs

    client.update_settings("hn", SETTINGS)
    t0 = time.perf_counter()
    docs = generate_hackernews_like(n_docs)
    say(f"corpus: {n_docs} docs generated in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    uid = None
    for i in range(0, n_docs, 100_000):
        res = client.post("/indexes/hn/documents", body=docs[i : i + 100_000])
        if res.status != 202:
            raise AssertionError(f"ingest refused: {res.status} {res.json}")
        uid = res.json["taskUid"]
    del docs
    task = app.scheduler.wait_for_task(uid, timeout=900.0)
    ingest_s = time.perf_counter() - t0
    if task.to_json()["status"] != "succeeded":
        raise AssertionError(f"ingest failed: {task.to_json()}")
    store = app.scheduler.index("hn")
    say(f"ingest: {n_docs} docs over HTTP in {ingest_s:.3f} s"
        f" ({n_docs / ingest_s:.1f} docs/s), plane width D={_plane_docs(store)}")
    return store


def main_path_phase(device, n_docs: int) -> dict:
    """Boot the port's App, ingest, serve QUERIES from THREADS clients and
    hold every response against the host scorer."""
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.ops.chain_keys import LAUNCHES
    from meilisearch_tpu_torch.search.device_batch import serving_stats, warm_kernels
    from meilisearch_tpu_torch.search.perform import perform_search, perform_search_many

    app = App(device=device)
    try:
        client = TestClient(app)
        store = ingest(app, client, n_docs)
        t0 = time.perf_counter()
        if not warm_kernels(store, app.device, wait=True):
            raise AssertionError("the bucket's kernels did not warm")
        say(f"warm: {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        expected = [_strip(perform_search(store, dict(q))) for q in QUERIES]
        say(f"host reference answers: {time.perf_counter() - t0:.3f} s")
        # one forced device drain registers every query's planes in the pool
        t0 = time.perf_counter()
        first = perform_search_many(
            store, [dict(q) for q in QUERIES], device=app.device, force_device=True
        )
        if [_strip(r) for r in first] != expected:
            raise AssertionError("the first device drain differs from the host scorer")
        say(f"first device drain (row registration): {time.perf_counter() - t0:.3f} s")

        serving_stats(reset=True)
        LAUNCHES.reset()
        answers, errors = serve(client, [("/indexes/hn/search", q) for q in QUERIES])
        launches = LAUNCHES.value
        stats = serving_stats()
        if errors:
            raise AssertionError(f"client threads failed: {errors[:3]}")
        say(f"serving stats: {json.dumps(stats)}")
        say(f"K1 launches during the main path: {launches}")

        bad = 0
        for qi, status, body in answers:
            if status != 200 or _strip(body) != expected[qi]:
                bad += 1
                if bad <= 3:
                    say(f"MISMATCH {QUERIES[qi]}: status {status}")
        say(f"responses equal to the host scorer: {len(answers) - bad}/{len(answers)}")
        if bad:
            raise AssertionError(f"{bad} responses differ from the host scorer")
        if launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        if stats["device_served"] <= 0 or stats["device_errors"] != 0:
            raise AssertionError(f"device path did not serve cleanly: {stats}")
        # the store and its host answers serve phase 8's executor path
        return {"launches": launches, "store": store, "expected": expected}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def typo_path_phase(device, n_words: int) -> dict:
    """A second App whose index vocabulary holds `n_words` distinct words:
    32 clients send typo queries; every response must equal the same
    store's answer with the host OSA pass, and K3 must have launched.
    Returns K3's launches, the store (its vocabulary stays resident on the
    device) and the words the typo pass put through K3."""
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.ops import device_osa
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.search.perform import perform_search
    from meilisearch_tpu_torch.utils.synthetic import generate_large_vocab

    app = App(device=device)
    try:
        client = TestClient(app)
        client.update_settings("typo", {"searchableAttributes": ["title"]})
        t0 = time.perf_counter()
        _vocab, docs, queries = generate_large_vocab(n_words)
        say(f"typo corpus: {len(docs)} docs over a {n_words}-word vocabulary,"
            f" generated in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        res = client.post("/indexes/typo/documents", body=docs)
        if res.status != 202:
            raise AssertionError(f"ingest refused: {res.status} {res.json}")
        task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
        if task.to_json()["status"] != "succeeded":
            raise AssertionError(f"ingest failed: {task.to_json()}")
        del docs
        store = app.scheduler.index("typo")
        n_base = len(store.vocab_snapshot().base_words)
        say(f"typo ingest: {time.perf_counter() - t0:.3f} s over HTTP,"
            f" base vocabulary {n_base} words")
        if n_base < device_osa.MIN_DEVICE_VOCAB:
            raise AssertionError("the vocabulary is below the device OSA gate")

        # the answers with the host OSA pass, then cold derivation caches
        # so the served queries run the typo pass again, on the device
        t0 = time.perf_counter()
        store.device = None
        expected = [_strip(perform_search(store, dict(q))) for q in queries]
        store.device = app.device
        store._derivation_store_cache = None
        store._derivation_merge_cache = None
        say(f"host OSA pass answers: {time.perf_counter() - t0:.3f} s,"
            f" hits per query {[len(e['ids']) for e in expected]}")
        if not all(e["ids"] for e in expected):
            raise AssertionError("a typo query found nothing on the host pass")

        serving_stats(reset=True)
        device_osa.LAUNCHES.reset()
        answers, errors = serve(client, [("/indexes/typo/search", q) for q in queries])
        launches = device_osa.LAUNCHES.value
        stats = serving_stats()
        if errors:
            raise AssertionError(f"client threads failed: {errors[:3]}")
        bad = sum(
            1 for qi, status, body in answers
            if status != 200 or _strip(body) != expected[qi]
        )
        say(f"typo path: {len(answers) - bad}/{len(answers)} responses equal to"
            f" the host OSA pass; K3 launches {launches}; serving stats"
            f" {json.dumps(stats)}")
        if bad:
            raise AssertionError(f"{bad} typo responses differ from the host pass")
        if launches <= 0:
            raise AssertionError("K3 was not launched on the typo path")
        if stats["device_errors"] != 0:
            raise AssertionError(f"device errors on the typo path: {stats}")
        # every cold term with a typo budget ran the device pass once
        # (keys: word, max_typo, is_prefix, is_ngram)
        terms = store._derivation_store_cache["base_terms"]
        words = sorted({key[0] for key in terms if key[1] >= 1})
        return {"launches": launches, "store": store, "words": words}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def serve(client, requests: list, rounds: int = 2) -> tuple[list, list]:
    """THREADS clients each send every (path, body) POST request `rounds`
    times, in rotated orders; returns ([(request index, status, body)],
    [errors])."""
    answers: list = []
    latencies: list = []
    errors: list = []
    lock = threading.Lock()

    def client_loop(k: int) -> None:
        try:
            for r in range(rounds):
                for j in range(len(requests)):
                    qi = (j + k + r) % len(requests)
                    path, body = requests[qi]
                    t = time.perf_counter()
                    res = client.post(path, body=dict(body))
                    dt = time.perf_counter() - t
                    with lock:
                        answers.append((qi, res.status, res.json))
                        latencies.append(dt)
        except BaseException as err:  # noqa: BLE001 — reported by the caller
            with lock:
                errors.append(repr(err))

    threads = [threading.Thread(target=client_loop, args=(k,)) for k in range(THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish")
    lat = sorted(latencies) or [0.0]
    say(f"served {len(answers)} requests from {THREADS} threads in {wall:.3f} s:"
        f" {len(answers) / wall:.2f} QPS, p50 {lat[len(lat) // 2] * 1e3:.3f} ms,"
        f" p99 {lat[int(len(lat) * 0.99)] * 1e3:.3f} ms")
    return answers, errors


def vector_batch(docs: list, start: int, centres) -> list:
    """docs[start : start + VEC_BATCH] with their `_vectors`: seeded draws
    around the centres (noise 0.5 a dimension), two for every 7th
    document; built just before the batch is posted."""
    import numpy as np

    rng = np.random.default_rng([VEC_SEED, start])
    batch = docs[start : start + VEC_BATCH]
    counts = [2 if (start + i) % 7 == 0 else 1 for i in range(len(batch))]
    rows = centres[rng.integers(0, len(centres), sum(counts))]
    rows = rows + 0.5 * rng.standard_normal(rows.shape, dtype=np.float32)
    out, r = [], 0
    for doc, k in zip(batch, counts):
        vecs = rows[r : r + k].tolist()
        out.append({**doc, "_vectors": {"default": vecs if k == 2 else vecs[0]}})
        r += k
    return out


def vector_requests(store) -> list:
    """The vector path's 24 requests: for 5 stored vectors (plus noise),
    hybrid at semanticRatio 1.0 and, with a text q, 0.5, each with and
    without `filter` (the full-column leg), limit 20, offset 10 for every
    other one, showRankingScore; and 4 POST /similar, 2 filtered."""
    import numpy as np

    rng = np.random.default_rng(VEC_SEED + 1)
    ids = rng.choice(VEC_DOCS, 9, replace=False)
    per_doc = store.vectors["default"]
    out = []
    for r in range(5):
        base = per_doc[store.external_to_internal[str(ids[r])]][0]
        vec = (base + 0.05 * rng.standard_normal(VEC_DIM)).astype(np.float32).tolist()
        for ratio in (1.0, 0.5):
            for filt in (None, "points > 1000"):
                body = {"vector": vec, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "limit": 20, "offset": 10 * (r % 2), "showRankingScore": True}
                if ratio < 1.0:
                    body["q"] = VEC_TEXT[r]
                if filt:
                    body["filter"] = filt
                out.append(("/indexes/vec/search", body))
    for j, doc_id in enumerate(ids[5:]):
        body = {"id": int(doc_id), "embedder": "default", "limit": 20,
                "offset": 10 * (j % 2), "showRankingScore": True}
        if j >= 2:
            body["filter"] = "points > 1000"
        out.append(("/indexes/vec/similar", body))
    return out


def _vector_answer(body: dict) -> tuple:
    hits = body["hits"]
    return ([h["id"] for h in hits], [h["_rankingScore"] for h in hits],
            body.get("semanticHitCount"))


def _same_within_ties(got: tuple, want: tuple) -> bool:
    """The float round's rule: semanticHitCount equal, scores within
    SCORE_ATOL, ids in order except inside a run of hits whose host
    scores lie within SCORE_TIE of each other, compared as a set."""
    ids_g, sc_g, shc_g = got
    ids_w, sc_w, shc_w = want
    if shc_g != shc_w or len(ids_g) != len(ids_w):
        return False
    if any(abs(a - b) > SCORE_ATOL for a, b in zip(sc_g, sc_w)):
        return False
    start = 0
    for i in range(1, len(ids_w) + 1):
        if i == len(ids_w) or abs(sc_w[i] - sc_w[i - 1]) > SCORE_TIE:
            if set(ids_g[start:i]) != set(ids_w[start:i]):
                return False
            start = i
    return True


def _request_kind(path: str, body: dict) -> str:
    kind = "similar" if path.endswith("/similar") else f"ratio {body['hybrid']['semanticRatio']}"
    return kind + (" filtered" if "filter" in body else "")


def one_by_one(client, requests: list, label: str) -> list:
    """Each request once, one at a time; prints the median ms by kind and
    returns the answers (each must be 200 with hits)."""
    answers, by_kind = [], {}
    for path, body in requests:
        t = time.perf_counter()
        res = client.post(path, body=dict(body))
        by_kind.setdefault(_request_kind(path, body), []).append((time.perf_counter() - t) * 1e3)
        if res.status != 200 or not res.json["hits"]:
            raise AssertionError(f"{label}: {path} {res.status} {str(res.json)[:300]}")
        answers.append(_vector_answer(res.json))
    say(f"{label}, one request at a time, median ms by kind: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in sorted(by_kind.items())))
    return answers


def vector_round(app, client, store, requests: list, exact: bool) -> dict:
    """The expected answers from the same store with its device unbound
    (the numpy host pass), then the requests one at a time on the card
    (timed), then THREADS clients on the card; every answer must agree
    (exactly, or by the float round's rule). Returns the K4h launches and
    float-leg calls of the served run."""
    from meilisearch_tpu_torch.ops import hamming
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.vector import store as vstore

    store.device = None
    expected = one_by_one(client, requests, "host pass")
    store.device = app.device
    say(f"host pass semanticHitCount {[e[2] for e in expected]}")
    one_by_one(client, requests, "on the card")

    serving_stats(reset=True)
    hamming.LAUNCHES.reset()
    vstore.FLOAT_LEGS.reset()
    # one round a client: 768 requests (two took 160-250 s of the run)
    answers, errors = serve(client, requests, rounds=1)
    launches, float_legs = hamming.LAUNCHES.value, vstore.FLOAT_LEGS.value
    stats = serving_stats()
    if errors:
        raise AssertionError(f"client threads failed: {errors[:3]}")
    bad = reordered = 0
    for qi, status, body in answers:
        if status != 200:
            bad += 1
            continue
        got = _vector_answer(body)
        same = got == expected[qi]
        if not same and not exact and _same_within_ties(got, expected[qi]):
            same, reordered = True, reordered + (got[0] != expected[qi][0])
        if not same:
            bad += 1
            if bad <= 3:
                path, req = requests[qi]
                say(f"MISMATCH {_request_kind(path, req)}: got {got}, want {expected[qi]}")
    kind = "binary (exact)" if exact else "float (ids within ties, scores 1e-5)"
    say(f"vector path, {kind}: {len(answers) - bad}/{len(answers)} responses agree with"
        f" the host pass ({reordered} with ids reordered within a tie group); K4h launches {launches},"
        f" float-leg calls {float_legs}; serving stats {json.dumps(stats)}")
    if bad:
        raise AssertionError(f"{bad} vector responses differ from the host pass")
    if stats["device_errors"] != 0:
        raise AssertionError(f"device errors on the vector path: {stats}")
    return {"launches": launches, "float_legs": float_legs}


def vector_path_phase(device) -> dict:
    """hn150k-bge768 through a third App: ingest over HTTP, upload, serve
    the float round, switch the embedder to binaryQuantized, serve the
    binary round. Returns K4h's launches and the two searchers (the
    float one keeps its resident matrix for the timing phase)."""
    import numpy as np

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.store import VectorSearcher

    app = App(device=device)
    try:
        client = TestClient(app)
        client.update_settings("vec", VEC_SETTINGS)
        t0 = time.perf_counter()
        docs = generate_hackernews_like(VEC_DOCS, seed=VEC_SEED)
        centres = np.random.default_rng(VEC_SEED).standard_normal(
            (VEC_CENTRES, VEC_DIM), dtype=np.float32
        )
        uid = None
        for start in range(0, VEC_DOCS, VEC_BATCH):
            res = client.post("/indexes/vec/documents", body=vector_batch(docs, start, centres))
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            uid = res.json["taskUid"]
        del docs
        task = app.scheduler.wait_for_task(uid, timeout=900.0)
        if task.to_json()["status"] != "succeeded":
            raise AssertionError(f"ingest failed: {task.to_json()}")
        store = app.scheduler.index("vec")
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        say(f"vector ingest: {VEC_DOCS} docs with {VEC_DIM}-dim vectors over HTTP in"
            f" {time.perf_counter() - t0:.3f} s (generation included); process peak RSS"
            f" {rss_gb:.3f} GiB")
        t0 = time.perf_counter()
        app.warm_devices()
        float_searcher = VectorSearcher(store, "default")
        m_dev, n = float_searcher._device[("matrix", app.device)]
        say(f"warm_devices (float matrix upload): {time.perf_counter() - t0:.3f} s;"
            f" {n} rows, {m_dev.shape[0]} on the card, {m_dev.numel() * 4 / 1e6:.1f} MB")
        if n != VEC_DOCS + (VEC_DOCS + 6) // 7:
            raise AssertionError(f"unexpected rows: {n}")
        requests = vector_requests(store)
        float_round = vector_round(app, client, store, requests, exact=False)
        if float_round["float_legs"] <= 0:
            raise AssertionError("the float leg did not run on the vector path")

        t0 = time.perf_counter()
        res = client.update_settings("vec", {"embedders": {"default": {"binaryQuantized": True}}})
        if res["status"] != "succeeded":
            raise AssertionError(f"the switch to binaryQuantized failed: {res}")
        say(f"PATCH settings binaryQuantized: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        app.warm_devices()
        binary_searcher = VectorSearcher(store, "default")
        if not binary_searcher.quantized:
            raise AssertionError("the embedder is not binary-quantized")
        say(f"warm_devices (sign words pack + upload): {time.perf_counter() - t0:.3f} s")
        binary_round = vector_round(app, client, store, requests, exact=True)
        if binary_round["launches"] <= 0:
            raise AssertionError("K4h was not launched on the vector path")
        query = np.asarray(requests[0][1]["vector"], np.float32)
        return {"launches": binary_round["launches"], "float": float_searcher,
                "binary": binary_searcher, "query": query / np.linalg.norm(query)}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def bge_vocab() -> list:
    """30,522 WordPiece entries laid out as bert-base-uncased's vocab.txt
    begins ([PAD], [unused0-98], [UNK], [CLS], [SEP], [MASK]), then the
    printable ASCII characters, the corpus's words and the template's
    field names, every character's ## piece, then filler."""
    from meilisearch_tpu_torch.utils.synthetic import WORDS

    chars = [chr(c) for c in range(33, 127)]
    words = WORDS + "title url author https example com user".split()
    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = list(dict.fromkeys(vocab + chars + words + ["##" + c for c in chars]))
    n = BGE_CONFIG["vocab_size"]
    return vocab + [f"filler{i}" for i in range(n - len(vocab))]


def random_state_dict(config: dict, seed: int) -> dict:
    """BERT's (and XLM-R's) initialization of a model of `config`: weights
    normal(0, BGE_INIT_STD) from a seeded torch.Generator, biases 0,
    LayerNorm scales 1."""
    import torch

    from meilisearch_tpu_torch.models.bert import BertModel

    model = BertModel(config)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g) * BGE_INIT_STD)
    return model.state_dict()


def write_bge_checkpoint(path: str) -> None:
    """A checkpoint of bge-base's width, written as pytorch_model.bin with
    its vocab."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, BGE_CONFIG, random_state_dict(BGE_CONFIG, ENC_SEED), bge_vocab(),
                     do_lower_case=True)


def e5_charsmap() -> bytes:
    """sentencepiece's nmt_nfkc map as far as the stdlib knows it: every
    code point that NFKC changes, the NMT rules' control characters
    (dropped) and odd spaces (a space), and two-character clusters that
    compose."""
    import unicodedata

    from meilisearch_tpu_torch.models.fixtures import build_charsmap

    mapping = {}
    for cp in range(1, 0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        norm = unicodedata.normalize("NFKC", ch)
        if norm != ch:
            mapping[ch] = norm
    for cp in [*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F]:
        mapping[chr(cp)] = ""
    for cp in [0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029, 0xFEFF]:
        mapping[chr(cp)] = " "
    for base in "aeiouAEIOU":
        for mark in "\u0300\u0301\u0308":
            mapping[base + mark] = unicodedata.normalize("NFC", base + mark)
    return build_charsmap(mapping)


def e5_pieces() -> list:
    """249,997 (piece, score) entries: every character of the scripts the
    check texts use, alone and after U+2581, the corpus's words and their
    halves, then seeded pieces of 2 to 6 characters of the same alphabet
    to the vocabulary's size; scores seeded (words above characters above
    the rest)."""
    import numpy as np

    from meilisearch_tpu_torch.utils.synthetic import WORDS

    rng = np.random.default_rng(E5_SEED)
    alphabet = [chr(c) for c in [*range(33, 127), *range(0xC0, 0x180), *range(0x391, 0x3CA),
                                 *range(0x410, 0x450), *range(0x621, 0x64B), *range(0x905, 0x940),
                                 *range(0x10D0, 0x10F1), *range(0x3041, 0x3097),
                                 *range(0x30A1, 0x30FB), *range(0x4E00, 0x5A00),
                                 *range(0xAC00, 0xB000)]]
    words = WORDS + "title url author https example com user".split()
    scores = {}
    for w in words:
        for piece in ("▁" + w, w[: len(w) // 2], w[len(w) // 2:]):
            scores.setdefault(piece, float(rng.uniform(-8.0, -4.0)))
    for ch in alphabet:
        scores.setdefault("▁" + ch, float(rng.uniform(-12.0, -9.0)))
        scores.setdefault(ch, float(rng.uniform(-12.0, -9.0)))
    scores.setdefault("▁", -3.0)
    n = E5_CONFIG["vocab_size"] - 5  # <s> <pad> </s> <unk> ... <mask>
    chars = alphabet[:94 + 192]  # ASCII and Latin letters
    while len(scores) < n:
        idx = rng.integers(0, len(chars), (1 << 16, 6)).tolist()
        lens = rng.integers(2, 7, 1 << 16).tolist()
        spaced = (rng.random(1 << 16) < 0.5).tolist()
        draws = rng.uniform(-16.0, -10.0, 1 << 16).tolist()
        for row, k, sp, score in zip(idx, lens, spaced, draws):
            piece = ("▁" if sp else "") + "".join([chars[i] for i in row[:k]])
            scores.setdefault(piece, score)
    return list(scores.items())[:n]


def write_e5_checkpoint(path: str) -> None:
    """A checkpoint of multilingual-e5-base's width (XLM-R), written as
    pytorch_model.bin with its 250,002-piece Unigram tokenizer.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import xlmr_tokenizer_json

    write_checkpoint(path, E5_CONFIG, random_state_dict(E5_CONFIG, E5_SEED),
                     tokenizer_json=xlmr_tokenizer_json(e5_pieces(), e5_charsmap()))


def encoder_check(path: str, device, texts: list, width: str = "bge-base") -> float:
    """The checkpoint's normalized embeddings of `texts` on the card against
    the CPU; returns the max abs error (fails above ENC_TOL)."""
    import numpy as np

    from meilisearch_tpu_torch.models.hf_encoder import TextEncoder, encoder

    t0 = time.perf_counter()
    got = encoder(path, "useModel", device).encode(texts)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = TextEncoder(path, "useModel", device=None).encode(texts)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    say(f"encoder check: {len(texts)} texts at {width} width, card against CPU: max abs"
        f" error {err:.3e} (bound {ENC_TOL:g}); card {t_card:.3f} s (load included),"
        f" CPU {t_cpu:.3f} s (load included)")
    if not err <= ENC_TOL:
        raise AssertionError(f"the encoder on the card is {err:.3e} off the CPU")
    return err


def encoder_requests(index: str = "enc", queries: tuple = tuple(ENC_TEXT)) -> list:
    """An encoder path's 8 hybrid requests: 4 text queries at semanticRatio
    1.0 and 0.5, the last two filtered; limit 20, offset 10 for every other
    one, showRankingScore."""
    out = []
    for r, q in enumerate(queries):
        for ratio in (1.0, 0.5):
            body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                    "limit": 20, "offset": 10 * (r % 2), "showRankingScore": True}
            if r >= 2:
                body["filter"] = "points > 1000"
            out.append((f"/indexes/{index}/search", body))
    return out


def encoder_path_phase(device, card: str, n_docs: int) -> dict:
    """hn150k-bgebase-hf through a fourth App: (a) a bge-base-width
    checkpoint; (b) the encoder on the card against the CPU; (c) n_docs
    documents embedded at indexing on the card; (d) hybrid searches with a
    text q against the same store's host pass; (e) the first request
    after a write, with the scheduler's warm and without it; (f) the
    forward's timing."""
    import tempfile

    import numpy as np
    import torch

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector import embedders
    from meilisearch_tpu_torch.vector import store as vstore
    from meilisearch_tpu_torch.vector.templates import render_document_template

    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        write_bge_checkpoint(path)
        say(f"bge-base-width checkpoint (seeded random weights) written in"
            f" {time.perf_counter() - t0:.3f} s")
        docs = generate_hackernews_like(n_docs + ENC_WRITE, seed=ENC_SEED)
        searchable = set(VEC_SETTINGS["searchableAttributes"])
        texts = [render_document_template(None, d, searchable) for d in docs[:64]]
        err = encoder_check(path, device, texts + [q for q in ENC_TEXT] + VEC_TEXT * 2
                            + [d["title"] for d in docs[64:66]])

        app = App(device=device)
        try:
            client = TestClient(app)
            settings = {**VEC_SETTINGS, "embedders": {"default": {
                "source": "huggingFace", "model": path}}}
            client.update_settings("enc", settings)
            enc = hf_encoder.encoder(path, "useModel", device)
            texts0, tokens0, seconds0 = enc.texts, enc.tokens, enc.seconds
            hf_encoder.FORWARDS.reset()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = client.post("/indexes/enc/documents", body=docs[:n_docs])
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"ingest failed: {task.to_json()}")
            ingest_s = time.perf_counter() - t0
            forwards = hf_encoder.FORWARDS.value
            n_texts, tokens = enc.texts - texts0, enc.tokens - tokens0
            embed_s = enc.seconds - seconds0
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            store = app.scheduler.index("enc")
            say(f"encoder ingest: {n_docs} docs over HTTP in {ingest_s:.3f} s; embedded on the"
                f" card at indexing: {n_texts} texts, {tokens} tokens ({tokens / max(n_texts, 1):.1f}"
                f" a text) in {embed_s:.3f} s ({tokens / embed_s:.1f} tokens/s), {forwards}"
                f" forwards of up to {enc.chunk_texts()} texts; peak device memory {peak:.3f} GiB")
            if n_texts != n_docs or forwards <= 0 or len(store.vectors["default"]) != n_docs:
                raise AssertionError("the documents were not all embedded on the card")
            if next(enc._model.parameters()).device != device:
                raise AssertionError("the encoder is not on the card")
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the ingest did not end")

            # (d) the query vectors embedded on the card, then both passes
            # read them from the embed cache
            requests = encoder_requests()
            hf_encoder.FORWARDS.reset()
            embedder = embedders.get_embedder(store, "default")
            for q in ENC_TEXT:
                embedder.embed_search(q)
            if hf_encoder.FORWARDS.value != len(ENC_TEXT):
                raise AssertionError("the queries were not embedded on the card")
            serving = vector_round(app, client, store, requests, exact=False)
            if serving["float_legs"] <= 0:
                raise AssertionError("the float leg did not run on the encoder path")

            # (e) fault 3.5: a write, then the first request of the new
            # generation with the scheduler's warm, and with it dropped
            body = dict(requests[0][1])
            texts1 = enc.texts
            t0 = time.perf_counter()
            res = client.post("/indexes/enc/documents", body=docs[n_docs:])
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"the write failed: {task.to_json()}")
            write_s = time.perf_counter() - t0
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the write did not end")
            warm_s = time.perf_counter() - t0 - write_s
            searcher = vstore.VectorSearcher(store, "default")
            if searcher._device.get(("matrix", device)) is None:
                raise AssertionError("the new generation's matrix is not resident after the write")

            def timed():
                t = time.perf_counter()
                res = client.post("/indexes/enc/search", body=dict(body))
                return (time.perf_counter() - t) * 1e3, res

            t_first, first = timed()  # the new generation's host caches are cold
            t_again, again = timed()
            # as the parent's scheduler left a write: no matrix for the new
            # generation, so the request builds it and uploads it
            store._vector_searcher_cache.pop("default")
            t_upload, upload = timed()
            if any(r.status != 200 or r.json["hits"] != first.json["hits"]
                   for r in (first, again, upload)):
                raise AssertionError("the requests after the write failed or differ")
            say(f"fault 3.5: a write of {ENC_WRITE} docs took {write_s:.3f} s ({enc.texts - texts1}"
                f" texts embedded: every engine-embedded document again), the scheduler's device"
                f" warm {warm_s:.3f} s after it; the same hybrid request (ratio 1.0, q cached)"
                f" after it: first {t_first:.3f} ms (matrix resident, host caches cold), again"
                f" {t_again:.3f} ms, then with the generation's matrix dropped (built and"
                f" uploaded on the request's path, as before the warm) {t_upload:.3f} ms")
            stats = serving_stats()
            if stats["device_errors"] != 0:
                raise AssertionError(f"device errors on the encoder path: {stats}")
            timing = encoder_timing(enc, device, card)
        finally:
            app.search_batcher.stop()
            app.scheduler.stop()
    return {"err": err, "forwards": forwards, **timing}


def xlmr_path_phase(device, card: str, n_docs: int) -> dict:
    """hn50k-me5base-hf through a fifth App: (a) a checkpoint of
    multilingual-e5-base's width and its Unigram tokenizer.json; (b) the
    encoder on the card against the CPU on 80 texts; (c) n_docs documents
    embedded at indexing on the card; (d) hybrid searches with a text q
    against the same store's host pass; (e) the forward's timing."""
    import tempfile

    import torch

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.models.unigram import Unigram
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector import embedders
    from meilisearch_tpu_torch.vector.templates import render_document_template

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        write_e5_checkpoint(path)
        say(f"multilingual-e5-base-width checkpoint (XLM-R, seeded random weights, a"
            f" {E5_CONFIG['vocab_size']}-piece Unigram tokenizer.json) written in"
            f" {time.perf_counter() - t0:.3f} s")
        docs = generate_hackernews_like(n_docs, seed=E5_SEED)
        searchable = set(VEC_SETTINGS["searchableAttributes"])
        texts = [render_document_template(None, d, searchable) for d in docs[:48]]
        texts += E5_TEXT * 2 + E5_CHECK_TEXT
        err = encoder_check(path, device, texts, "multilingual-e5-base")

        serving_stats(reset=True)
        app = App(device=device)
        try:
            client = TestClient(app)
            settings = {**VEC_SETTINGS, "embedders": {"default": {
                "source": "huggingFace", "model": path}}}
            client.update_settings("e5", settings)
            enc = hf_encoder.encoder(path, "useModel", device)
            if not isinstance(enc._tokenizer, Unigram):
                raise AssertionError("the checkpoint's Unigram tokenizer was not chosen")
            before = (enc.texts, enc.tokens, enc.seconds, enc.tokenize_seconds)
            hf_encoder.FORWARDS.reset()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = client.post("/indexes/e5/documents", body=docs)
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"ingest failed: {task.to_json()}")
            ingest_s = time.perf_counter() - t0
            forwards = hf_encoder.FORWARDS.value
            n_texts, tokens = enc.texts - before[0], enc.tokens - before[1]
            embed_s, tok_s = enc.seconds - before[2], enc.tokenize_seconds - before[3]
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            store = app.scheduler.index("e5")
            say(f"XLM-R ingest on {card}: {n_docs} docs over HTTP in {ingest_s:.3f} s; embedded on"
                f" the card at indexing: {n_texts} texts, {tokens} tokens ({tokens / max(n_texts, 1):.1f}"
                f" a text) in {embed_s:.3f} s ({tokens / embed_s:.1f} tokens/s), of which host"
                f" tokenization (Unigram) {tok_s:.3f} s and the rest {embed_s - tok_s:.3f} s;"
                f" {forwards} forwards of up to {enc.chunk_texts()} texts; peak device memory"
                f" {peak:.3f} GiB")
            if n_texts != n_docs or forwards <= 0 or len(store.vectors["default"]) != n_docs:
                raise AssertionError("the documents were not all embedded on the card")
            if next(enc._model.parameters()).device != device:
                raise AssertionError("the encoder is not on the card")
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the ingest did not end")

            requests = encoder_requests("e5", tuple(E5_TEXT))
            hf_encoder.FORWARDS.reset()
            embedder = embedders.get_embedder(store, "default")
            for q in E5_TEXT:
                embedder.embed_search(q)
            if hf_encoder.FORWARDS.value != len(E5_TEXT):
                raise AssertionError("the queries were not embedded on the card")
            serving = vector_round(app, client, store, requests, exact=False)
            if serving["float_legs"] <= 0:
                raise AssertionError("the float leg did not run on the XLM-R path")
            stats = serving_stats()
            if stats["device_errors"] != 0:
                raise AssertionError(f"device errors on the XLM-R path: {stats}")
            timing = encoder_timing(enc, device, card, "multilingual-e5-base")
        finally:
            app.search_batcher.stop()
            app.scheduler.stop()
    say(f"phase 9 wall: {time.perf_counter() - t_phase:.3f} s")
    return {"err": err, "forwards": forwards, "tokens_s": tokens / embed_s,
            "tokenize_s": tok_s, **timing}


def workloads_phase(device) -> None:
    """Phase 10: the declarative workloads (workloads/tests/*.json) through
    the port's xtask runner, every instance's App bound to the card."""
    import glob
    import os

    from meilisearch_tpu_torch import xtask
    from meilisearch_tpu_torch.search.device_batch import serving_stats

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "workloads", "tests", "*.json")))
    if len(paths) != 7:
        raise AssertionError(f"expected 7 workloads, found {len(paths)}")
    serving_stats(reset=True)
    t0 = time.perf_counter()
    for path in paths:
        t = time.perf_counter()
        xtask.run_workload(path, verbose=False, device=device)
        say(f"workload {os.path.basename(path)} passed with the App bound to the card in"
            f" {time.perf_counter() - t:.3f} s")
    stats = serving_stats()
    if stats["device_errors"] != 0:
        raise AssertionError(f"device errors in the workloads: {stats}")
    say(f"phase 10: {len(paths)} workloads passed with the App bound to the card in"
        f" {time.perf_counter() - t0:.3f} s; serving stats (device_served: searches the"
        f" device answered) {json.dumps(stats)}")


def encoder_timing(enc, device, card: str, width: str = "bge-base") -> dict:
    """(f) One query's forward (1 text, about 16 tokens) and one indexing
    chunk (chunk_texts() texts of ENC_TIMED_TOKENS tokens): device time by
    CUDA events, median of REPEATS; the query's kernels and launches; the
    chunk's TFLOP/s against the float32 bound."""
    import torch

    query = "rust compiler performance benchmark for machine learning on gpu"
    ids, mask = enc._tokenizer([query], enc.max_len)
    q_ms = _median_ms(lambda: enc.forward(ids, mask), reps=REPEATS)
    _kernel_ms, launches = leg_breakdown(f"one query's forward ({ids.shape[1]} tokens)",
                                         lambda: enc.forward(ids, mask), device)
    c = enc._model.config
    n, L = enc.chunk_texts(), ENC_TIMED_TOKENS
    g = torch.Generator().manual_seed(ENC_SEED)
    cids = torch.randint(1000, c["vocab_size"], (n, L), generator=g)
    cmask = torch.ones((n, L), dtype=torch.int64)
    chunk_ms = _median_ms(lambda: enc.forward(cids, cmask), reps=REPEATS)
    linear = sum(p.numel() for name, p in enc._model.named_parameters()
                 if p.dim() == 2 and "embeddings" not in name)
    flops = 2 * linear * n * L + 4 * L * L * c["hidden_size"] * c["num_hidden_layers"] * n
    bound_ms = flops / FP32_FLOP_S * 1e3
    say(f"timing the {width}-width encoder on {card}: one query's forward ({ids.shape[1]}"
        f" tokens) {q_ms:.4f} ms"
        f" (CUDA events, median of {REPEATS}), {launches:.0f} launches; one indexing chunk"
        f" ({n} texts x {L} tokens) {chunk_ms:.4f} ms, {flops / chunk_ms / 1e9:.2f} TFLOP/s,"
        f" bound {bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP over {FP32_FLOP_S / 1e12:.0f}"
        f" TFLOP/s float32), {bound_ms / chunk_ms:.2f} of the bound")
    return {"query_ms": q_ms, "query_launches": launches, "chunk_ms": chunk_ms,
            "chunk_bound_ms": bound_ms}


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound_ms(args, T: int) -> tuple[float, str]:
    """The least time K1 could take on these inputs: the larger of the
    bytes it must move (each distinct pool row named, the bitmaps and the
    small inputs read once; keys, bitmap and counts written once) over
    the HBM rate, and its integer operations over the int32 rate. The
    operation count is per (query, document) pair, counting fused
    instructions (IADD3, LOP3, byte extract, min) in csrc/chain_keys.cu:
    about 35 for t = 0, 75 for each later term, 3 per ExactAttribute
    level and 4 for the masks."""
    import torch

    byte_pool, rows, adj, mand, use_valid, universe, live = args
    B, D = rows.shape[0], byte_pool.shape[1] * 4
    n_rows = int(torch.unique(rows).numel())
    small = sum(int(x.numel()) * 4 for x in (rows, adj, mand, use_valid))
    moved = n_rows * D + 4 * (universe.numel() + live.numel()) + small
    moved += B * D * 4 + B * (D // 32) * 4 + B * 4
    ops = (35 + 75 * (T - 1) + 3 * (T + 1) + 4) * B * D
    return max(moved / HBM_BYTES_S, ops / INT32_OPS_S) * 1e3, (
        "bytes" if moved / HBM_BYTES_S > ops / INT32_OPS_S else "operations"
    )


def k3_bound_ms(lens, m: int, max_dist: int) -> tuple[float, str]:
    """The least time K3 could take for one query word of `m` letters over
    a vocabulary of these lengths (numpy; 0 = padding row): the larger of
    the bytes the function must move over the HBM rate and its integer
    operations over the int32 rate. Every OSA distance is at least the
    length difference, D[m][j] >= |m - j|, and the outputs are clipped at
    max_dist + 1. Bytes: the 4-byte length of every row; for a word of
    len >= m - max_dist, the 32-byte sectors that hold its letters
    j < min(len, m + max_dist) (none at m = 0, where the outputs follow
    from the length); the two int8 outputs. Operations: the cheaper of
    8 per DP cell of the band |i - j| <= max_dist + 1 (a cell off it is
    above the clip), min(len, i + max_dist + 1) - max(1, i - max_dist - 1)
    + 1 cells for query row i, and OSA_OPS_PER_LETTER per letter read, the
    bit-vector recurrence's instructions in csrc/osa.cu."""
    import numpy as np

    counts = np.bincount(np.asarray(lens, np.int64), minlength=33)
    length = np.arange(len(counts))
    if m == 0:
        needed = np.zeros_like(length)
    else:
        needed = np.where(length >= max(m - max_dist, 1), np.minimum(length, m + max_dist), 0)
    n = len(lens)
    moved = 4 * n + 32 * int((counts * ((needed + 7) // 8)).sum()) + 2 * n
    cells = 0
    for i in range(1, m + 1):
        hi = np.minimum(length, i + max_dist + 1)
        cells += int((counts * np.maximum(hi - max(1, i - max_dist - 1) + 1, 0)).sum())
    ops = min(8 * cells, OSA_OPS_PER_LETTER * int((counts * needed).sum()))
    t_bytes, t_ops = moved / HBM_BYTES_S, ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def timing_phase(device, card: str, typo: dict, vector: dict) -> dict:
    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs

    out = {}
    args = kernel_args(scorer_inputs(3, 1 << 20, 32, seed=7), device)
    # plain, kernel, kernel, plain: both sides see the same card state
    plain = [_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5)]
    events = _median_ms(lambda: chain_keys(*args, T=3), reps=30)
    k1 = repeated_launch_ms(K1_KERNEL, lambda: chain_keys(*args, T=3), device)
    plain.append(_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5))
    bound, by = k1_bound_ms(args, 3)
    out["chain_keys"] = {"ms": k1["cold_ms"], "plain_ms": statistics.median(plain),
                         "bound_ms": bound, "bound_by": by}
    say(f"timing D=2^20 B=32 T=3 on {card}: K1 per launch (trace, median of"
        f" {REPEATS} repeats of 10) cold {k1['cold_ms']:.4f} ms (repeats"
        f" {_spread(k1['cold'])}), warm {k1['warm_ms']:.4f} ms (repeats"
        f" {_spread(k1['warm'])}); wrapper back to back (CUDA events, median of 30)"
        f" {events:.4f} ms; chain_keys_torch {out['chain_keys']['plain_ms']:.4f} ms"
        f" (runs {plain}); bound {bound:.4f} ms ({by}); cold"
        f" {bound / k1['cold_ms']:.2f} of the bound")
    del args
    out["osa"] = osa_timing(card, typo)
    out["hamming"] = vector_timing(card, vector)
    return out


def k4h_bound_ms(n: int, w: int, n_live: int | None = None) -> tuple[float, str]:
    """The least time K4h could take on an (n, w) matrix: the larger of
    the bytes it must move over the HBM rate and its population counts
    over the card's POPC rate (the XORs and adds go to other units at a
    higher rate). Mode ham (n_live None): the matrix and the query read
    once, n int32 distances written once. Mode keyed: only the first
    n_live rows read (the pad rows' outputs do not depend on the matrix),
    n float32 cosines and n int64 keys written once."""
    n_read, out_bytes = (n, 4) if n_live is None else (n_live, 12)
    moved = n_read * w * 4 + w * 4 + n * out_bytes
    t_bytes, t_ops = moved / HBM_BYTES_S, n_read * w / POPC_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def float_leg_bound_ms(n: int, dim: int, kb: int) -> tuple[float, str]:
    """The least time the float leg could take: the matrix, the norms and
    the query read once and the kb (value, index) pairs written once, over
    the HBM rate; its 2 * n * dim float32 operations over the card's
    float32 rate outside the tensor cores."""
    moved = n * dim * 4 + n * 4 + dim * 4 + kb * 12
    t_bytes, t_ops = moved / HBM_BYTES_S, 2 * n * dim / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def leg_breakdown(label: str, call, device, reps: int = 10) -> tuple[float, float]:
    """Print the device time per call of each kernel that `call` launches
    (torch.profiler, `reps` calls back to back), their sum and the
    launches per call; return the last two. Only the kernels count: a
    torch op's entry repeats its kernels' device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.self_device_time_total / reps / 1e3, e.key) for e in kernels), reverse=True)
    launches = sum(e.count for e in kernels) / reps
    total = sum(ms for ms, _ in rows)
    say(f"  {label}: device time per call {total:.4f} ms in {len(rows)} kernels,"
        f" {launches:.1f} launches; " + "; ".join(f"{ms:.4f} {name[:60]}" for ms, name in rows[:6]))
    return total, launches


def vector_timing(card: str, vector: dict) -> dict:
    """K4h on the vector path's resident sign words (n = 2^18, W = 24), in
    each mode (ham over every row; keyed with the path's n_live rows
    live): equal to its plain version, then plain, kernel (traced per
    launch, cold and warm, REPEATS repeats), plain; each mode's bound. The
    float leg on the resident float matrix: its device work (CUDA events
    around `_device_topk_dispatch`), its torch.matmul alone (the library
    call), its bound. Both legs' kernels and launches per call, and their
    whole search_async call and numpy host passes on the host clock.
    Returns the kernels line's numbers: the keyed mode's, the one the
    binary leg's top-k launches."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops import hamming
    from meilisearch_tpu_torch.vector.store import _device_topk_dispatch, _pack_signs

    binary, floating, q = vector["binary"], vector["float"], vector["query"]
    dev = binary.device
    m_dev, n = binary._device[("matrix", dev)]
    n_pad, w = m_dev.shape
    qd = torch.from_numpy(_pack_signs(q[None, :])[0].view(np.int32)).to(dev)
    modes = {
        "ham": (lambda: hamming.hamming_rows(m_dev, qd),
                lambda: hamming.hamming_rows_torch(m_dev, qd), k4h_bound_ms(n_pad, w)),
        "keyed": (lambda: hamming.hamming_keyed(m_dev, qd, binary.dim, n),
                  lambda: hamming.hamming_keyed_torch(m_dev, qd, binary.dim, n),
                  k4h_bound_ms(n_pad, w, n)),
    }
    lines = {}
    for mode, (call, plain_call, (bound, by)) in modes.items():
        got = call()
        torch.cuda.synchronize()
        err = k4h_err(got, plain_call(), f"{mode} on the resident sign words")
        plain = [_median_ms(plain_call, reps=5)]
        k4 = repeated_launch_ms(K4H_KERNEL, call, dev)
        plain.append(_median_ms(plain_call, reps=5))
        say(f"timing K4h {mode} n={n_pad} n_live={n} W={w} on {card}: per launch (trace,"
            f" median of {REPEATS} repeats of 10) cold {k4['cold_ms']:.4f} ms (repeats"
            f" {_spread(k4['cold'])}), warm {k4['warm_ms']:.4f} ms (repeats"
            f" {_spread(k4['warm'])}); plain version {statistics.median(plain):.4f} ms (runs"
            f" {plain}); bound {bound:.4f} ms ({by}); cold {bound / k4['cold_ms']:.2f}, warm"
            f" {bound / k4['warm_ms']:.2f} of the bound; equal")
        lines[mode] = {"ms": k4["cold_ms"], "plain_ms": statistics.median(plain),
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err}

    k = 30  # offset + limit of the path's paged requests
    fm, fn = floating._device[("matrix", dev)]
    qf = torch.from_numpy(q).to(dev)
    lib = _median_ms(lambda: torch.matmul(fm, qf), reps=20)
    leg = _median_ms(lambda: _device_topk_dispatch(floating, q, k), reps=20)
    bin_leg = _median_ms(lambda: _device_topk_dispatch(binary, q, k), reps=20)
    kb = 1 << (4 * k - 1).bit_length()
    fbound, fby = float_leg_bound_ms(fm.shape[0], fm.shape[1], kb)
    whole = {}
    for name, searcher in (("float", floating), ("binary", binary)):
        host = copy.copy(searcher)
        host.device = None  # the numpy pass over the same matrix
        for side, s in ((name, searcher), (name + " host", host)):
            times = []
            for _ in range(20 if side == name else 5):
                t0 = time.perf_counter()
                s.search_async(q, k)()
                times.append((time.perf_counter() - t0) * 1e3)
            whole[side] = statistics.median(times)
    for name, searcher in (("float", floating), ("binary", binary)):
        leg_breakdown(f"the {name} leg", lambda s=searcher: _device_topk_dispatch(s, q, k), dev)
    say(f"timing float leg n={fm.shape[0]} dim={fm.shape[1]} k={k} (kb={kb}) on {card}:"
        f" device work (CUDA events around _device_topk_dispatch, median of 20)"
        f" {leg:.4f} ms; torch.matmul alone {lib:.4f} ms; bound {fbound:.4f} ms ({fby});"
        f" the binary leg's device work {bin_leg:.4f} ms")
    say(f"timing search_async(q, {k})() on {card}, host clock, medians: float"
        f" {whole['float']:.3f} ms, binary {whole['binary']:.3f} ms; numpy host pass:"
        f" float {whole['float host']:.3f} ms, binary {whole['binary host']:.3f} ms")
    return lines["keyed"]


def warp_lengths(lens) -> str:
    """The word lengths K3's warps see: the mean length of the real rows,
    and the mean over warps (32 consecutive rows, one thread each) of the
    longest, the length every lane of the warp runs its DP rows to."""
    import numpy as np

    lens = np.asarray(lens)
    longest = lens[: len(lens) // 32 * 32].reshape(-1, 32).max(axis=1)
    return (f"mean word length {lens[lens > 0].mean():.3f}, mean longest per"
            f" warp {longest.mean():.3f}")


def launch_ms(kernel: str, runs: list, device, per_call: int = 1) -> list:
    """A kernel's device time per call, from torch.profiler's CUDA trace:
    for each (call, reps, cold) of `runs`, in order, `reps` calls of
    `call`, each of which must launch the kernel whose traced name holds
    `kernel` `per_call` times, and each after a write of L2_FLUSH_BYTES
    when `cold` (so the kernel finds the L2 cache as a call between
    searches finds it); returns, per run, the ms of each call's launches
    summed. The trace may miss a
    session's first launches (a 10 us kernel lost 2 of 100 on the card;
    in the whole script's later sessions K1 lost 11-15, K3 10-12 and K4h
    21-26, whether or not the session first waited 0.25 s), so SENTINELS
    calls open it, the first followed by a wait of TRACE_SETTLE_S, and the
    runs take the last launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    runs[0][0]()  # untraced warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runs[0][0]()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
        for _ in range(SENTINELS - 1):
            runs[0][0]()
        torch.cuda.synchronize()
        for call, reps, cold in runs:
            for _ in range(reps):
                if cold:
                    flush.fill_(1)
                call()
        torch.cuda.synchronize()
    launches = sorted(
        (e.time_range.start, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel in e.name
    )
    want = sum(reps for _call, reps, _cold in runs) * per_call
    sentinels = SENTINELS * per_call
    if not want <= len(launches) <= want + sentinels:
        raise AssertionError(f"the trace holds {len(launches)} {kernel} launches,"
                             f" not {want} (+ up to {sentinels} of the sentinels)")
    if len(launches) < want + sentinels:
        say(f"  the trace of {kernel} kept {len(launches)} of {want + sentinels} launches"
            f" ({sentinels} of the sentinels first)")
    out, k = [], len(launches) - want
    for _call, reps, _cold in runs:
        out.append([sum(ms for _start, ms in launches[k + r * per_call : k + (r + 1) * per_call])
                    for r in range(reps)])
        k += reps * per_call
    return out


def repeated_launch_ms(kernel: str, call, device, per_call: int = 1) -> dict:
    """REPEATS repeats of 10 cold and 10 warm calls of `call`, traced (each
    launching the kernel `per_call` times, summed a call): the median of
    the repeats' medians, cold and warm, with each list."""
    traced = launch_ms(kernel, [(call, 10, cold) for _ in range(REPEATS)
                                for cold in (True, False)], device, per_call)
    cold = [statistics.median(t) for t in traced[0::2]]
    warm = [statistics.median(t) for t in traced[1::2]]
    return {"cold": cold, "warm": warm, "cold_ms": statistics.median(cold),
            "warm_ms": statistics.median(warm)}


def _spread(xs: list) -> str:
    return f"{min(xs):.4f}-{max(xs):.4f}"


def osa_timing(card: str, typo: dict) -> dict:
    """K3 on the typo path's resident vocabulary (`store._device_vocab`),
    for every word the typo pass put through it, at the pass's max_dist 2:
    held byte for byte against its plain version, then timed in turns
    (plain, kernel, plain; the plain version with CUDA events per call).
    The kernel is timed per launch from the trace of the pass's own call
    (`launch_ms` over `osa_distances_device`), 10 calls cold, the L2
    cache flushed before each (the kernels line's time), and 10 warm. Also
    the wrapper per call (CUDA events around one `osa_device` call, the
    host's query table included), the vocabulary's upload with its length
    order, and for the words nearest 5 and 10 letters the whole call split
    into its parts and the host pass. Returns the kernels line's numbers:
    the mean per launch over the words, and the largest error."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops.device_osa import (
        DeviceVocab,
        launch,
        length_order,
        osa_device,
        osa_device_torch,
        osa_distances_device,
        query_params,
        query_tensor,
    )
    from meilisearch_tpu_torch.ops.levenshtein import MAX_LEN, osa_distances

    store, words = typo["store"], typo["words"]
    mat_np, lens_np = store._derivation_store_cache["packed"]
    _, dv = store._device_vocab
    lens_all = dv.lens.cpu().numpy()
    say(f"K3 timing vocabulary, {dv.n} rows: vocabulary order:"
        f" {warp_lengths(lens_all)}; length order (dv.order):"
        f" {warp_lengths(lens_all[dv.order.cpu().numpy()])}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = DeviceVocab(mat_np, lens_np, dv.device)
    torch.cuda.synchronize()
    upload = (time.perf_counter() - t0) * 1e3
    order_ms = _median_ms(lambda: length_order(fresh.lens), reps=5)
    del fresh
    say(f"DeviceVocab upload of {dv.n_real} words ({dv.n} rows) on {card}:"
        f" {upload:.3f} ms host clock with its length order; the order alone"
        f" {order_ms:.4f} ms (CUDA events)")
    rows = []
    for word in words:
        q, m = query_tensor(word)
        qd = q.to(dv.device)
        got = osa_device(dv.mat, dv.lens, q, m, 2, dv.order)
        torch.cuda.synchronize()
        want = osa_device_torch(dv.mat, dv.lens, qd, m, 2)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 disagrees with osa_device_torch on {word!r}")
        err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
        plain = _median_ms(lambda: osa_device_torch(dv.mat, dv.lens, qd, m, 2), 3, 1)
        call = _median_ms(lambda: osa_device(dv.mat, dv.lens, q, m, 2, dv.order), reps=20)
        bound, by = k3_bound_ms(lens_all, m, 2)
        rows.append({"word": word, "m": m, "plain": [plain], "bound_ms": bound,
                     "bound_by": by, "err": err, "call_ms": call})
    runs = []
    for word in words:
        def call(word=word):
            osa_distances_device(store, mat_np, lens_np, word)
        runs += [(call, 10, True), (call, 10, False)]
    traced = launch_ms(K3_KERNEL, runs, dv.device)
    for k, row in enumerate(rows):
        row["cold"], row["warm"] = traced[2 * k], traced[2 * k + 1]
        row["ms"], row["warm_ms"] = statistics.median(row["cold"]), statistics.median(row["warm"])
        q, m = query_tensor(row["word"])
        qd = q.to(dv.device)
        row["plain"].append(_median_ms(lambda: osa_device_torch(dv.mat, dv.lens, qd, m, 2), 3, 1))
        row["plain_ms"] = statistics.median(row["plain"])
        say(f"timing K3 n={dv.n} max_dist=2 m={row['m']} ({row['word']!r}) on {card}:"
            f" per launch cold {row['ms']:.4f} ms (of {len(row['cold'])},"
            f" {min(row['cold']):.4f}-{max(row['cold']):.4f}), warm {row['warm_ms']:.4f} ms;"
            f" wrapper per call {row['call_ms']:.4f} ms; osa_device_torch"
            f" {row['plain_ms']:.4f} ms (runs {row['plain']}); bound {row['bound_ms']:.4f} ms"
            f" ({row['bound_by']}); byte-exact")
    by_word = {row["word"]: row for row in rows}
    for target in (5, 10):
        word = min(words, key=lambda w: (abs(len(w) - target), w))
        parts: dict = {k: [] for k in ("whole", "table", "launch", "readback", "numpy")}
        for _ in range(10):
            t0 = time.perf_counter()
            osa_distances_device(store, mat_np, lens_np, word)
            t1 = time.perf_counter()
            q, m = query_tensor(word)
            params = query_params(q[:m].tolist(), 2)
            t2 = time.perf_counter()
            full, prefix = launch(dv.mat, dv.lens, dv.order, params)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            full, prefix = full[: dv.n_real].cpu(), prefix[: dv.n_real].cpu()
            t4 = time.perf_counter()
            full.numpy().astype(np.int32), prefix.numpy().astype(np.int32)
            t5 = time.perf_counter()
            for key, dt in (("whole", t1 - t0), ("table", t2 - t1), ("launch", t3 - t2),
                            ("readback", t4 - t3), ("numpy", t5 - t4)):
                parts[key].append(dt * 1e3)
        med = {k: statistics.median(v) for k, v in parts.items()}
        K = min(MAX_LEN, len(word) + 2)  # the host pass's column trim
        host = []
        for _ in range(2):
            t0 = time.perf_counter()
            osa_distances(word, mat_np[:, :K], np.minimum(lens_np, K))
            host.append((time.perf_counter() - t0) * 1e3)
        say(f"timing typo pass m={len(word)} ({word!r}), {dv.n_real} words on {card},"
            f" medians of 10: osa_distances_device with readback {med['whole']:.3f} ms"
            f" (host clock); its parts: query table {med['table']:.3f} ms, launch to"
            f" sync {med['launch']:.3f} ms (host clock; the kernel alone"
            f" {by_word[word]['ms']:.4f} ms cold, {by_word[word]['warm_ms']:.4f} ms warm,"
            f" on the device clock), readback {med['readback']:.3f} ms,"
            f" numpy {med['numpy']:.3f} ms; host pass (levenshtein.osa_distances,"
            f" {K} columns) {statistics.median(host):.3f} ms (runs {host})")
    mean = {k: statistics.fmean(r[k] for r in rows)
            for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "call_ms")}
    # the limiter of the larger part of the summed bound
    ops_part = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    by = "operations" if 2 * ops_part >= sum(r["bound_ms"] for r in rows) else "bytes"
    say(f"K3 over the typo pass's {len(rows)} words (m {min(r['m'] for r in rows)}"
        f"-{max(r['m'] for r in rows)}), mean per launch: kernel cold {mean['ms']:.4f} ms"
        f" ({mean['ms'] / mean['bound_ms']:.2f}x the bound), warm {mean['warm_ms']:.4f} ms"
        f" ({mean['warm_ms'] / mean['bound_ms']:.2f}x), wrapper per call"
        f" {mean['call_ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, bound"
        f" {mean['bound_ms']:.4f} ms ({by})")
    return {"ms": mean["ms"], "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"],
            "bound_by": by, "max_abs_err": max(r["err"] for r in rows)}


def dp_inputs(T: int, N: int, seed: int, device, width: int | None = None):
    """K6's inputs: `example_inputs` with INF addends where a class is
    absent, every 13th column matched by no term, every 11th invalid and
    docids above 2^23 from column N // 2 on (clipped in key_lo2: full-key
    ties); and an int32 exactness addend for the cost mode. Laid out
    `width` columns wide (default N) as the port's callers lay out the
    bulk path's stride: pad columns match no term, at INF costs, not
    valid. On `device`."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    cm, pc, fc, pos, em, docids, valid = (x.clone() for x in ds.example_inputs(T=T, N=N, seed=seed))
    gen = torch.Generator().manual_seed(seed)
    absent = ~cm & (torch.rand(cm.shape, generator=gen) < 0.5)
    fc[absent] = ds.INF
    pos[absent] = ds.INF
    cm[:, :, ::13] = False
    valid[::11] = False
    docids[N // 2 :] = (1 << 23) + torch.arange(N - N // 2, dtype=torch.int32)
    exact_cost = torch.randint(0, 3, (T, N), generator=gen, dtype=torch.int32)
    tensors = (cm, pc, fc, pos, em, docids, valid, exact_cost)
    if width is not None and width > N:
        fills = (False, 0, ds.INF, ds.INF, False, 0, False, 0)
        tensors = tuple(
            torch.cat([x, torch.full(x.shape[:-1] + (width - N,), fill, dtype=x.dtype)], dim=-1)
            for x, fill in zip(tensors, fills)
        )
    tensors = tuple(x.contiguous().to(device) for x in tensors)
    return tensors[:7], tensors[7]


def chain_dp_kernel_phase(device) -> int:
    """K6 in its three modes against its plain versions on the card, bit
    for bit, for every T of K6_TERMS at each of K6_WIDTHS and K6_BROAD_N,
    in the unpadded layout (the direct path where N is not a multiple of
    16) and in the callers' padded one (the bulk path): the cost matrix,
    the three keys, and `chain_query_topk`'s docids and keys at k = 1,
    10 and 32 (the top-k mode and the merge of its survivors), 33, tile
    - 1, tile, tile + 1 and N (the keys mode and the sort of all N),
    against `chain_query_topk_torch` (at k = N: its first k are its answer
    at k). Returns the max abs error (0; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    worst = 0
    for N in K6_WIDTHS + (K6_BROAD_N,):
        for T in K6_TERMS:
            seed = 600 + T
            keys, exact_cost = dp_inputs(T, N, seed, device)
            want = [ds.chain_cost_matrix_torch(*keys[:4], exact_cost),
                    *ds.chain_query_keys_torch(*keys)]
            # every candidate in order: the plain top-k at any k is its head
            ranked = ds.chain_query_topk_torch(*keys, k=N)
            tile = ds.tile_width(T)
            ks = sorted({1, 10, 32, 33, tile - 1, tile, tile + 1, N})
            for width in sorted({N, ds.aligned_width(N)}):
                args, cost_in = ((keys, exact_cost) if width == N
                                 else dp_inputs(T, N, seed, device, width))
                got = [ds.chain_cost_matrix(*args[:4], cost_in, n=N)]
                path = ds.LAST_PATH["path"]
                got += ds.chain_query_keys(*args, n=N)
                top = {k: ds.chain_query_topk(*args, k=k, n=N) for k in ks}
                torch.cuda.synchronize()
                err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                same_top = all(torch.equal(g, w[:k]) for k in ks for g, w in zip(top[k], ranked))
                expected = "bulk" if width % ds.ALIGN_COLUMNS == 0 else "direct"
                say(f"K6 N={N} T={T} width={width} ({path} path): cost and keys"
                    f" bit-exact={same} max_abs_err={err}, top-k docids and keys equal at"
                    f" k={ks}: {same_top}; ranked {int((got[1] < ds.INVALID_HI).sum())} of {N}")
                if not (same and same_top) or path != expected:
                    raise AssertionError(f"K6 disagrees with its plain version at N={N} T={T}"
                                         f" width={width} ({path} path, {expected} expected)")
                worst = max(worst, err)
    return worst


def k6_bound_ms(T: int, N: int, mode: str, k: int = K6_TOPK) -> tuple[float, str]:
    """The least time K6 could take on a (T, 3, N) query: the larger of
    the bytes it must move over the HBM rate and its int32 operations
    (K6_OPS_*) over the int32 rate. Read once: masks, pair costs, fid and
    position addends, exactness (int32 in the cost mode, bool else), and
    docids and valid in the keys and top-k modes. Written once: the (6,
    N) costs, the three (N,) keys, or the top-k mode's min(k, N) results
    (docid and three keys). The top-k mode counts the keys mode's
    operations: the survivors and their sort are the implementation's
    work, not the function's."""
    reads = N * (3 * T + 9 * (T - 1) + 24 * T + (4 * T if mode == "cost" else T + 5))
    writes = {"cost": 24 * N, "keys": 12 * N, "topk": 16 * min(k, N)}[mode]
    ops = N * (K6_OPS_FIRST + K6_OPS_TERM * (T - 1) + K6_OPS_FINAL
               + (0 if mode == "cost" else K6_OPS_PACK))
    t_bytes, t_ops = (reads + writes) / HBM_BYTES_S, ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def chain_scorer_phase(device, card: str, keyword: dict) -> dict:
    """Phase 8: the chain scorer (K6) and the scatter-gather (K7) on the
    card. (b) `entry()` once, against the plain version; (c)
    `dryrun_multichip(1)` in a one-rank NCCL group at DRYRUN_DOCS; (d)
    the executor path: with MEILI_TPU_DEVICE=1, `perform_search` over
    CHAIN_QUERIES and QUERIES on the keyword phase's store (bound to the
    card), each response equal to the same store's answer with
    MEILI_TPU_DEVICE=0, K6 launched; (e) K6 per launch cold and warm in
    each mode at T = 4 and the N of the broadest query's candidates, its
    bound and plain version, the 3-key sort, and the whole run_device
    call against the host run_raw on the host clock. Returns the kernels
    line's numbers."""
    import torch
    import torch.distributed as dist

    from meilisearch_tpu_torch.entry import dryrun_multichip, entry
    from meilisearch_tpu_torch.ops import device_scorer as ds
    from meilisearch_tpu_torch.search import scorer as scorer_mod
    from meilisearch_tpu_torch.search.perform import perform_search

    t_phase = time.perf_counter()
    if not dist.is_nccl_available():
        raise AssertionError("torch.distributed has no NCCL on this machine")
    # (b) the flagship step
    ds.SELECT_LAUNCHES.reset()
    fn, args = entry()
    got = fn(*args)
    want = ds.chain_query_topk_torch(*args, k=10)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("entry() differs from the plain version")
    say(f"entry(): chain_query_topk T=4 N=8192 k=10 on {got[0].device}: docs"
        f" {got[0].tolist()} equal to the plain version (docs and keys)")
    # (c) the dry run in a one-rank NCCL group, its collectives recorded
    t0 = time.perf_counter()
    before = ds.LAUNCHES.value
    with _recorded_collectives() as moved:
        dryrun_multichip(1, device="cuda", n_docs=DRYRUN_DOCS)
    say(f"dryrun_multichip(1, cuda, {DRYRUN_DOCS} docs): passed in"
        f" {time.perf_counter() - t0:.3f} s, K6 launches {ds.LAUNCHES.value - before}"
        " (one NCCL rank: no collective across cards is measured)")
    select_launches = ds.SELECT_LAUNCHES.value
    if select_launches <= 0:
        raise AssertionError("the survivors' merge was not launched by entry() and the dry run")
    collective_timing(device, card, moved)

    # (d) the executor path
    store, expected = keyword["store"], keyword["expected"]
    queries = CHAIN_QUERIES + QUERIES
    run_device = scorer_mod.FusedScorer.run_device
    calls, answers, taken = [], [], []  # taken: (candidates, query) of K6's calls
    scorer_mod.FusedScorer.run_device = _timed(run_device, calls)
    try:
        with _device_dp("0"):
            t0 = time.perf_counter()
            expected = [_strip(perform_search(store, dict(q))) for q in CHAIN_QUERIES] + expected
            say(f"host answers of the chain queries: {time.perf_counter() - t0:.3f} s")
        with _device_dp("1"):
            ds.LAUNCHES.reset()
            t0 = time.perf_counter()
            for q in queries:
                start = len(calls)
                answers.append(_strip(perform_search(store, dict(q))))
                taken += [(c[0], q) for c in calls[start:] if c[1]]
            wall = time.perf_counter() - t0
            launches = ds.LAUNCHES.value
    finally:
        scorer_mod.FusedScorer.run_device = run_device
    bad = [q for q, a, w in zip(queries, answers, expected) if a != w]
    say(f"executor path (MEILI_TPU_DEVICE=1, store on {store.device}):"
        f" {len(queries) - len(bad)}/{len(queries)} responses equal to MEILI_TPU_DEVICE=0;"
        f" run_device took {len(taken)} of {len(calls)} scorer calls; K6 launches"
        f" {launches}; {wall:.3f} s")
    if bad:
        raise AssertionError(f"the device DP's responses differ: {bad[:3]}")
    if launches <= 0:
        raise AssertionError("K6 was not launched on the executor path")

    # (e) timing at the broadest query's candidates
    n_broad, broad = max(taken, key=lambda c: c[0])
    chain, select = chain_dp_timing(device, card, n_broad)
    chain["launches"] = launches
    select["launches"] = select_launches
    run_device_timing(store, card, broad, n_broad)
    say(f"phase 8 wall: {time.perf_counter() - t_phase:.3f} s")
    return {"chain_dp": chain, "select": select}


@contextlib.contextmanager
def _recorded_collectives():
    """The (op, shape, dtype) of each collective K7 makes inside the
    block: `sharded._all_gather` and `torch.distributed.all_reduce`."""
    import torch.distributed as dist

    from meilisearch_tpu_torch.parallel import sharded

    moved = []
    gather, reduce = sharded._all_gather, dist.all_reduce

    def gathered(shards, x):
        moved.append(("all_gather_into_tensor", tuple(x.shape), x.dtype))
        return gather(shards, x)

    def reduced(x, *args, **kwargs):
        moved.append(("all_reduce", tuple(x.shape), x.dtype))
        return reduce(x, *args, **kwargs)

    sharded._all_gather, dist.all_reduce = gathered, reduced
    try:
        yield moved
    finally:
        sharded._all_gather, dist.all_reduce = gather, reduce


def collective_timing(device, card: str, moved: list) -> None:
    """K7's library calls alone: each distinct collective the dry run made
    (`moved`), by CUDA events (median of 50 after 5 warm-ups) in a
    one-rank NCCL group of its own, beside its bound on one rank: the
    bytes it reads and writes (input once, output once) over the HBM
    rate. One rank moves nothing between cards: NVLink is not measured."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "rdv"), 1),
                                rank=0, world_size=1)
        try:
            for op, shape, dtype in sorted(set(moved), key=str):
                x = torch.ones(shape, dtype=dtype, device=device)
                if op == "all_reduce":
                    def call(x=x):
                        dist.all_reduce(x, op=dist.ReduceOp.SUM)
                else:
                    out = torch.empty_like(x)

                    def call(x=x, out=out):
                        dist.all_gather_into_tensor(out, x)
                ms = _median_ms(call, reps=50, warmup=5)
                size = x.numel() * x.element_size()
                bound = 2 * size / HBM_BYTES_S * 1e3
                say(f"timing K7 {op} of {shape} {dtype} ({size} bytes), one NCCL rank, on"
                    f" {card}: {ms:.4f} ms by CUDA events (median of 50), made"
                    f" {moved.count((op, shape, dtype))} times in the dry run; bound"
                    f" {bound:.7f} ms (bytes, {2 * size} at the HBM rate)")
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def _device_dp(flag: str):
    """MEILI_TPU_DEVICE set to `flag` inside the block, put back after."""
    import os

    prior = os.environ.get("MEILI_TPU_DEVICE")
    os.environ["MEILI_TPU_DEVICE"] = flag
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop("MEILI_TPU_DEVICE", None)
        else:
            os.environ["MEILI_TPU_DEVICE"] = prior


def chain_dp_timing(device, card: str, n: int) -> dict:
    """K6 at T = 4 and N = n (seeded inputs), in each mode on the
    callers' padded layout (the bulk path), and the cost mode also
    unpadded (the direct path at an odd n): equal to its plain version,
    then plain, kernel (traced per launch, cold and warm, REPEATS
    repeats), plain; each mode's bound. Then the whole chain_query_topk
    at k = K6_TOPK by CUDA events (the top-k mode and the merge of its
    survivors, enqueued by one C call) beside the keys mode and the stable 3-key sort over all n
    that it replaces. Returns the kernels line's numbers: the cost mode's
    (the executor's) and the top-k mode's."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    flat, flat_cost = dp_inputs(4, n, 700, device)
    keys, exact_cost = dp_inputs(4, n, 700, device, ds.aligned_width(n))
    k = K6_TOPK
    modes = {
        "cost": (lambda: ds.chain_cost_matrix(*keys[:4], exact_cost, n=n),
                 lambda: ds.chain_cost_matrix_torch(*flat[:4], flat_cost)),
        "keys": (lambda: ds.chain_query_keys(*keys, n=n),
                 lambda: ds.chain_query_keys_torch(*flat)),
        "topk": (lambda: ds.chain_query_topk(*keys, k=k, n=n),
                 lambda: ds.chain_query_topk_torch(*flat, k=k)),
        "cost, unpadded": (lambda: ds.chain_cost_matrix(*flat[:4], flat_cost),
                           lambda: ds.chain_cost_matrix_torch(*flat[:4], flat_cost)),
    }
    lines = {}
    for mode, (call, plain_call) in modes.items():
        got = call()
        path = ds.LAST_PATH["path"]
        torch.cuda.synchronize()
        want = plain_call()
        got, want = (list(x) if isinstance(x, tuple) else [x] for x in (got, want))
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K6 {mode} differs from its plain version at N={n}")
        plain = [_median_ms(plain_call, reps=5)]
        k6 = repeated_launch_ms(K6_KERNEL, call, device)
        plain.append(_median_ms(plain_call, reps=5))
        bound, by = k6_bound_ms(4, n, mode.split(",")[0], k)
        say(f"timing K6 {mode} T=4 N={n} ({path} path) on {card}: per launch (trace, median"
            f" of {REPEATS} repeats of 10) cold {k6['cold_ms']:.4f} ms (repeats"
            f" {_spread(k6['cold'])}), warm {k6['warm_ms']:.4f} ms (repeats"
            f" {_spread(k6['warm'])}); plain version {statistics.median(plain):.4f} ms"
            f" (runs {plain}); bound {bound:.4f} ms ({by}); cold {bound / k6['cold_ms']:.2f},"
            f" warm {bound / k6['warm_ms']:.2f} of the bound; equal")
        lines[mode] = {"ms": k6["cold_ms"], "warm_ms": k6["warm_ms"],
                       "plain_ms": statistics.median(plain), "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err, "path": path}

    def keys_then_sort():
        return ds.sort3(*ds.chain_query_keys(*keys, n=n), keys[5], k)

    calls = {"top-k mode + merge of the survivors": lambda: ds.chain_query_topk(*keys, k=k, n=n),
             "keys mode + sort of all N": keys_then_sort}
    whole = {label: _median_ms(call, reps=50) for label, call in calls.items()}
    say(f"timing chain_query_topk T=4 N={n} k={k} on {card} (CUDA events, median of 50):"
        + "; ".join(f" {label} {ms:.4f} ms" for label, ms in whole.items()))
    cost, topk = lines["cost"], lines["topk"]
    chain = {**cost, "topk_ms": topk["ms"], "topk_bound_ms": topk["bound_ms"],
             "topk_call_ms": whole["top-k mode + merge of the survivors"]}
    return chain, select_timing(device, card, keys, n)


def select_timing(device, card: str, keys, n: int) -> dict:
    """The survivors' merge (select_kernel) as chain_query_topk launches it
    at T = 4, N = n, k = K6_TOPK: the top-k mode's survivors (`_launch`)
    equal, slot for slot, to the plain per-tile select of the plain keys;
    the call's answer equal to the merge walked in plain torch over those
    survivors (`merge_survivors`); then the merge's launches, traced in
    the trace of the whole call and summed a call, cold and warm (REPEATS
    repeats), its plain walk, and its bound: per pass the entries read
    once and the slots written once (16 bytes each) over the HBM rate, or
    one 4-word compare an entry read over the int32 rate. Returns the
    kernels line's numbers."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    k, tile = K6_TOPK, ds.tile_width(4)
    docids = keys[5]
    kept = torch.empty((4, -(-n // tile) * k), dtype=torch.int32, device=device)
    ds._launch(ds.MODE_TOPK, keys, kept.unbind(0), 4, n, docids.shape[0], k)
    plain_keys = ds.chain_query_keys_torch(*(x[..., :n] for x in keys))
    cols = torch.arange(n, dtype=torch.int32, device=device)
    want_kept = ds.select_torch(torch.stack([*plain_keys, cols]), k, width=tile)
    merges = ds.SELECT_LAUNCHES.value
    got = ds.chain_query_topk(*keys, k=k, n=n)
    torch.cuda.synchronize()
    passes = ds.SELECT_LAUNCHES.value - merges
    walked = ds.merge_survivors(kept, k, docids)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip((*kept, *got), (*want_kept, walked[3], *walked[:3])))
    if err or not torch.equal(kept, want_kept):
        raise AssertionError("the top-k mode's survivors differ from the plain per-tile select")
    if not all(torch.equal(g, w) for g, w in zip(got, (walked[3], *walked[:3]))):
        raise AssertionError("chain_query_topk differs from the plain merge of its survivors")
    timed = repeated_launch_ms("select_kernel", lambda: ds.chain_query_topk(*keys, k=k, n=n),
                               device, per_call=passes)
    plain = _median_ms(lambda: ds.merge_survivors(kept, k, docids), reps=5)
    bound, t_bytes, t_ops, m = 0.0, 0.0, 0.0, kept.shape[1]
    for p in range(passes):
        out = k if p == passes - 1 else -(-m // ds.SELECT_WIDTH) * k
        b, o = 16 * (m + out) / HBM_BYTES_S, 4 * m / INT32_OPS_S
        bound, t_bytes, t_ops, m = bound + max(b, o), t_bytes + b, t_ops + o, out
    by = "bytes" if t_bytes > t_ops else "operations"
    say(f"timing the survivors' merge in chain_query_topk T=4 N={n} k={k} on {card}:"
        f" {passes} passes from {kept.shape[1]} survivors, per call (trace, summed over the"
        f" passes, median of {REPEATS} repeats of 10) cold {timed['cold_ms']:.4f} ms (repeats"
        f" {_spread(timed['cold'])}), warm {timed['warm_ms']:.4f} ms; plain walk {plain:.4f}"
        f" ms; bound {bound * 1e3:.6f} ms ({by}); survivors and answer equal")
    return {"ms": timed["cold_ms"], "warm_ms": timed["warm_ms"], "plain_ms": plain,
            "bound_ms": bound * 1e3, "bound_by": by, "passes": passes, "max_abs_err": err}


def run_device_timing(store, card: str, query: dict, n: int) -> None:
    """The whole FusedScorer.run_device call (chain tensors on the host,
    upload, K6, readback) against the host pass's run_raw, each on the
    host clock inside `perform_search` of `query` (its scorer call over
    n candidates), median of 5."""
    from meilisearch_tpu_torch.search import scorer as scorer_mod
    from meilisearch_tpu_torch.search.perform import perform_search

    times = {}
    for method, flag in (("run_device", "1"), ("run_raw", "0")):
        orig = getattr(scorer_mod.FusedScorer, method)
        seen = []
        setattr(scorer_mod.FusedScorer, method, _timed(orig, seen))
        try:
            with _device_dp(flag):
                for _ in range(5):
                    perform_search(store, dict(query))
        finally:
            setattr(scorer_mod.FusedScorer, method, orig)
        times[method] = statistics.median(c[2] for c in seen if c[0] == n)
    say(f"timing {query} (N={n} candidates) on {card}, host clock, medians of 5:"
        f" run_device (chain tensors, upload, K6, readback) {times['run_device']:.3f} ms;"
        f" the host pass's run_raw {times['run_raw']:.3f} ms")


def _timed(method, seen: list):
    """`method` wrapped to append (scorer.n, returned a result, ms)."""

    def wrapped(self, *args):
        t = time.perf_counter()
        out = method(self, *args)
        seen.append((self.n, out is not None, (time.perf_counter() - t) * 1e3))
        return out

    return wrapped


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the keyword path's depth: 500,000 documents (D = 2^19) keep the whole
    # run, vector path included, near half of its 1200 s limit
    parser.add_argument("--docs", type=int, default=500_000)
    # the encoder path's depth (documents embedded at indexing)
    parser.add_argument("--enc-docs", type=int, default=ENC_DOCS)
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from meilisearch_tpu_torch._hooks import block_jax
    except ImportError:
        print("chip_smoke: run it from the root of the repository", file=sys.stderr)
        return 2
    block_jax()  # the port runs without jax, even where jax is installed
    device = torch.device("cuda", 0)

    card = card_line()
    say(card)
    build_phase()
    k1_err = kernel_phase(device)
    k3_err = osa_kernel_phase(device)
    k4_err = hamming_kernel_phase(device)
    k6_err = chain_dp_kernel_phase(device)
    keyword = main_path_phase(device, opts.docs)
    # phase 8 runs on the keyword phase's store, which goes before phase 4
    chain = chain_scorer_phase(device, card, keyword)
    select = chain["select"]
    chain = chain["chain_dp"]
    k6_err = max(k6_err, chain.pop("max_abs_err"))
    del keyword["store"]
    typo = typo_path_phase(device, TYPO_VOCAB_WORDS)
    vector = vector_path_phase(device)
    timing = timing_phase(device, card, typo, vector)
    launches = {"osa": typo["launches"], "hamming": vector["launches"]}
    del typo, vector  # the earlier paths' stores go before the encoder path's
    encoder_path_phase(device, card, opts.enc_docs)
    xlmr_path_phase(device, card, E5_DOCS)
    workloads_phase(device)
    k3_err = max(k3_err, timing["osa"].pop("max_abs_err"))
    k4_err = max(k4_err, timing["hamming"].pop("max_abs_err"))
    leaked = [
        m for m, mod in sys.modules.items()
        if mod is not None
        and m.split(".")[0] in ("jax", "jaxlib", "flax", "meilisearch_tpu")
    ]
    if leaked:
        raise AssertionError(f"jax or the JAX package was imported: {leaked[:5]}")
    print(json.dumps({"kernels": [
        {"name": "chain_keys", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": keyword["launches"],
         "max_abs_err": k1_err, **timing["chain_keys"], "library_ms": None},
        {"name": "osa", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": launches["osa"],
         "max_abs_err": k3_err, **timing["osa"], "library_ms": None},
        {"name": "hamming", "route": "cuda", "source": K4H_SOURCE,
         "replaces": K4H_REPLACES, "launches": launches["hamming"],
         "max_abs_err": k4_err, **timing["hamming"], "library_ms": None},
        {"name": "chain_dp", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, "max_abs_err": k6_err, **chain, "library_ms": None},
        {"name": "chain_select", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_SELECT_REPLACES, **select, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
