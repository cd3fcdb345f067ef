"""Mutable host-side index store.

This is the write-side twin of the device snapshot: it mirrors milli's LMDB
databases (reference: milli/src/index.rs:96-125 database names) as plain host
structures that support fine-grained per-document del/add, exactly like the
reference's extractor del/add pipeline
(milli/src/update/new/extract/searchable/*). Search never reads this store
directly at scale — a frozen `IndexSnapshot` (packed arrays, device tensors)
is derived per generation and swapped atomically, mirroring LMDB's MVCC
reader snapshots (SURVEY.md §7 "guiding split").

Databases mirrored here:
  word_docids, exact_word_docids           (index.rs:145-150)
  word_fid_docids, word_position_docids    (index.rs:163-175, bucketed)
  word_pair_proximity_docids               (index.rs:161, prox in 1..=3)
  field_id_word_count_docids               (index.rs:168, count <= 30)
  facet_id_f64_docids / facet_id_string_docids + exists/is_null/is_empty
  field_id_docid_facet_f64s / _strings     (per-doc facet values)
  documents, external_documents_ids        (index.rs:142,207)
  vector stores per embedder, geo points
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Iterable, Optional

import numpy as np

from ..analysis.tokenizer import (
    HARD_SEPARATOR_GAP,
    MAX_WORD_LENGTH,
    Tokenizer,
)
from ..types.errors import EngineError, ErrorCode
from ..types.settings import Settings, _match_pattern

# Reference: milli/src/lib.rs:151
MAX_COUNTED_WORDS = 30
# Reference: milli/src/proximity.rs:7
MAX_DISTANCE = 4
# Reference: milli/src/lib.rs:139 (MAX_FACET_VALUE_LENGTH)
MAX_FACET_VALUE_LENGTH = 468
# Reference: milli/src/lib.rs:148
MAX_POSITION_PER_ATTRIBUTE = 1 << 16

RESERVED_GEO_FIELD = "_geo"
RESERVED_GEOJSON_FIELD = "_geojson"
RESERVED_VECTORS_FIELD = "_vectors"


# native-extractor chunk: fresh documents buffer up to this many before
# one native tokenize/build call (big enough to amortize the call, small
# enough to bound the flat text buffer; tests shrink it to force
# multi-chunk paths)
BATCH_TOKEN_CHUNK = 32768


def _ingest_overlap_enabled() -> bool:
    """Extractor<->writer overlap gate: on by default with >1 core
    (where the native tokenize genuinely runs beside the writer), off on
    single-core hosts (thread switching only slows the one core down).
    MEILI_TPU_INGEST_OVERLAP=0/1 overrides (tests force 1)."""
    flag = os.environ.get("MEILI_TPU_INGEST_OVERLAP")
    if flag is not None:
        return flag == "1"
    return (os.cpu_count() or 1) > 1


_bucket_cache: dict[int, int] = {}


def bucketed_position(relative: int) -> int:
    """Reference: milli/src/lib.rs:248-260."""
    if relative < 16:
        return relative
    b = _bucket_cache.get(relative)
    if b is None:
        b = 24 if relative < 24 else int(2 ** math.ceil(math.log2(relative)))
        _bucket_cache[relative] = b
    return b


def index_proximity(lhs: int, rhs: int) -> int:
    """Reference: milli/src/proximity.rs:10-17."""
    if lhs <= rhs:
        return min(rhs - lhs, MAX_DISTANCE)
    return min(lhs - rhs + 1, MAX_DISTANCE)


class AbortedProcessing(Exception):
    """Raised when a cooperative must-stop aborts an indexing operation
    (the task becomes `canceled`, the index is unchanged)."""


def facet_string_normalize(value: str) -> str:
    """Facet strings are matched case/whitespace-insensitively.

    Reference: milli normalize_facet (update/facet/mod.rs) — trim + lowercase,
    truncated to fit an LMDB key."""
    return value.strip().lower()[:MAX_FACET_VALUE_LENGTH]


def truncate_facet_string(value: str) -> str:
    return value[:MAX_FACET_VALUE_LENGTH]


class FieldsIdsMap:
    """name <-> u16 id, insertion ordered (reference: milli fields_ids_map.rs)."""

    def __init__(self) -> None:
        self.name_to_id: dict[str, int] = {}
        self.id_to_name: list[str] = []

    def id_or_insert(self, name: str) -> int:
        fid = self.name_to_id.get(name)
        if fid is None:
            fid = len(self.id_to_name)
            self.name_to_id[name] = fid
            self.id_to_name.append(name)
        return fid

    def id(self, name: str) -> Optional[int]:
        return self.name_to_id.get(name)

    def name(self, fid: int) -> Optional[str]:
        if 0 <= fid < len(self.id_to_name):
            return self.id_to_name[fid]
        return None

    def names(self) -> list[str]:
        return list(self.id_to_name)

    def __len__(self) -> int:
        return len(self.id_to_name)


def flatten_json(value: Any, prefix: str = "") -> dict[str, list[Any]]:
    """Flatten nested JSON into dot-separated leaf paths.

    Mirrors the `flatten-serde-json` crate used for faceting
    (reference: crates/flatten-serde-json/src/lib.rs): objects nest with `.`,
    arrays are traversed element-wise merging values under the same key, and
    the intermediate object/array values themselves also appear under their
    key (an empty object stays as a value so IS EMPTY works).
    """
    out: dict[str, list[Any]] = defaultdict(list)

    def rec(val: Any, path: str):
        if isinstance(val, dict):
            if not val and path:
                out[path].append(val)
            for k, v in val.items():
                rec(v, f"{path}.{k}" if path else k)
        elif isinstance(val, list):
            if not val and path:
                out[path].append(val)
            has_scalar = False
            for item in val:
                if isinstance(item, (dict, list)):
                    rec(item, path)
                else:
                    has_scalar = True
                    out[path].append(item)
            _ = has_scalar
        else:
            out[path].append(val)

    rec(value, prefix)
    return dict(out)


# flat-scalar check for the batched facet path (bool before int: `type`
# identity makes the distinction explicit)
_SCALAR_TYPES = frozenset((str, int, float, bool, type(None)))


class VocabSnapshot:
    """Base/delta vocabulary for incremental derivations (VERDICT r2 #2).

    `base_words` is an immutable sorted list — the packed OSA codepoint
    matrix and every cached base derivation align with its indices —
    while `delta_words` collects vocabulary added by minor writes.
    base ∪ delta always equals the CURRENT vocabulary, so derivations
    computed as base-result ⊕ delta-result are exact (the per-class caps
    re-cut over the merged lexicographic stream; a capped base list plus
    the full delta list provably contains the true capped merge)."""

    _ids = itertools.count(1)

    def __init__(self, words: list):
        self.base_words = list(words)
        self.delta_words: list[str] = []
        self._delta_set: set[str] = set()
        self.version = 0
        self.base_id = next(VocabSnapshot._ids)

    def contains(self, w: str) -> bool:
        if w in self._delta_set:
            return True
        from bisect import bisect_left

        i = bisect_left(self.base_words, w)
        return i < len(self.base_words) and self.base_words[i] == w

    def add_delta_words(self, words) -> None:
        self._delta_set.update(words)
        self.delta_words = sorted(self._delta_set)
        self.version += 1

    def merged_words(self) -> list:
        from bisect import insort

        merged = list(self.base_words)
        for w in self.delta_words:
            insort(merged, w)
        return merged


class IndexStore:
    """One search index (the milli `Index` equivalent)."""

    def __init__(self, uid: str, primary_key: Optional[str] = None) -> None:
        self.uid = uid
        self.primary_key: Optional[str] = primary_key
        self.created_at = time.time()
        self.updated_at = self.created_at
        self.settings = Settings()
        self.fields_ids_map = FieldsIdsMap()

        from .docs import DocTable

        # docid -> document; spill mode keeps bodies on disk (index/docs.py)
        self.documents: DocTable = DocTable()
        self.external_to_internal: dict[str, int] = {}
        self.internal_to_external: dict[int, str] = {}
        self._next_docid = 0

        # searchable postings: Posting = base segments + delta
        # (index/arrays.py; segments land whole from the native indexer)
        from .arrays import Posting

        self.word_docids: dict[str, Posting] = defaultdict(Posting)
        self.exact_word_docids: dict[str, Posting] = defaultdict(Posting)
        self.word_fid_docids: dict[tuple[str, int], Posting] = defaultdict(Posting)
        self.word_position_docids: dict[tuple[str, int], Posting] = defaultdict(Posting)
        self.word_pair_proximity_docids: dict[tuple[int, str, str], Posting] = defaultdict(Posting)
        self.field_id_word_count_docids: dict[tuple[int, int], Posting] = defaultdict(Posting)

        # facets — Posting-valued like the word tables (round 3): readers
        # get O(1) amortized sorted arrays (only values a write touched
        # recompact), and the packed loader attaches mmap'd segments
        # zero-copy instead of materializing Python sets (VERDICT r2 #3)
        self.facet_number_docids: dict[int, dict[float, Posting]] = defaultdict(
            lambda: defaultdict(Posting)
        )
        self.facet_string_docids: dict[int, dict[str, Posting]] = defaultdict(
            lambda: defaultdict(Posting)
        )
        self.facet_string_original: dict[tuple[int, str], str] = {}
        self.facet_exists_docids: dict[int, Posting] = defaultdict(Posting)
        self.facet_is_null_docids: dict[int, Posting] = defaultdict(Posting)
        self.facet_is_empty_docids: dict[int, Posting] = defaultdict(Posting)
        self.docid_facet_numbers: dict[tuple[int, int], list[float]] = {}
        self.docid_facet_strings: dict[tuple[int, int], list[tuple[str, str]]] = {}

        # vectors: embedder -> docid -> ndarray (k, dim); regenerate flags
        self.vectors: dict[str, dict[int, np.ndarray]] = defaultdict(dict)
        self.vector_regenerate: dict[str, dict[int, bool]] = defaultdict(dict)

        # geo points: docid -> (lat, lng)
        self.geo_points: dict[int, tuple[float, float]] = {}
        self.geojson_shapes: dict[int, list] = {}

        self.generation = 0
        # incremental generations (VERDICT r2 #2): the device snapshot and
        # every expensive derived structure anchor to `base_generation`; a
        # MINOR write only records its touched docids in `delta_docids`
        # (served by the host overlay, search/device_batch.py) and its new
        # vocabulary in the VocabSnapshot, instead of flushing the HBM
        # arena + caches. The base promotes when the delta outgrows
        # delta_cap() or on any structural write (settings, clear, ...).
        # Reference delta design: update/new/words_prefix_docids.rs:346.
        self.base_generation = 0
        self.delta_docids: set[int] = set()
        self._delta_version = 0
        self._vocab_snapshot: Any = None
        self._lock = threading.RLock()
        # the device of the typo pass (ops/device_osa.py) and of the
        # vector legs (vector/store.py): a torch.device, or None for the
        # host passes only; and whether every typo term goes to it whatever
        # the vocabulary size. An App binds its own (engine/index_map.py)
        self.device: Any = None
        self.osa_strict = False
        self._snapshot_cache: Any = None
        self._snapshot_generation = -1
        # per-field caches (searchable weight, faceted flag), cleared on bump
        self._field_cache: dict[str, tuple] = {}
        self._docids_cache: Optional[frozenset] = None
        self._docids_sorted_incr: Optional[np.ndarray] = None
        self._vocab_cache: Optional[list] = None
        # sharding topology (reference: index.rs:196 shard_docids DB +
        # sharding/enterprise_edition.rs rendezvous assignment). The
        # per-shard docid sets are DERIVED lazily per generation — they are
        # a pure function of (external ids, topology), so no mutation path
        # needs to maintain them incrementally.
        self.shard_topology: Optional[list[str]] = None
        self._shard_docids_cache: Optional[tuple] = None
        # bulk-ingest run accumulation (the grenad spill+merge analogue,
        # reference update/new/extract/cache.rs): native-indexer outputs
        # and columnar facet extracts buffer as "runs" and merge into the
        # posting dicts in ONE vectorized pass — per-chunk per-key Python
        # cost collapsed to a single per-corpus pass (round-4 1M-doc fix)
        self._bulk_depth = 0
        self._token_runs: list[dict] = []
        self._facet_runs: list[dict] = []
        self._run_docids: set[int] = set()
        # a bulk-scoped write can take the per-document path (custom
        # dictionary/separators, Latin localizedAttributes) and leave no
        # runs — end_bulk must still bump the generation then, or
        # generation-keyed caches serve pre-batch results
        self._bulk_dirty = False
        # bumped by every _merge_runs: add_documents' rollback marks are
        # only valid while no mid-call merge consumed the run lists
        self._merge_epoch = 0
        # extractor<->writer overlap (the bbqueue-channel analogue,
        # reference update/new/channel.rs:54): at most ONE native
        # tokenize/build in flight on a worker thread while the main
        # thread preps the next chunk and indexes facets/vectors. The
        # docids ride in _run_docids from submit time so a mid-call
        # replace of an in-flight doc forces a merge (which drains).
        self._native_inflight: Optional[tuple] = None  # (batch, future)

    # ------------------------------------------------------------------
    # tokenizer / searchable config

    def make_tokenizer(self, locales: Optional[list[str]] = None) -> Tokenizer:
        s = self.settings
        separators = None
        if s.separator_tokens or s.non_separator_tokens:
            # Default separators extended/reduced by the custom token lists.
            base = list(" \t\n\r.;,!?()[]{}|\"'`:/\\-_=+*&#@~<>^%$")
            for tok in s.non_separator_tokens:
                if tok in base:
                    base.remove(tok)
            separators = base + [t for t in s.separator_tokens if t not in base]
        return Tokenizer(
            stop_words=s.stop_words,
            separators=separators,
            dictionary=s.dictionary or None,
            locales=locales,
        )

    def searchable_fields_and_weights(self) -> list[tuple[str, int, int]]:
        """Return (field_name, fid, weight) for every searchable field.

        Reference: index.rs:700 searchable_fields_and_weights +
        fieldids_weights_map.rs (wildcard => all weight 0, else weight =
        position of the matching user-defined searchable attribute).
        """
        s = self.settings
        out = []
        if s.searchable_is_wildcard():
            for name in self.fields_ids_map.names():
                if name == RESERVED_VECTORS_FIELD or name.startswith(
                    RESERVED_VECTORS_FIELD + "."
                ):
                    continue
                out.append((name, self.fields_ids_map.id(name), 0))
        else:
            for name in self.fields_ids_map.names():
                for weight, pattern in enumerate(s.searchable_attributes):
                    if _match_pattern(pattern, name):
                        out.append((name, self.fields_ids_map.id(name), weight))
                        break
        return out

    def searchable_fids(self) -> set[int]:
        return {fid for _, fid, _ in self.searchable_fields_and_weights()}

    def fid_weight_map(self) -> dict[int, int]:
        return {fid: w for _, fid, w in self.searchable_fields_and_weights()}

    def exact_attributes_fids(self) -> set[int]:
        """Attributes where typo tolerance is disabled: their words go to the
        exact_word_docids table so that typo-derived query words can't match
        them (reference: milli `exact_attributes` = the API's
        typoTolerance.disableOnAttributes, meilisearch-types settings.rs)."""
        patterns = list(self.settings.exact_attributes) + list(
            self.settings.typo_tolerance.disable_on_attributes
        )
        out = set()
        for name in self.fields_ids_map.names():
            if any(_match_pattern(p, name) for p in patterns):
                fid = self.fields_ids_map.id(name)
                if fid is not None:
                    out.add(fid)
        return out

    def faceted_fields(self) -> set[str]:
        """Fields extracted into the facet databases: filterable, sortable,
        distinct, and `_geo` (reference: milli Index::user_defined_faceted_fields)."""
        s = self.settings
        out: set[str] = set(s.filterable_attribute_names())
        out.update(s.sortable_attributes)
        if s.distinct_attribute:
            out.add(s.distinct_attribute)
        for rule in s.ranking_rules:
            if ":" in rule:
                out.add(rule.split(":")[0])
        return out

    def _is_faceted(self, field_path: str) -> bool:
        cached = self._field_cache.get(field_path)
        if cached is None or cached[1] is None:
            faceted = any(
                _match_pattern(pattern, field_path)
                for pattern in self.faceted_fields()
            )
            weight = cached[0] if cached else False
            self._field_cache[field_path] = (weight, faceted)
            return faceted
        return cached[1]

    # ------------------------------------------------------------------
    # document ingestion

    def guess_primary_key(self, doc: dict) -> str:
        """Reference: update/new/indexer/guess_primary_key.rs — attributes
        whose name ends with `id` (case-insensitive); error if 0 or >1."""
        candidates = [k for k in doc.keys() if k.lower() == "id" or k.lower().endswith("id")]
        if not candidates:
            raise EngineError(
                ErrorCode.MISSING_DOCUMENT_ID,
                "The primary key inference failed as the engine did not find "
                "any field ending with `id` in its name.",
            )
        if len(candidates) > 1:
            raise EngineError(
                ErrorCode.MISSING_DOCUMENT_ID,
                "The primary key inference failed as the engine found "
                f"{len(candidates)} fields ending with `id` in their names: "
                f"{', '.join(repr(c) for c in sorted(candidates))}.",
            )
        return candidates[0]

    @staticmethod
    def validate_external_id(value: Any) -> str:
        if isinstance(value, bool) or value is None:
            raise EngineError(
                ErrorCode.INVALID_DOCUMENT_ID,
                f"Document identifier `{value!r}` is invalid.",
            )
        if isinstance(value, int):
            return str(value)
        if isinstance(value, float) and value.is_integer():
            return str(int(value))
        if isinstance(value, str):
            if 0 < len(value) <= 511 and all(
                c.isalnum() or c in "-_" for c in value
            ):
                return value
        raise EngineError(
            ErrorCode.INVALID_DOCUMENT_ID,
            f"Document identifier `{value!r}` is invalid. A document identifier"
            " can be of type integer or string, only composed of alphanumeric"
            " characters (a-z A-Z 0-9), hyphens (-) and underscores (_),"
            " and can not be more than 511 bytes.",
        )

    # -- bulk-ingest runs ---------------------------------------------------

    def begin_bulk(self) -> None:
        """Open a bulk-ingest scope: add_documents calls inside it defer
        the run merge AND the generation bump until end_bulk, so a whole
        scheduler batch (e.g. 10 x 100k-doc tasks) commits in one pass —
        the reference's autobatched tasks likewise share one wtxn and
        become visible together (scheduler/process_batch.rs)."""
        with self._lock:
            self._bulk_depth += 1

    def end_bulk(self) -> None:
        with self._lock:
            self._bulk_depth -= 1
            if self._bulk_depth <= 0:
                self._bulk_depth = 0
                if self._token_runs or self._facet_runs or self._bulk_dirty:
                    self._merge_runs()
                    self._bump()
                self._bulk_dirty = False

    @contextmanager
    def bulk(self):
        self.begin_bulk()
        try:
            yield self
        finally:
            self.end_bulk()

    def _merge_runs(self) -> None:
        """Fold every pending run into the posting tables.

        Large merges (bulk ingest) take the RunsBase path: per-run
        DISTINCT keys sort once into code columns and the tables become
        RunsPostingTables — zero per-key Python (index/runs.py). Small
        merges and packed-boot targets fold per key: int64 key codes
        expanded per docid, sorted, grouped, one dict access per distinct
        key. Docid order inside a group is ascending because fresh docids
        grow monotonically and runs are chronological."""
        self._drain_native()
        runs, fruns = self._token_runs, self._facet_runs
        if not runs and not fruns:
            return
        self._merge_epoch += 1
        self._token_runs = []
        self._facet_runs = []
        self._run_docids = set()
        if runs:
            from .runs import merge_token_runs, tables_eligible

            total_rows = sum(len(r["wd"][-1]) for r in runs)
            if total_rows >= 150_000 and tables_eligible(self):
                merge_token_runs(self, runs)
                runs = []
        self._merge_runs_perkey(runs, fruns)

    def _merge_runs_perkey(self, runs: list, fruns: list) -> None:
        if not runs and not fruns:
            return

        def grouped(key_parts: list, id_parts: list):
            keys = np.concatenate(key_parts)
            ids = np.concatenate(
                [np.asarray(p, dtype=np.int64) for p in id_parts]
            )
            order = np.argsort(keys, kind="stable")
            keys, ids = keys[order], ids[order]
            bounds = np.flatnonzero(keys[1:] != keys[:-1]) + 1
            starts = np.concatenate((np.zeros(1, dtype=np.int64), bounds))
            ends = np.append(bounds, len(keys))
            return keys[starts], starts, ends, ids

        if runs:
            # merge-local word interning: one Python op per distinct word
            # per run, everything after is numpy
            gid_of: dict[str, int] = {}
            run_gids: list[np.ndarray] = []
            for r in runs:
                words = r["words"]
                sd = gid_of.setdefault
                g = np.fromiter(
                    (sd(w, len(gid_of)) for w in words),
                    dtype=np.int64,
                    count=len(words),
                )
                run_gids.append(g)
            inv: list[str] = [""] * len(gid_of)
            for w, gi in gid_of.items():
                inv[gi] = w
            V = len(inv) or 1

            def section(name, encode):
                key_parts, id_parts = [], []
                for r, g in zip(runs, run_gids):
                    sec = r[name]
                    lens, docids = sec[-2], sec[-1]
                    if len(lens) == 0:
                        continue
                    codes = encode(g, *sec[:-2])
                    key_parts.append(np.repeat(codes, lens))
                    id_parts.append(docids)
                if not key_parts:
                    return None
                return grouped(key_parts, id_parts)

            got = section(
                "wd",
                lambda g, wf: (g[np.asarray(wf) >> 1] << 1)
                | (np.asarray(wf, dtype=np.int64) & 1),
            )
            if got is not None:
                kc, starts, ends, ids = got
                wt, et = self.word_docids, self.exact_word_docids
                for code, s, e in zip(
                    kc.tolist(), starts.tolist(), ends.tolist()
                ):
                    t = et if (code & 1) else wt
                    t[inv[code >> 1]].segs.append(ids[s:e])

            got = section(
                "wf", lambda g, wid, fid: (g[np.asarray(wid)] << 16) | fid
            )
            if got is not None:
                kc, starts, ends, ids = got
                table = self.word_fid_docids
                for code, s, e in zip(
                    kc.tolist(), starts.tolist(), ends.tolist()
                ):
                    table[(inv[code >> 16], code & 0xFFFF)].segs.append(
                        ids[s:e]
                    )

            got = section(
                "wp", lambda g, wid, bkt: (g[np.asarray(wid)] << 16) | bkt
            )
            if got is not None:
                kc, starts, ends, ids = got
                table = self.word_position_docids
                for code, s, e in zip(
                    kc.tolist(), starts.tolist(), ends.tolist()
                ):
                    table[(inv[code >> 16], code & 0xFFFF)].segs.append(
                        ids[s:e]
                    )

            got = section(
                "pp",
                lambda g, prox, w1, w2: (
                    (g[np.asarray(w1)] * V + g[np.asarray(w2)]) << 3
                )
                | prox,
            )
            if got is not None:
                kc, starts, ends, ids = got
                table = self.word_pair_proximity_docids
                rest = kc >> 3
                w1s = (rest // V).tolist()
                w2s = (rest % V).tolist()
                proxs = (kc & 7).tolist()
                for p_, a_, b_, s, e in zip(
                    proxs, w1s, w2s, starts.tolist(), ends.tolist()
                ):
                    table[(p_, inv[a_], inv[b_])].segs.append(ids[s:e])

            got = section(
                "fc",
                lambda g, fid, cnt: (np.asarray(fid, dtype=np.int64) << 16)
                | cnt,
            )
            if got is not None:
                kc, starts, ends, ids = got
                table = self.field_id_word_count_docids
                for code, s, e in zip(
                    kc.tolist(), starts.tolist(), ends.tolist()
                ):
                    table[(code >> 16, code & 0xFFFF)].segs.append(ids[s:e])

        if fruns:
            # facet strings: interned norms, same grouping machinery
            nid_of: dict[str, int] = {}
            norm_inv: list[str] = []
            orig_of: list[str] = []
            key_parts, id_parts = [], []
            num_by_fid: dict[int, tuple[list, list]] = {}
            for fr in fruns:
                norms, origs, fid_arr, nid_arr, docid_arr = fr["str"]
                if len(norms):
                    g = np.empty(len(norms), dtype=np.int64)
                    for i, nrm in enumerate(norms):
                        gi = nid_of.get(nrm)
                        if gi is None:
                            gi = nid_of[nrm] = len(norm_inv)
                            norm_inv.append(nrm)
                            orig_of.append(origs[i])
                        g[i] = gi
                    if len(fid_arr):
                        key_parts.append(
                            (g[np.asarray(nid_arr)] << 16)
                            | np.asarray(fid_arr, dtype=np.int64)
                        )
                        id_parts.append(docid_arr)
                for fid, (dcol, vcol) in fr["num"].items():
                    acc = num_by_fid.get(fid)
                    if acc is None:
                        acc = num_by_fid[fid] = ([], [])
                    acc[0].append(np.asarray(dcol, dtype=np.int64))
                    acc[1].append(np.asarray(vcol, dtype=np.float64))
            if key_parts:
                kc, starts, ends, ids = grouped(key_parts, id_parts)
                fso = self.facet_string_original
                fsd = self.facet_string_docids
                for code, s, e in zip(
                    kc.tolist(), starts.tolist(), ends.tolist()
                ):
                    fid, norm = code & 0xFFFF, norm_inv[code >> 16]
                    fsd[fid][norm].segs.append(ids[s:e])
                    k = (fid, norm)
                    if k not in fso:
                        fso[k] = orig_of[code >> 16]
            for fid, (dcols, vcols) in num_by_fid.items():
                darr = np.concatenate(dcols)
                varr = np.concatenate(vcols)
                order = np.argsort(varr, kind="stable")
                darr, varr = darr[order], varr[order]
                table = self.facet_number_docids[fid]
                if (
                    len(varr) > 20_000
                    and isinstance(table, dict)
                    and not table
                ):
                    # high-cardinality fid (timestamps, ids): the grouped
                    # columns ARE the packed-v3 facet layout — serve them
                    # lazily instead of exploding one Posting per value
                    from .lazy_tables import LazyFacetTable

                    bounds = np.flatnonzero(varr[1:] != varr[:-1]) + 1
                    offsets = np.empty(len(bounds) + 2, dtype=np.int64)
                    offsets[0] = 0
                    offsets[1:-1] = bounds
                    offsets[-1] = len(varr)
                    uniq = varr[offsets[:-1]]
                    self.facet_number_docids[fid] = LazyFacetTable(
                        lambda i, _u=uniq: float(_u[i]),
                        darr.astype(np.int64),
                        offsets,
                        lambda _u=uniq: _u.tolist(),
                    )
                    continue
                uniq, ustarts = np.unique(varr, return_index=True)
                ubounds = np.append(ustarts[1:], len(varr))
                for v, s, e in zip(
                    uniq.tolist(), ustarts.tolist(), ubounds.tolist()
                ):
                    table[v].segs.append(darr[s:e])

    def add_documents(
        self, docs: Iterable[dict], method: str = "replace", must_stop=None
    ) -> tuple[int, int]:
        """Add or update documents. Returns (received, indexed).

        `must_stop` is the cooperative-abort signal (reference
        milli/src/must_stop_processing.rs): when set mid-batch, the change
        is rolled back (the LMDB-wtxn-never-commits equivalent) and
        AbortedProcessing is raised."""
        from ..utils.tracing import span

        with self._lock, span("indexing::documents", index=self.uid):
            received = 0
            applied: list[tuple[str, Optional[dict]]] = []
            # rollback marks: an abort drops the runs this call appended
            # (fresh docids >= call_start_docid live only in those runs)
            tr_mark = len(self._token_runs)
            fr_mark = len(self._facet_runs)
            epoch0 = self._merge_epoch
            call_start_docid = self._next_docid
            # minor-write tracking: touched docids + docs, abandoned the
            # moment the batch outgrows the delta cap (bulk ingests must
            # not pay per-doc bookkeeping)
            delta_budget = self.delta_cap() - len(self.delta_docids)
            touched: Optional[list[tuple[int, dict]]] = (
                [] if delta_budget > 0 else None
            )
            # fresh documents are token-indexed in native batches; updates
            # and replacements go through the per-document path (they need
            # the old content removed first)
            tok = self.make_tokenizer()
            # localizedAttributes rules with Latin-affecting locales
            # (swe/deu/ell) change how the native batch tokenizer would
            # fold text — route those through the per-document Python
            # path (CJK locale rules are safe: native rejects non-Latin
            # text and falls back per document anyway)
            from ..analysis.tokenizer import canonical_locale

            latin_localized = any(
                canonical_locale(loc) in ("swe", "deu", "ell")
                for rule in self.settings.localized_attributes or ()
                for loc in rule.get("locales", [])
            )
            use_batch = (
                tok.custom_separators is None
                and tok.dictionary is None
                and not latin_localized
            )
            pending: list[tuple[int, dict]] = []
            pending_ids: set[int] = set()

            ingest_executor = None
            if use_batch and _ingest_overlap_enabled():
                # extractor<->writer overlap (update/new/channel.rs:54):
                # the native tokenize of chunk N runs on a worker thread
                # while this thread indexes N's facets/vectors and preps
                # chunk N+1. Single writer preserved — only the pure
                # native call leaves this thread. Pointless on one core
                # (the gate checks), where it only adds switch overhead.
                from concurrent.futures import ThreadPoolExecutor

                ingest_executor = ThreadPoolExecutor(
                    1, thread_name_prefix="ingest-extract"
                )

            def flush_pending():
                if not pending:
                    return
                batch = list(pending)
                pending.clear()
                pending_ids.clear()
                if ingest_executor is not None:
                    self._submit_native(batch, ingest_executor)
                    return
                try:
                    fallback = set(self._index_documents_batch(batch))
                except Exception:
                    fallback = {d for d, _doc in batch}
                for d, dd in batch:
                    if d in fallback:
                        self._index_document_tokens(d, dd)
                self._index_facets_batch_and_rest(batch)

            # bulk indexing allocates millions of small tracked objects;
            # the cyclic GC adds ~3x to their construction cost. Single
            # writer, no reference cycles created here -> pause it.
            import gc

            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                for doc in docs:
                    if must_stop is not None and must_stop.is_set():
                        # drop unindexed buffered docs: rollback removes their
                        # document entries, and discards on the posting sets
                        # are no-ops for content that never landed
                        pending.clear()
                        pending_ids.clear()
                        # the in-flight native run must land before the
                        # mark/epoch logic below reasons about the lists
                        self._drain_native()
                        if self._merge_epoch != epoch0:
                            # a mid-call _merge_runs (replace of a doc
                            # whose postings sat in unmerged runs) reset
                            # the run lists: the marks are stale, and
                            # EVERY run still pending was appended by
                            # this call after that merge — drop them all
                            # (this call's pre-merge content is in the
                            # tables now, where rollback's per-key
                            # discards reach it)
                            self._token_runs.clear()
                            self._facet_runs.clear()
                        else:
                            del self._token_runs[tr_mark:]
                            del self._facet_runs[fr_mark:]
                        if self._run_docids:
                            self._run_docids = {
                                d
                                for d in self._run_docids
                                if d < call_start_docid
                            }
                        self._rollback_documents(applied)
                        if self._bulk_depth == 0:
                            self._merge_runs()
                            self._bump()
                        else:
                            self._bulk_dirty = True
                        raise AbortedProcessing()
                    received += 1
                    if self.primary_key is None:
                        self.primary_key = self.guess_primary_key(doc)
                    if self.primary_key not in doc:
                        raise EngineError(
                            ErrorCode.MISSING_DOCUMENT_ID,
                            f"Document doesn't have a `{self.primary_key}` attribute.",
                        )
                    external_id = self.validate_external_id(doc[self.primary_key])
                    docid = self.external_to_internal.get(external_id)
                    if docid is not None:
                        if docid in pending_ids:
                            # the same external id appears twice in this batch:
                            # land the buffered version before replacing it
                            flush_pending()
                        old = self.documents[docid]
                        applied.append((external_id, old))
                        if method == "update":
                            merged = dict(old)
                            merged.update(doc)
                            doc = merged
                        self._remove_document_content(docid, old)
                        self.documents[docid] = doc
                        self._index_document_content(docid, doc)
                        if touched is not None:
                            touched.append((docid, doc))
                            if len(touched) > delta_budget:
                                touched = None
                    else:
                        applied.append((external_id, None))
                        docid = self._next_docid
                        self._next_docid += 1
                        self.external_to_internal[external_id] = docid
                        self.internal_to_external[docid] = external_id
                        self.documents[docid] = doc
                        if use_batch:
                            pending.append((docid, doc))
                            pending_ids.add(docid)
                            if len(pending) >= BATCH_TOKEN_CHUNK:
                                flush_pending()
                        else:
                            self._index_document_content(docid, doc)
                        if touched is not None:
                            touched.append((docid, doc))
                            if len(touched) > delta_budget:
                                touched = None
                flush_pending()
            finally:
                # nothing may stay in flight past this call: searches and
                # later writers reason over the landed run lists only
                self._drain_native()
                if ingest_executor is not None:
                    ingest_executor.shutdown(wait=True)
                if gc_was_enabled:
                    gc.enable()
            if self._bulk_depth == 0:
                self._merge_runs()
                if touched is not None:
                    self._bump(
                        delta_ids={d for d, _doc in touched},
                        delta_docs=[doc for _d, doc in touched],
                    )
                else:
                    self._bump()
            elif received:
                self._bulk_dirty = True
            return received, received

    def _rollback_documents(self, applied: list) -> None:
        """Undo an aborted add_documents: restore replaced docs, delete
        fresh ones (newest first so re-replacements unwind correctly)."""
        for external_id, old_doc in reversed(applied):
            docid = self.external_to_internal.get(external_id)
            if docid is not None:
                self._remove_document_content(docid, self.documents[docid])
                del self.documents[docid]
                del self.external_to_internal[external_id]
                del self.internal_to_external[docid]
            if old_doc is not None:
                docid = self._next_docid
                self._next_docid += 1
                self.external_to_internal[external_id] = docid
                self.internal_to_external[docid] = external_id
                self.documents[docid] = old_doc
                self._index_document_content(docid, old_doc)

    def delete_documents(self, external_ids: Iterable[str]) -> int:
        with self._lock:
            deleted = 0
            removed: list[int] = []
            for ext in external_ids:
                ext = str(ext)
                docid = self.external_to_internal.get(ext)
                if docid is None:
                    continue
                self._remove_document_content(docid, self.documents[docid])
                del self.documents[docid]
                del self.external_to_internal[ext]
                del self.internal_to_external[docid]
                # a deleted doc needs no host-overlay scoring: the device
                # live mask already excludes it
                self.delta_docids.discard(docid)
                removed.append(docid)
                deleted += 1
            self._bump(delta_ids=set(), removed_ids=removed)
            return deleted

    def delete_all_documents(self) -> int:
        with self._lock:
            n = len(self.documents)
            self._token_runs.clear()
            self._facet_runs.clear()
            self._run_docids.clear()
            self.documents.clear()
            self.external_to_internal.clear()
            self.internal_to_external.clear()
            for table in self._all_posting_tables():
                table.clear()
            self.facet_number_docids.clear()
            self.facet_string_docids.clear()
            self.facet_string_original.clear()
            self.docid_facet_numbers.clear()
            self.docid_facet_strings.clear()
            self.vectors.clear()
            self.vector_regenerate.clear()
            self.geo_points.clear()
            self.geojson_shapes.clear()
            self._bump()
            return n

    def reindex(self) -> None:
        """Full re-derivation of all posting tables from stored documents.

        Used after settings changes that invalidate derived data
        (reference: Settings::execute expensive path, update/settings.rs).
        """
        with self._lock:
            self._token_runs.clear()
            self._facet_runs.clear()
            self._run_docids.clear()
            for table in self._all_posting_tables():
                table.clear()
            self.facet_number_docids.clear()
            self.facet_string_docids.clear()
            self.facet_string_original.clear()
            self.docid_facet_numbers.clear()
            self.docid_facet_strings.clear()
            self.geo_points.clear()
            self.geojson_shapes.clear()
            for docid, doc in self.documents.items():
                self._index_document_content(docid, doc)
            self._bump()

    def _all_posting_tables(self):
        return [
            self.word_docids,
            self.exact_word_docids,
            self.word_fid_docids,
            self.word_position_docids,
            self.word_pair_proximity_docids,
            self.field_id_word_count_docids,
            self.facet_exists_docids,
            self.facet_is_null_docids,
            self.facet_is_empty_docids,
        ]

    def spill_postings(self, directory: str) -> int:
        """Move posting-list docids off the Python heap: every table's
        lists re-serialize into ONE mmap'd column per table and each
        Posting becomes a zero-copy view into it. Logical content is
        unchanged; RSS becomes evictable page cache, so corpus-size
        ingest is no longer RAM-bound (the reference spills its
        BalancedCaches to grenad files under memory pressure,
        update/new/extract/cache.rs:1-60). Returns bytes moved.

        Facet tables spill too (they carry O(corpus) docids at scale).
        Lazy packed tables (already views) are skipped."""
        import os as _os

        from .arrays import Posting

        self._merge_runs()  # pending bulk runs must land before re-serializing
        _os.makedirs(directory, exist_ok=True)
        moved = 0
        epoch = int(self.generation)

        def spill_table(table, path):
            nonlocal moved
            from .runs import RunsPostingTable

            if isinstance(table, RunsPostingTable):
                # merged bulk bases: move the run docid columns wholesale
                moved += table.spill(path)
                return
            if not isinstance(table, dict) or not table:
                return  # lazy packed tables already serve from mmap
            parts = []
            metas = []  # (posting, start, end)
            total = 0
            import mmap as _mmap

            def ram_backed(arr) -> bool:
                # a view whose base chain reaches a memmap / mmap buffer
                # already lives in page cache (earlier spill or packed
                # boot); everything else — owning arrays AND slices of
                # RAM arrays (the native indexer emits those) — is
                # heap-resident
                base = arr
                while base is not None:
                    if isinstance(
                        base, (np.memmap, _mmap.mmap, memoryview, bytes)
                    ):
                        return False
                    base = getattr(base, "base", None)
                return True

            for p in table.values():
                if not isinstance(p, Posting):
                    continue
                arr = p.ids_array()
                if not len(arr) or not ram_backed(arr):
                    continue
                parts.append(arr)
                metas.append((p, total, total + len(arr)))
                total += len(arr)
            if not parts:
                return
            ids = np.concatenate(parts)
            np.save(path, ids)
            view = np.load(path + ".npy", mmap_mode="r")
            for p, a, b in metas:
                if isinstance(p, Posting):
                    p.segs = [view[a:b]]
                    p.extra = None
                    p.dead = None
            moved += int(ids.nbytes)

        with self._lock:
            names = [
                "word_docids",
                "exact_word_docids",
                "word_fid_docids",
                "word_position_docids",
                "word_pair_proximity_docids",
                "field_id_word_count_docids",
                "facet_exists_docids",
                "facet_is_null_docids",
                "facet_is_empty_docids",
            ]
            for name in names:
                spill_table(
                    getattr(self, name),
                    _os.path.join(directory, f"{name}.{epoch}"),
                )
            for outer_name in ("facet_number_docids", "facet_string_docids"):
                outer = getattr(self, outer_name)
                if not isinstance(outer, dict):
                    continue
                for fid, sub in outer.items():
                    spill_table(
                        sub,
                        _os.path.join(
                            directory, f"{outer_name}.{fid}.{epoch}"
                        ),
                    )
        return moved

    def delta_cap(self) -> int:
        """Max delta size before the base promotes (and the device arena
        re-anchors). Scales with the corpus so the host overlay's share of
        scoring work stays bounded."""
        env = os.environ.get("MEILI_TPU_DELTA_CAP")
        if env:
            return int(env)
        return max(512, len(self.documents) // 128)

    def _bump(self, delta_ids=None, delta_docs=None, removed_ids=None):
        """Advance the generation.

        delta_ids marks a MINOR write (the touched internal docids): the
        base generation stays put, so the device arena rows, derivation
        caches and packed vocabulary survive; queries exclude the delta
        docids from the device live mask and score them host-side
        (device_batch score_delta overlay), exactly. Without delta_ids the
        write is MAJOR: the base promotes and base-anchored structures
        rebuild on demand (the round-2 flush-everything behavior)."""
        self.generation += 1
        self.updated_at = time.time()
        self._field_cache.clear()
        self._docids_cache = None
        minor = (
            delta_ids is not None
            and os.environ.get("MEILI_TPU_INCREMENTAL", "1") == "1"
            and len(self.delta_docids) + len(delta_ids) <= self.delta_cap()
        )
        if not minor:
            self._vocab_cache = None
            self._vocab_snapshot = None
            self._docids_sorted_incr = None
            self.base_generation = self.generation
            self.delta_docids = set()
            self._delta_version += 1
            return
        self.delta_docids.update(delta_ids)
        # maintain the sorted all-docids array in place: a full rebuild
        # from the 1M-key dict costs ~100 ms per write (arrays.docids_array
        # reads this via documents_ids_array)
        incr = self._docids_sorted_incr
        if incr is not None:
            from .arrays import difference as _diff, union_many as _union

            if delta_ids:
                fresh = np.fromiter(delta_ids, np.int64, len(delta_ids))
                fresh.sort()
                incr = _union([incr, fresh])
            if removed_ids:
                gone = np.fromiter(removed_ids, np.int64, len(removed_ids))
                gone.sort()
                incr = _diff(incr, gone)
            self._docids_sorted_incr = incr
        self._delta_version += 1
        snap = self._vocab_snapshot
        if snap is None:
            # no snapshot tracking the vocabulary yet: the sorted list
            # cannot be maintained incrementally, so it must rebuild
            self._vocab_cache = None
        if delta_docs and snap is not None:
            new_words: set[str] = set()
            for doc in delta_docs:
                for toks in self._tokenize_document(doc).values():
                    for w, _pos in toks:
                        if not snap.contains(w):
                            new_words.add(w)
            if new_words:
                snap.add_delta_words(new_words)
                if self._vocab_cache is not None:
                    # keep the merged sorted list current: C-level memmove
                    # insort beats a 1M-word resort by orders of magnitude
                    import bisect as _bisect

                    for w in sorted(new_words):
                        _bisect.insort(self._vocab_cache, w)

    def vocab_snapshot(self):
        """The base/delta vocabulary snapshot (created lazily at first
        derivation; minor writes append to its delta, promotion drops it)."""
        if self._vocab_snapshot is None:
            self._vocab_snapshot = VocabSnapshot(self.all_words_sorted())
        return self._vocab_snapshot

    # -- extraction ------------------------------------------------------

    def _iter_searchable_leaves(self, doc: dict):
        """Yield (field_path, leaf_value) for tokenization, in document order.

        Reference: tokenize_document.rs:tokenize_document — nested objects and
        arrays are traversed, each leaf tokenized under its dotted path fid.
        """

        def rec(val, path):
            if isinstance(val, dict):
                for k, v in val.items():
                    yield from rec(v, f"{path}.{k}" if path else k)
            elif isinstance(val, list):
                for item in val:
                    yield from rec(item, path)
            else:
                yield (path, val)

        for key, value in doc.items():
            if key in (RESERVED_VECTORS_FIELD, RESERVED_GEO_FIELD, RESERVED_GEOJSON_FIELD):
                continue
            yield from rec(value, key)

    def _searchable_weight_for(self, field_path: str) -> Optional[int]:
        cached = self._field_cache.get(field_path)
        if cached is not None and cached[0] is not False:
            return cached[0]
        s = self.settings
        weight: Optional[int] = None
        if s.searchable_is_wildcard():
            weight = 0
        else:
            for w, pattern in enumerate(s.searchable_attributes):
                if _match_pattern(pattern, field_path):
                    weight = w
                    break
        faceted = cached[1] if cached else None
        self._field_cache[field_path] = (weight, faceted)
        return weight

    def _tokenizer_for_field(self, field_path: str):
        """Tokenizer honoring the field's `localizedAttributes` rule
        (reference: tokenize_document.rs builds per-field allow-lists from
        LocalizedAttributesRule; locales.rs force_locales_* pin that a
        field forced to jpn indexes with the ja pipeline)."""
        locs = self.settings.locales_for_field(field_path)
        key = tuple(locs) if locs else None
        # keyed on the RULES object: apply_json replaces the list, so a
        # settings change invalidates the cached per-locale tokenizers
        gen = id(self.settings.localized_attributes)
        cache = getattr(self, "_field_tokenizer_cache", None)
        if cache is None or cache.get("gen") != gen:
            cache = {"gen": gen}
            self._field_tokenizer_cache = cache
        tok = cache.get(key)
        if tok is None:
            tok = self.make_tokenizer(list(key) if key else None)
            cache[key] = tok
        return tok

    def _tokenize_document(
        self, doc: dict
    ) -> dict[int, list[tuple[str, int]]]:
        """Return {fid: [(word, relative_position)...]} for searchable fields."""
        tokenizer = self.make_tokenizer()
        localized = bool(self.settings.localized_attributes)
        per_fid: dict[int, list[tuple[str, int]]] = defaultdict(list)
        fid_positions: dict[int, int] = {}
        for field_path, value in self._iter_searchable_leaves(doc):
            # Register the field in the map regardless of searchability so the
            # fields map knows all fields (reference behavior).
            fid = self.fields_ids_map.id_or_insert(field_path)
            if self._searchable_weight_for(field_path) is None:
                continue
            if value is None:
                continue
            if isinstance(value, bool):
                text = "true" if value else "false"
            elif isinstance(value, (int, float)):
                text = repr(value) if isinstance(value, float) else str(value)
            elif isinstance(value, str):
                text = value
            else:
                continue
            base = fid_positions.get(fid)
            if base is None:
                base = 0
            else:
                base += HARD_SEPARATOR_GAP
            if base >= MAX_POSITION_PER_ATTRIBUTE:
                continue
            tok = (
                self._tokenizer_for_field(field_path)
                if localized
                else tokenizer
            )
            words = tok.indexed_words(text)
            last = base
            for word, rel in words:
                pos = base + rel
                if pos >= MAX_POSITION_PER_ATTRIBUTE:
                    break
                per_fid[fid].append((word, pos))
                last = pos
            fid_positions[fid] = last
        return dict(per_fid)

    def _pairs_from_positions(
        self, words_positions: list[tuple[str, int]]
    ) -> dict[tuple[str, str], int]:
        """Sliding-window pair-proximity extraction.

        Reference: extract_word_pair_proximity_docids.rs:504-570 — pairs with
        0 < proximity < MAX_DISTANCE, deduped per document keeping the
        minimal proximity.
        """
        pairs: dict[tuple[str, str], int] = {}
        window: list[tuple[str, int]] = []

        def flush_head():
            head_word, head_pos = window.pop(0)
            for word, pos in window:
                prox = index_proximity(head_pos, pos)
                if 0 < prox < MAX_DISTANCE:
                    key = (head_word, word)
                    if key not in pairs or prox < pairs[key]:
                        pairs[key] = prox

        for word, pos in words_positions:
            while window and index_proximity(window[0][1], pos) >= MAX_DISTANCE:
                flush_head()
            window.append((word, pos))
        while window:
            flush_head()
        return pairs

    def _index_document_content(self, docid: int, doc: dict) -> None:
        self._index_document_tokens(docid, doc)
        self._index_facets(docid, doc)
        self._index_vectors(docid, doc)
        self._index_geo(docid, doc)

    def _index_document_tokens(self, docid: int, doc: dict) -> None:
        # tokenize first: it registers new field names in the fields map,
        # which exact_attributes_fids needs to resolve patterns against
        per_fid = self._tokenize_document(doc)
        exact_fids = self.exact_attributes_fids()
        word_table = self.word_docids
        exact_table = self.exact_word_docids
        wf_table = self.word_fid_docids
        wp_table = self.word_position_docids
        pp_table = self.word_pair_proximity_docids
        bucketed = bucketed_position
        for fid, words_positions in per_fid.items():
            target = exact_table if fid in exact_fids else word_table
            for word, pos in words_positions:
                target[word].add(docid)
                wf_table[(word, fid)].add(docid)
                wp_table[(word, bucketed(pos if pos < 0xFFFF else 0xFFFF))].add(
                    docid
                )
            count = len(words_positions)
            if count <= MAX_COUNTED_WORDS:
                self.field_id_word_count_docids[(fid, count)].add(docid)
            for (w1, w2), prox in self._pairs_from_positions(words_positions).items():
                pp_table[(prox, w1, w2)].add(docid)

    def _index_documents_batch(self, pending: list) -> list[int]:
        """Token postings for a batch of NEW documents in one native call
        (native/posting_builder.cpp — the data-parallel extractor family of
        update/new/extract/, collapsed into per-batch C++ aggregation).
        Returns the docids the native tokenizer could not fold
        byte-identically; the caller indexes those through the
        per-document Python path. Facets/vectors/geo stay in Python
        either way."""
        from ..analysis.native import native_build_postings

        prep = self._prep_token_batch(pending)
        if prep is None:
            return []
        res = native_build_postings(*prep)
        return self._land_token_run(pending, res)

    def _prep_token_batch(self, pending: list):
        """Main-thread half of the batch extractor: walks documents,
        registers field ids, and flattens searchable text into the
        (texts, entries) form the native indexer consumes. Must run on
        the writer thread (it mutates fields_ids_map); the returned
        tuple is immutable and safe to hand to a worker. None = nothing
        searchable in the batch."""
        import numpy as np

        texts = bytearray()
        entries: list[int] = []  # flat: docid, fid, 0, off, len per entry
        # per-field decision cache: most corpora are flat dicts of scalars,
        # so the generic nested-leaf walk is reserved for nested values
        fdecision: dict[str, tuple[Optional[int], bool]] = {}
        reserved = (
            RESERVED_VECTORS_FIELD,
            RESERVED_GEO_FIELD,
            RESERVED_GEOJSON_FIELD,
        )
        id_or_insert = self.fields_ids_map.id_or_insert
        off = 0
        for docid, doc in pending:
            for key, value in doc.items():
                tv = type(value)
                if tv is dict or tv is list:
                    # nested: the generic walk (registers dotted paths,
                    # preserves leaf order for position chaining)
                    for path, leaf in self._iter_searchable_leaves(
                        {key: value}
                    ):
                        fid = id_or_insert(path)
                        if self._searchable_weight_for(path) is None:
                            continue
                        if leaf is None:
                            continue
                        if isinstance(leaf, bool):
                            text = "true" if leaf else "false"
                        elif isinstance(leaf, (int, float)):
                            text = (
                                repr(leaf)
                                if isinstance(leaf, float)
                                else str(leaf)
                            )
                        elif isinstance(leaf, str):
                            text = leaf
                        else:
                            continue
                        data = text.encode("utf-8")
                        entries += (docid, fid, 0, off, len(data))
                        off += len(data)
                        texts += data
                    continue
                dec = fdecision.get(key)
                if dec is None:
                    if key in reserved:
                        dec = (None, False)
                    else:
                        fid = id_or_insert(key)
                        dec = (
                            fid,
                            self._searchable_weight_for(key) is not None,
                        )
                    fdecision[key] = dec
                fid, searchable = dec
                if not searchable or value is None:
                    continue
                if tv is str:
                    text = value
                elif tv is bool:
                    text = "true" if value else "false"
                elif tv is int:
                    text = str(value)
                elif tv is float:
                    text = repr(value)
                else:
                    continue
                data = text.encode("utf-8")
                entries += (docid, fid, 0, off, len(data))
                off += len(data)
                texts += data
        if not entries:
            return None
        # exact flags are resolved only after every field is registered
        exact_fids = self.exact_attributes_fids()
        arr = np.array(entries, dtype=np.int32).reshape(-1, 5)
        if exact_fids:
            arr[:, 2] = np.isin(arr[:, 1], list(exact_fids))
        return bytes(texts), arr, self.settings.stop_words

    def _land_token_run(self, pending: list, res) -> list[int]:
        """Writer-thread half: buffer the native run for the deferred
        merge. Returns fallback docids (res None = native unavailable,
        everything falls back to the per-document Python path)."""
        if res is None:
            return [docid for docid, _doc in pending]
        # defer the merge: the run (grouped key/len/docid columns + local
        # vocabulary, zero-copy views into the native buffer) buffers until
        # _merge_runs folds every pending run in one vectorized pass
        self._token_runs.append(res)
        self._run_docids.update(d for d, _doc in pending)
        return [int(x) for x in res["fallback"]]

    def _submit_native(self, pending: list, executor) -> None:
        """Dispatch the native tokenize/build of `pending` to the ingest
        worker (extractor<->writer overlap, the bbqueue-channel analogue
        of reference update/new/channel.rs:54 with capacity 1). The
        batch's docids enter _run_docids NOW so a replace/delete of an
        in-flight document routes through _merge_runs, which drains
        first."""
        from ..analysis.native import native_build_postings

        self._drain_native()
        prep = self._prep_token_batch(pending)
        if prep is None:
            self._index_facets_batch_and_rest(pending)
            return
        fut = executor.submit(native_build_postings, *prep)
        self._run_docids.update(d for d, _doc in pending)
        self._native_inflight = (pending, fut)
        # facets/vectors/geo for THIS batch run on the writer thread
        # while the worker tokenizes — that concurrency is the overlap
        self._index_facets_batch_and_rest(pending)

    def _drain_native(self) -> None:
        """Block on the in-flight native build and land its run. Called
        from _merge_runs, from the abort path, and at add_documents end
        — nothing may read or fold the run lists past an in-flight
        build."""
        inflight = self._native_inflight
        if inflight is None:
            return
        self._native_inflight = None
        pending, fut = inflight
        try:
            res = fut.result()
        except Exception:
            res = None
        for docid in self._land_token_run(pending, res):
            doc = self.documents.get(docid)
            if doc is not None:
                self._index_document_tokens(docid, doc)

    def _index_facets_batch_and_rest(self, pending: list) -> None:
        """The non-token extractors for a flushed batch (shared between
        the sync and overlapped paths)."""
        fr0 = len(self._facet_runs)
        self._index_facets_batch(pending)
        if len(self._facet_runs) > fr0:
            self._run_docids.update(d for d, _doc in pending)
        for d, dd in pending:
            self._index_vectors(d, dd)
            self._index_geo(d, dd)

    def _remove_document_content(self, docid: int, doc: dict) -> None:
        if self._run_docids and docid in self._run_docids:
            # the doc's postings still sit in unmerged bulk runs where
            # per-key discards can't reach them — fold the runs first
            self._merge_runs()

        def discard(table: dict, key):
            s = table.get(key)
            if s is not None:
                s.discard(docid)
                if not s:
                    del table[key]

        exact_fids = self.exact_attributes_fids()
        per_fid = self._tokenize_document(doc)
        for fid, words_positions in per_fid.items():
            is_exact = fid in exact_fids
            for word, pos in words_positions:
                if is_exact:
                    discard(self.exact_word_docids, word)
                else:
                    discard(self.word_docids, word)
                discard(self.word_fid_docids, (word, fid))
                discard(
                    self.word_position_docids,
                    (word, bucketed_position(min(pos, 0xFFFF))),
                )
            count = len(words_positions)
            if count <= MAX_COUNTED_WORDS:
                discard(self.field_id_word_count_docids, (fid, count))
            for (w1, w2), prox in self._pairs_from_positions(words_positions).items():
                discard(self.word_pair_proximity_docids, (prox, w1, w2))

        # facets
        for fid_key in list(self.facet_number_docids.keys()):
            values = self.docid_facet_numbers.pop((fid_key, docid), None)
            if values:
                table = self.facet_number_docids[fid_key]
                for v in values:
                    s = table.get(v)
                    if s is not None:
                        s.discard(docid)
                        if not s:
                            del table[v]
        for fid_key in list(self.facet_string_docids.keys()):
            values = self.docid_facet_strings.pop((fid_key, docid), None)
            if values:
                table = self.facet_string_docids[fid_key]
                for norm, _orig in values:
                    s = table.get(norm)
                    if s is not None:
                        s.discard(docid)
                        if not s:
                            del table[norm]
                            self.facet_string_original.pop((fid_key, norm), None)
        for table in (
            self.facet_exists_docids,
            self.facet_is_null_docids,
            self.facet_is_empty_docids,
        ):
            for key in list(table.keys()):
                table[key].discard(docid)
                if not table[key]:
                    del table[key]

        for emb in list(self.vectors.keys()):
            self.vectors[emb].pop(docid, None)
            self.vector_regenerate[emb].pop(docid, None)
        self.geo_points.pop(docid, None)
        self.geojson_shapes.pop(docid, None)

    # -- facets -----------------------------------------------------------

    def _index_facets(self, docid: int, doc: dict) -> None:
        flat = flatten_json(doc)
        per_fid_numbers: dict[int, list[float]] = defaultdict(list)
        per_fid_strings: dict[int, list[tuple[str, str]]] = defaultdict(list)
        for field_path, values in flat.items():
            if field_path.startswith(RESERVED_VECTORS_FIELD):
                continue
            fid = self.fields_ids_map.id_or_insert(field_path)
            if not self._is_faceted(field_path):
                continue
            self.facet_exists_docids[fid].add(docid)
            top_value = _lookup_path(doc, field_path)
            if top_value is None and field_path in doc and doc[field_path] is None:
                pass
            for value in values:
                if value is None:
                    self.facet_is_null_docids[fid].add(docid)
                elif isinstance(value, bool):
                    norm = "true" if value else "false"
                    per_fid_strings[fid].append((norm, norm))
                elif isinstance(value, (int, float)):
                    f = float(value)
                    if not math.isnan(f):
                        per_fid_numbers[fid].append(f)
                elif isinstance(value, str):
                    if value == "":
                        self.facet_is_empty_docids[fid].add(docid)
                    else:
                        norm = facet_string_normalize(value)
                        per_fid_strings[fid].append((norm, truncate_facet_string(value)))
                elif isinstance(value, (list, dict)):
                    if not value:
                        self.facet_is_empty_docids[fid].add(docid)
        for fid, numbers in per_fid_numbers.items():
            uniq = sorted(set(numbers))
            self.docid_facet_numbers[(fid, docid)] = uniq
            for v in uniq:
                self.facet_number_docids[fid][v].add(docid)
        for fid, strings in per_fid_strings.items():
            seen: dict[str, str] = {}
            for norm, orig in strings:
                seen.setdefault(norm, orig)
            pairs = sorted(seen.items())
            self.docid_facet_strings[(fid, docid)] = pairs
            for norm, orig in pairs:
                self.facet_string_docids[fid][norm].add(docid)
                self.facet_string_original.setdefault((fid, norm), orig)

    def _index_facets_batch(self, pending: list) -> None:
        """Facet extraction for a batch of documents, column-wise.

        Behavior-identical to per-document `_index_facets` for flat
        scalar documents (the common case; any document with a nested
        value falls back to it): per-field decisions resolve once per
        batch, string normalization memoizes per raw value, and docids
        land in the facet sets via bulk `set.update`. This is the
        single-core collapse of the reference's parallel faceted
        extractors (update/new/extract/faceted/extract_facets.rs) —
        profiling showed the per-document path at ~55% of indexing time.
        """
        scalars = _SCALAR_TYPES
        fdec: dict[str, Any] = {}
        exists_cols: dict[int, list[int]] = defaultdict(list)
        null_cols: dict[int, list[int]] = defaultdict(list)
        empty_cols: dict[int, list[int]] = defaultdict(list)
        num_cols: dict[int, tuple[list[int], list[float]]] = {}
        # string facets, columnar: norms intern into a run-local id space
        # (norm_list/orig_list aligned); the value cache folds raw-value ->
        # nid so the common repeated-value case is one dict probe
        nid_cache: dict[Any, int] = {}
        norm_list: list[str] = []
        orig_list: list[str] = []
        fs_fid: list[int] = []
        fs_nid: list[int] = []
        fs_docid: list[int] = []
        docid_nums = self.docid_facet_numbers
        docid_strs = self.docid_facet_strings
        id_or_insert = self.fields_ids_map.id_or_insert
        for docid, doc in pending:
            fast = True
            for v in doc.values():
                if type(v) not in scalars:
                    fast = False
                    break
            if not fast:
                self._index_facets(docid, doc)
                continue
            for key, value in doc.items():
                dec = fdec.get(key, False)
                if dec is False:
                    if key.startswith(RESERVED_VECTORS_FIELD):
                        dec = None
                    else:
                        fid = id_or_insert(key)
                        dec = (fid, self._is_faceted(key))
                    fdec[key] = dec
                if dec is None:
                    continue
                fid, faceted = dec
                if not faceted:
                    continue
                exists_cols[fid].append(docid)
                tv = type(value)
                if value is None:
                    null_cols[fid].append(docid)
                elif tv is bool:
                    norm = "true" if value else "false"
                    nid = nid_cache.get(value)
                    if nid is None:
                        nid = nid_cache[value] = len(norm_list)
                        norm_list.append(norm)
                        orig_list.append(norm)
                    fs_fid.append(fid)
                    fs_nid.append(nid)
                    fs_docid.append(docid)
                    docid_strs[(fid, docid)] = [(norm, norm)]
                elif tv is int or tv is float:
                    f = float(value)
                    if f == f:  # not NaN
                        col = num_cols.get(fid)
                        if col is None:
                            col = num_cols[fid] = ([], [])
                        col[0].append(docid)
                        col[1].append(f)
                        docid_nums[(fid, docid)] = [f]
                elif value == "":
                    empty_cols[fid].append(docid)
                else:
                    nid = nid_cache.get(value)
                    if nid is None:
                        nid = nid_cache[value] = len(norm_list)
                        norm_list.append(facet_string_normalize(value))
                        orig_list.append(truncate_facet_string(value))
                    fs_fid.append(fid)
                    fs_nid.append(nid)
                    fs_docid.append(docid)
                    docid_strs[(fid, docid)] = [(norm_list[nid], orig_list[nid])]
        # exists/null/empty: fresh ascending docids land as whole segments
        for fid, col in exists_cols.items():
            self.facet_exists_docids[fid].add_segment(
                np.asarray(col, dtype=np.int64)
            )
        for fid, col in null_cols.items():
            self.facet_is_null_docids[fid].add_segment(
                np.asarray(col, dtype=np.int64)
            )
        for fid, col in empty_cols.items():
            self.facet_is_empty_docids[fid].add_segment(
                np.asarray(col, dtype=np.int64)
            )
        if norm_list or num_cols:
            self._facet_runs.append(
                {
                    "str": (norm_list, orig_list, fs_fid, fs_nid, fs_docid),
                    "num": num_cols,
                }
            )
            self._run_docids.update(d for d, _doc in pending)

    def _index_vectors(self, docid: int, doc: dict) -> None:
        vectors = doc.get(RESERVED_VECTORS_FIELD)
        if not isinstance(vectors, dict):
            return
        for embedder, spec in vectors.items():
            regenerate = False
            embeddings = spec
            if isinstance(spec, dict):
                embeddings = spec.get("embeddings")
                regenerate = bool(spec.get("regenerate", False))
            if embeddings is None:
                self.vector_regenerate[embedder][docid] = regenerate
                continue
            arr = np.asarray(embeddings, dtype=np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            self.vectors[embedder][docid] = arr
            self.vector_regenerate[embedder][docid] = regenerate

    def _index_geo(self, docid: int, doc: dict) -> None:
        geo = doc.get(RESERVED_GEO_FIELD)
        if isinstance(geo, dict):
            lat, lng = geo.get("lat"), geo.get("lng")
            try:
                if lat is not None and lng is not None:
                    self.geo_points[docid] = (float(lat), float(lng))
            except (TypeError, ValueError):
                pass
        geojson = doc.get(RESERVED_GEOJSON_FIELD)
        if geojson is not None:
            from .geojson import parse_geojson

            shapes = parse_geojson(geojson)
            if shapes:
                self.geojson_shapes[docid] = shapes

    # ------------------------------------------------------------------
    # read API (mirrors milli db_cache accessors)

    def documents_ids(self) -> frozenset:
        """All docids as an immutable per-generation snapshot — callers must
        not mutate (set operators return fresh sets)."""
        if self._docids_cache is None:
            self._docids_cache = frozenset(self.documents.keys())
        return self._docids_cache

    def documents_ids_array(self) -> np.ndarray:
        """Sorted all-docids array, maintained INCREMENTALLY across minor
        writes (_bump applies the delta with two array merges instead of a
        full dict-keys rebuild)."""
        if self._docids_sorted_incr is None:
            from .arrays import to_array

            self._docids_sorted_incr = to_array(set(self.documents.keys()))
        return self._docids_sorted_incr

    def contains_word(self, word: str) -> bool:
        return word in self.word_docids or word in self.exact_word_docids

    def get_word_docids(self, word: str) -> set[int]:
        """word_docids ∪ exact_word_docids (reference: db_cache.rs:183)."""
        out = self.word_docids.get(word)
        exact = self.exact_word_docids.get(word)
        if out and exact:
            return out | exact
        return set(out or exact or ())

    def compact(self) -> tuple[int, int]:
        """Merge every posting's LSM segments, drop tombstones and empty
        entries, and return (pre_bytes, post_bytes) estimates — the
        in-memory analogue of the reference's LMDB copy-compact
        (process_batch.rs:443 `copy_to_path`). Queries already compact
        lazily per posting; this forces the whole index so a long-lived
        write-heavy index releases segment and tombstone overhead at once."""

        from .arrays import Posting

        def posting_bytes(p) -> int:
            if not isinstance(p, Posting):
                return len(p) * 8 if hasattr(p, "__len__") else 0
            n = sum(seg.nbytes for seg in p.segs)
            # set entries cost far more than packed int64s
            n += 64 * (len(p.extra or ()) + len(p.dead or ()))
            return n

        with self._lock:
            pre = 0
            post = 0
            for table in self._all_posting_tables():
                empty_keys = []
                for key, p in table.items():
                    pre += posting_bytes(p)
                    if isinstance(p, Posting):
                        arr = p.ids_array()  # merges segments in place
                        if not len(arr):
                            empty_keys.append(key)
                    post += posting_bytes(p)
                for key in empty_keys:
                    del table[key]
            # spill-mode documents: drop orphaned versions on disk too
            pre += self.documents.file_bytes()
            self.documents.vacuum()
            post += self.documents.file_bytes()
            self._bump()
            return pre, post

    def set_shard_topology(self, shard_names) -> None:
        """Install (or clear, with None/empty) the shard name set. Docid
        ownership is recomputed lazily (shard_docids)."""
        with self._lock:
            self.shard_topology = sorted(shard_names) if shard_names else None
            self._shard_docids_cache = None
            self._bump()

    def shard_docids(self, shard: str) -> set:
        """Docids owned by `shard` under rendezvous hashing of external ids
        (reference: DbShardDocids, index.rs:1908; highest-hash-wins
        assignment, sharding/enterprise_edition.rs:43)."""
        cache = self._shard_docids_cache
        if cache is None or cache[0] != self.generation:
            by_shard: dict[str, set] = {}
            topo = self.shard_topology
            if topo:
                from ..parallel.rendezvous import rendezvous_shard

                for ext, docid in self.external_to_internal.items():
                    by_shard.setdefault(
                        rendezvous_shard(ext, topo), set()
                    ).add(docid)
            cache = (self.generation, by_shard)
            self._shard_docids_cache = cache
        return cache[1].get(shard, set())

    def all_words_sorted(self) -> list[str]:
        """Sorted vocabulary, cached per generation (VERDICT r1 Weak #4:
        O(V log V) per prefix term per query dominated at 1M-doc vocab)."""
        if self._vocab_cache is None:
            if self._vocab_snapshot is not None:
                # minor writes maintain base+delta; merging beats resorting
                self._vocab_cache = self._vocab_snapshot.merged_words()
            else:
                self._vocab_cache = sorted(
                    set(self.word_docids) | set(self.exact_word_docids)
                )
        return self._vocab_cache

    def stats(self) -> dict:
        field_distribution: dict[str, int] = defaultdict(int)
        for doc in self.documents.values():
            for key in doc.keys():
                field_distribution[key] += 1
        return {
            "numberOfDocuments": len(self.documents),
            "isIndexing": False,
            "fieldDistribution": dict(sorted(field_distribution.items())),
        }


def _lookup_path(doc: dict, path: str):
    cur: Any = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur
