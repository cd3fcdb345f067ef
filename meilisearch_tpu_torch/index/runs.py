"""Merged bulk-ingest run bases: posting tables as sorted code columns.

The grenad-merge analogue of the reference's indexing pipeline
(update/new/extract/cache.rs BalancedCaches + the bbqueue writer,
update/new/channel.rs): a bulk ingest accumulates the native indexer's
per-chunk outputs as columnar *runs*; at batch end the DISTINCT keys of
every run (already grouped by the C++ indexer) merge into one sorted
int64-code column per table — no per-key Python objects, no expanded
per-(key, doc) row sort. A key's docids stay where the native indexer
wrote them: per-run int32 columns, referenced by (run, lo, hi) segment
metadata. Materializing a Posting happens per TOUCHED key at query time,
exactly like the packed-boot lazy tables (index/lazy_tables.py).

At 1M docs this turns the end-of-batch merge from ~70 s of per-key dict
and Posting churn into ~3 s of numpy sorts over ~10M distinct-key rows.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np

from .arrays import Posting


class RunsBase:
    """One merged base: sorted unique key codes + per-key segment spans.

    codes[i] is the i-th key (ascending int64 code); its docid segments
    are rows seg_ptr[i]..seg_ptr[i+1] of (seg_run, seg_lo, seg_hi),
    each a slice of run_ids[seg_run[j]]. Construction is pure numpy:
    one stable argsort over the concatenated per-run distinct keys."""

    __slots__ = ("codes", "seg_ptr", "seg_run", "seg_lo", "seg_hi", "run_ids")

    def __init__(self, codes, seg_ptr, seg_run, seg_lo, seg_hi, run_ids):
        self.codes = codes
        self.seg_ptr = seg_ptr
        self.seg_run = seg_run
        self.seg_lo = seg_lo
        self.seg_hi = seg_hi
        self.run_ids = run_ids

    @classmethod
    def build(cls, parts: list, run_ids: list) -> Optional["RunsBase"]:
        """parts: per run, (codes int64 array, lens int array) over that
        run's DISTINCT keys, aligned with run_ids[r] (the run's docid
        column, segments consecutive in key order)."""
        key_parts, run_col, lo_col, hi_col = [], [], [], []
        for r, (codes, lens) in enumerate(parts):
            n = len(codes)
            if n == 0:
                continue
            starts = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=starts[1:])
            key_parts.append(codes)
            run_col.append(np.full(n, r, dtype=np.int32))
            lo_col.append(starts[:-1].astype(np.int64))
            hi_col.append(starts[1:].astype(np.int64))
        if not key_parts:
            return None
        allc = np.concatenate(key_parts)
        order = np.argsort(allc, kind="stable")  # radix: chronological ties
        sc = allc[order]
        bounds = np.flatnonzero(sc[1:] != sc[:-1]) + 1
        ptr = np.empty(len(bounds) + 2, dtype=np.int64)
        ptr[0] = 0
        ptr[1:-1] = bounds
        ptr[-1] = len(sc)
        return cls(
            sc[ptr[:-1]],
            ptr,
            np.concatenate(run_col)[order],
            np.concatenate(lo_col)[order],
            np.concatenate(hi_col)[order],
            run_ids,
        )

    def find(self, code: int) -> int:
        i = int(np.searchsorted(self.codes, code))
        if i < len(self.codes) and int(self.codes[i]) == code:
            return i
        return -1

    def segments(self, i: int) -> list[np.ndarray]:
        out = []
        run_ids = self.run_ids
        for j in range(int(self.seg_ptr[i]), int(self.seg_ptr[i + 1])):
            seg = run_ids[int(self.seg_run[j])][
                int(self.seg_lo[j]) : int(self.seg_hi[j])
            ]
            # int64 copy at touch time only: downstream set algebra and
            # the device upload assume the store's int64 convention
            out.append(seg.astype(np.int64))
        return out

    def __len__(self) -> int:
        return len(self.codes)

    def select(self, mask: np.ndarray) -> "RunsBase":
        """Subset of keys (vectorized) — used to split the combined
        word/exact-word section by its flag bit."""
        sizes = self.seg_ptr[1:] - self.seg_ptr[:-1]
        keep_sizes = sizes[mask]
        ptr = np.zeros(len(keep_sizes) + 1, dtype=np.int64)
        np.cumsum(keep_sizes, out=ptr[1:])
        rows = np.repeat(mask, sizes)
        return RunsBase(
            self.codes[mask],
            ptr,
            self.seg_run[rows],
            self.seg_lo[rows],
            self.seg_hi[rows],
            self.run_ids,
        )

    def spill(self, path: str) -> int:
        """Re-serialize the run docid columns into one mmap'd file and
        swap every column to a view of it (the BalancedCaches-spill
        analogue for merged bases). Returns bytes moved."""
        parts = [np.asarray(c) for c in self.run_ids]
        if not parts:
            return 0
        ids = np.concatenate(parts)
        np.save(path, ids)
        view = np.load(path + ".npy", mmap_mode="r")
        offs = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=offs[1:])
        self.run_ids = [
            view[int(offs[i]) : int(offs[i + 1])] for i in range(len(parts))
        ]
        return int(ids.nbytes)


class RunsPostingTable:
    """dict-of-Posting facade over one or more RunsBases plus an overlay.

    Same contract as lazy_tables.LazyPostingTable (defaultdict(Posting)
    semantics: __getitem__ creates missing keys, get() does not); the
    base lookup is encode(key) -> int64 code -> C binary search, so a
    probe costs ~1-2 µs regardless of corpus size. A key may exist in
    several bases (repeated bulk ingests); materialization unions them.
    """

    __slots__ = ("_bases", "_loaded", "_new", "_deleted")

    def __init__(self):
        # _bases: list of (RunsBase, encode(key)->Optional[int], decode(code)->key)
        self._bases: list[tuple] = []
        self._loaded: dict[Any, Posting] = {}
        self._new: dict[Any, Posting] = {}
        self._deleted: set = set()

    def add_base(self, base: RunsBase, encode, decode) -> None:
        # reconcile the overlay: keys the new base also carries must not
        # shadow its segments (minor writes before a second bulk ingest),
        # and a tombstoned key re-added by the ingest exists again with
        # ONLY the new content
        for k in list(self._new.keys()):
            code = encode(k)
            if code is not None:
                i = base.find(code)
                if i >= 0:
                    p = self._new.pop(k)
                    p.segs.extend(base.segments(i))
                    self._loaded[k] = p
        for k, p in self._loaded.items():
            code = encode(k)
            if code is not None:
                i = base.find(code)
                if i >= 0:
                    p.segs.extend(base.segments(i))
        for k in list(self._deleted):
            code = encode(k)
            if code is not None:
                i = base.find(code)
                if i >= 0:
                    self._deleted.discard(k)
                    p = Posting()
                    p.segs.extend(base.segments(i))
                    self._loaded[k] = p
        self._bases.append((base, encode, decode))

    # -- base lookup ---------------------------------------------------------

    def _base_segs(self, key) -> Optional[list[np.ndarray]]:
        segs: Optional[list[np.ndarray]] = None
        for base, encode, _dec in self._bases:
            code = encode(key)
            if code is None:
                continue
            i = base.find(code)
            if i >= 0:
                got = base.segments(i)
                segs = got if segs is None else segs + got
        return segs

    def _materialize(self, key, segs: list[np.ndarray]) -> Posting:
        p = Posting()
        p.segs.extend(segs)
        self._loaded[key] = p
        return p

    # -- mapping API ---------------------------------------------------------

    def __getitem__(self, key) -> Posting:
        p = self._loaded.get(key)
        if p is not None:
            return p
        p = self._new.get(key)
        if p is not None:
            return p
        if key not in self._deleted:
            segs = self._base_segs(key)
            if segs is not None:
                return self._materialize(key, segs)
        p = Posting()
        self._new[key] = p
        return p

    def get(self, key, default=None):
        p = self._loaded.get(key)
        if p is not None:
            return p
        p = self._new.get(key)
        if p is not None:
            return p
        if key in self._deleted:
            return default
        segs = self._base_segs(key)
        if segs is not None:
            return self._materialize(key, segs)
        return default

    def __setitem__(self, key, value) -> None:
        self._deleted.discard(key)
        if self._in_bases(key):
            self._loaded[key] = value
        else:
            self._new[key] = value

    def _in_bases(self, key) -> bool:
        for base, encode, _dec in self._bases:
            code = encode(key)
            if code is not None and base.find(code) >= 0:
                return True
        return False

    def __delitem__(self, key) -> None:
        existed = False
        if key in self._loaded:
            del self._loaded[key]
            existed = True
        if key in self._new:
            del self._new[key]
            existed = True
        if self._in_bases(key):
            self._deleted.add(key)
            existed = True
        if not existed:
            raise KeyError(key)

    def pop(self, key, *default):
        p = self.get(key)
        if p is None:
            if default:
                return default[0]
            raise KeyError(key)
        del self[key]
        return p

    def __contains__(self, key) -> bool:
        if key in self._loaded or key in self._new:
            return True
        if key in self._deleted:
            return False
        return self._in_bases(key)

    # -- iteration -------------------------------------------------------------

    def _iter_base_keys(self) -> Iterator:
        """Distinct base keys (dedup across bases), tombstones filtered."""
        multi = len(self._bases) > 1
        seen: set = set() if multi else self._deleted
        for base, _enc, decode in self._bases:
            for c in base.codes.tolist():
                k = decode(c)
                if multi:
                    if k in seen or k in self._deleted:
                        continue
                    seen.add(k)
                elif k in seen:  # seen is _deleted in the single-base case
                    continue
                yield k

    def __iter__(self) -> Iterator:
        yield from self._iter_base_keys()
        for k in self._new:
            yield k

    def keys(self):
        return iter(self)

    def items(self):
        # untouched base keys yield TRANSIENT Postings (same contract as
        # LazyPostingTable.items: a full iteration must not materialize
        # the corpus; writers go through __getitem__, which caches)
        for k in self._iter_base_keys():
            p = self._loaded.get(k)
            if p is None:
                segs = self._base_segs(k)
                p = Posting()
                if segs:
                    p.segs.extend(segs)
            yield k, p
        for k, p in list(self._new.items()):
            yield k, p

    def values(self):
        for _k, p in self.items():
            yield p

    def __len__(self) -> int:
        if len(self._bases) == 1:
            return len(self._bases[0][0]) - len(self._deleted) + len(self._new)
        return sum(1 for _ in self._iter_base_keys()) + len(self._new)

    def __bool__(self) -> bool:
        return bool(self._bases) and any(
            len(b) for b, _e, _d in self._bases
        ) and (
            len(self._deleted) < sum(len(b) for b, _e, _d in self._bases)
        ) or bool(self._new) or bool(self._loaded)

    def clear(self) -> None:
        self._bases = []
        self._loaded.clear()
        self._new.clear()
        self._deleted.clear()

    def spill(self, path_prefix: str) -> int:
        moved = 0
        for i, (base, _e, _d) in enumerate(self._bases):
            moved += base.spill(f"{path_prefix}.b{i}")
        return moved


def merge_token_runs(store, runs: list[dict]) -> None:
    """Fold native-indexer token runs into the store's posting tables as
    RunsBases — one stable radix argsort per section over the runs'
    DISTINCT keys (reference merge phase: update/new/extract/cache.rs
    transpose-merge; here the 'partitions' are chronological runs).

    Eligibility (plain-dict or RunsPostingTable targets) is checked by
    the caller; packed-boot lazy tables take the per-key fold path."""
    # merge-local word interning: one dict probe per distinct word per run
    gid_of: dict[str, int] = {}
    run_gids: list[np.ndarray] = []
    for r in runs:
        words = r["words"]
        sd = gid_of.setdefault
        run_gids.append(
            np.fromiter(
                (sd(w, len(gid_of)) for w in words),
                dtype=np.int64,
                count=len(words),
            )
        )
    inv: list[str] = [""] * len(gid_of)
    for w, gi in gid_of.items():
        inv[gi] = w
    V = len(inv) or 1

    def build(name: str, encode_run) -> tuple[Optional[RunsBase], list]:
        parts, ids = [], []
        for r, g in zip(runs, run_gids):
            sec = r[name]
            lens, docids = sec[-2], sec[-1]
            parts.append(
                (encode_run(g, *sec[:-2]) if len(lens) else _EMPTY_I64, lens)
            )
            ids.append(docids)
        return RunsBase.build(parts, ids), ids

    lookup = gid_of.get  # shared by every encode closure

    # word / exact-word: one section, flag bit 0/1, split post-merge
    base, _ids = build(
        "wd",
        lambda g, wf: (g[np.asarray(wf) >> 1] << 1)
        | (np.asarray(wf, dtype=np.int64) & 1),
    )
    if base is not None:
        for flag, name in ((0, "word_docids"), (1, "exact_word_docids")):
            sel = (base.codes & 1) == flag
            if not sel.any():
                continue
            sub = base.select(sel)
            sub.codes = sub.codes >> 1  # store plain gids

            def enc(w, _lk=lookup):
                return _lk(w)

            def dec(c, _inv=inv):
                return _inv[c]

            _attach(store, name, sub, enc, dec)

    base, _ids = build(
        "wf", lambda g, wid, fid: (g[np.asarray(wid)] << 16) | fid
    )
    if base is not None:

        def enc_wf(key, _lk=lookup):
            gid = _lk(key[0])
            return None if gid is None else (gid << 16) | key[1]

        def dec_wf(c, _inv=inv):
            return (_inv[c >> 16], c & 0xFFFF)

        _attach(store, "word_fid_docids", base, enc_wf, dec_wf)

    base, _ids = build(
        "wp", lambda g, wid, bkt: (g[np.asarray(wid)] << 16) | bkt
    )
    if base is not None:

        def enc_wp(key, _lk=lookup):
            gid = _lk(key[0])
            return None if gid is None else (gid << 16) | key[1]

        def dec_wp(c, _inv=inv):
            return (_inv[c >> 16], c & 0xFFFF)

        _attach(store, "word_position_docids", base, enc_wp, dec_wp)

    base, _ids = build(
        "pp",
        lambda g, prox, w1, w2: ((g[np.asarray(w1)] * V + g[np.asarray(w2)]) << 3)
        | prox,
    )
    if base is not None:

        def enc_pp(key, _lk=lookup, _V=V):
            a = _lk(key[1])
            if a is None:
                return None
            b = _lk(key[2])
            if b is None:
                return None
            return ((a * _V + b) << 3) | key[0]

        def dec_pp(c, _inv=inv, _V=V):
            rest = c >> 3
            return (c & 7, _inv[rest // _V], _inv[rest % _V])

        _attach(store, "word_pair_proximity_docids", base, enc_pp, dec_pp)

    base, _ids = build(
        "fc",
        lambda g, fid, cnt: (np.asarray(fid, dtype=np.int64) << 16) | cnt,
    )
    if base is not None:

        def enc_fc(key):
            return (key[0] << 16) | key[1]

        def dec_fc(c):
            return (c >> 16, c & 0xFFFF)

        _attach(store, "field_id_word_count_docids", base, enc_fc, dec_fc)


_EMPTY_I64 = np.empty(0, dtype=np.int64)


def _attach(store, name: str, base: RunsBase, encode, decode) -> None:
    table = getattr(store, name)
    if isinstance(table, RunsPostingTable):
        table.add_base(base, encode, decode)
        return
    t = RunsPostingTable()
    t.add_base(base, encode, decode)
    if table:
        # migrate pre-existing dict entries: keys also in the new base
        # must include its segments (the overlay shadows the base)
        for k, p in table.items():
            if not isinstance(p, Posting):
                q = Posting()
                q.update(p)
                p = q
            segs = t._base_segs(k)
            if segs is not None:
                p.segs.extend(segs)
                t._loaded[k] = p
            else:
                t._new[k] = p
    setattr(store, name, t)


def tables_eligible(store) -> bool:
    """The bases fast path applies when every token table is a plain
    dict (incl. defaultdict) or already a RunsPostingTable — a
    packed-boot LazyPostingTable base can't absorb a RunsBase."""
    for name in (
        "word_docids",
        "exact_word_docids",
        "word_fid_docids",
        "word_position_docids",
        "word_pair_proximity_docids",
        "field_id_word_count_docids",
    ):
        if not isinstance(getattr(store, name), (dict, RunsPostingTable)):
            return False
    return True
