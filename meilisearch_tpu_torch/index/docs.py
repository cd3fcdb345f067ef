"""Document store: docid -> document, with an off-RAM spill mode.

The reference keeps documents on disk always — the `documents` LMDB
database holds obkv-encoded bodies and readers mmap them (milli
`index.rs` documents DB; corpus ≫ RAM is a design requirement of L6).
This module is the equivalent step for the TPU-native store: RAM mode is
a plain dict (small corpora, zero overhead); spill mode keeps only
`{docid: (offset, length)}` in RAM, appends JSON lines to an on-disk
segment file, and decodes on demand through a small LRU — documents stop
driving the resident set while postings stay in RAM.

Updates append a new version (the old bytes are orphaned); `vacuum()`
rewrites the live set and is wired into the index-compaction task.
Reads use `os.pread`, so they are safe from concurrent reader threads;
mutation stays single-writer under the store lock like every other
table.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Any, Iterator, Optional

_LRU_CAP = 512


def spill_enabled() -> bool:
    """Global default for new stores (option: experimental_docs_on_disk /
    MEILI_TPU_DOCS_SPILL=1)."""
    return os.environ.get("MEILI_TPU_DOCS_SPILL") == "1"


class DocTable:
    """Mutable mapping of docid -> document dict (RAM or spill-backed)."""

    __slots__ = (
        "_ram",
        "_offsets",
        "_fd",
        "_path",
        "_lru",
        "_end",
        "_packed",
        "_packed_gone",
        "_packed_path",
    )

    def __init__(self, spill_path: Optional[str] = None):
        self._ram: Optional[dict[int, dict]] = {}
        self._offsets: dict[int, tuple[int, int]] = {}
        self._fd: Optional[int] = None
        self._path: Optional[str] = None
        self._lru: OrderedDict[int, dict] = OrderedDict()
        self._end = 0
        # packed base: (read-only fd, sorted docid array, offsets, lengths)
        # over an immutable packed-snapshot docs.jsonl; mutations overlay
        self._packed = None
        self._packed_gone: set[int] = set()
        self._packed_path: Optional[str] = None
        if spill_path is not None or spill_enabled():
            self.enable_spill(spill_path)

    # -- mode ---------------------------------------------------------------

    @property
    def spilled(self) -> bool:
        return self._fd is not None

    # -- packed base (zero-copy boot restore, index/packed.py v2) ----------

    def attach_packed(self, path, doc_ids, offsets, lengths) -> None:
        """Serve documents straight from a packed snapshot's docs.jsonl:
        RSS holds the three columns, not the corpus. Mutations overlay
        into the usual RAM/spill table (the snapshot file stays
        immutable); overlaid/deleted docids are masked out of the base."""
        import numpy as np

        fd = os.open(path, os.O_RDONLY)
        self._packed = (
            fd,
            np.asarray(doc_ids),
            np.asarray(offsets),
            np.asarray(lengths),
        )
        self._packed_gone = set()
        self._packed_path = path

    def packed_clean_source(self):
        """(source docs.jsonl path, doc_ids, offsets, lens) when this
        table is an UNMODIFIED packed base — the saver then copies the
        file instead of re-parsing and re-serializing every document
        (measured ~15 min of the 1M-doc save)."""
        if self._packed is None or self._packed_gone:
            return None
        if self._overlay_table():
            return None
        _fd, ids, offs, lens = self._packed
        return self._packed_path, ids, offs, lens

    def _packed_find(self, docid: int) -> int:
        import numpy as np

        _fd, ids, _o, _l = self._packed
        i = int(np.searchsorted(ids, docid))
        if i < len(ids) and int(ids[i]) == docid:
            return i
        return -1

    def _packed_read(self, i: int) -> dict:
        fd, _ids, offs, lens = self._packed
        import json as _json

        line = os.pread(fd, int(lens[i]), int(offs[i]))
        return _json.loads(line)[1]

    def _packed_get(self, docid: int):
        if self._packed is None or docid in self._packed_gone:
            return None
        doc = self._lru.get(docid)
        if doc is not None:
            self._lru.move_to_end(docid)
            return doc
        i = self._packed_find(docid)
        if i < 0:
            return None
        doc = self._packed_read(i)
        self._lru[docid] = doc
        if len(self._lru) > _LRU_CAP:
            self._lru.popitem(last=False)
        return doc

    def enable_spill(self, path: Optional[str] = None) -> None:
        """Switch to the on-disk backend (migrates any existing docs)."""
        if self._fd is not None:
            return
        if path is None:
            fd, path = tempfile.mkstemp(
                prefix="meili_tpu_docs_", suffix=".jsonl"
            )
            os.close(fd)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        self._end = 0
        ram, self._ram = self._ram, None
        for docid, doc in (ram or {}).items():
            self[docid] = doc

    def _write(self, doc: dict) -> tuple[int, int]:
        data = json.dumps(doc, ensure_ascii=False).encode("utf-8")
        off = self._end
        os.pwrite(self._fd, data, off)
        self._end = off + len(data)
        return off, len(data)

    def _read(self, docid: int) -> dict:
        doc = self._lru.get(docid)
        if doc is not None:
            self._lru.move_to_end(docid)
            return doc
        off, length = self._offsets[docid]
        doc = json.loads(os.pread(self._fd, length, off))
        self._lru[docid] = doc
        if len(self._lru) > _LRU_CAP:
            self._lru.popitem(last=False)
        return doc

    # -- mapping protocol ---------------------------------------------------

    def __getitem__(self, docid: int) -> dict:
        if self._ram is not None and docid in self._ram:
            return self._ram[docid]
        if self._ram is None and docid in self._offsets:
            return self._read(docid)
        doc = self._packed_get(docid)
        if doc is None:
            raise KeyError(docid)
        return doc

    def get(self, docid: int, default: Any = None) -> Any:
        if self._ram is not None and docid in self._ram:
            return self._ram[docid]
        if self._ram is None and docid in self._offsets:
            return self._read(docid)
        doc = self._packed_get(docid)
        return doc if doc is not None else default

    def __setitem__(self, docid: int, doc: dict) -> None:
        if self._packed is not None and docid not in self._packed_gone:
            # mask the base copy only if one exists (the overlay shadows it)
            if self._packed_find(docid) >= 0:
                self._packed_gone.add(docid)
            self._lru.pop(docid, None)
        if self._ram is not None:
            self._ram[docid] = doc
            return
        self._offsets[docid] = self._write(doc)
        self._lru.pop(docid, None)

    def __delitem__(self, docid: int) -> None:
        present = False
        if self._ram is not None and docid in self._ram:
            del self._ram[docid]
            present = True
        elif self._ram is None and docid in self._offsets:
            del self._offsets[docid]
            self._lru.pop(docid, None)
            present = True
        if self._packed is not None and docid not in self._packed_gone:
            if self._packed_find(docid) >= 0:
                self._packed_gone.add(docid)
                self._lru.pop(docid, None)
                present = True
        if not present:
            raise KeyError(docid)

    def _overlay_table(self) -> dict:
        return self._ram if self._ram is not None else self._offsets

    def __contains__(self, docid: int) -> bool:
        if docid in self._overlay_table():
            return True
        return (
            self._packed is not None
            and docid not in self._packed_gone
            and self._packed_find(docid) >= 0
        )

    def __len__(self) -> int:
        n = len(self._overlay_table())
        if self._packed is not None:
            n += len(self._packed[1]) - len(self._packed_gone)
        return n

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self) -> Iterator[int]:
        yield from self._overlay_table()
        if self._packed is not None:
            gone = self._packed_gone
            for d in self._packed[1].tolist():
                if d not in gone:
                    yield d

    def keys(self):
        return iter(self)

    def values(self):
        return (self[d] for d in list(self))

    def items(self):
        return ((d, self[d]) for d in list(self))

    def clear(self) -> None:
        if self._packed is not None:
            self._packed_gone.update(self._packed[1].tolist())
        if self._ram is not None:
            self._ram.clear()
            return
        self._offsets.clear()
        self._lru.clear()
        os.ftruncate(self._fd, 0)
        self._end = 0

    # -- maintenance --------------------------------------------------------

    def approx_bytes(self) -> int:
        """Serialized-corpus size estimate for /stats databaseSize: exact
        live bytes in spill mode, a 64-doc sample extrapolation in RAM
        mode (stringifying the whole table was O(corpus) per stats
        call)."""
        packed_bytes = 0
        if self._packed is not None:
            _fd, ids, _o, lens = self._packed
            packed_bytes = int(lens.sum()) if len(ids) else 0
        if self.spilled:
            return self.live_bytes() + packed_bytes
        n = len(self._ram)
        if n == 0:
            return packed_bytes
        sample = []
        for _, doc in self._ram.items():
            sample.append(len(json.dumps(doc, ensure_ascii=False)))
            if len(sample) >= 64:
                break
        return packed_bytes + int(sum(sample) / len(sample) * n)

    def file_bytes(self) -> int:
        """On-disk segment size (including orphaned versions)."""
        return self._end if self.spilled else 0

    def live_bytes(self) -> int:
        return sum(ln for _, ln in self._offsets.values()) if self.spilled else 0

    def vacuum(self) -> int:
        """Rewrite the live set, dropping orphaned document versions.
        Returns bytes reclaimed (index-compaction task hook)."""
        if not self.spilled:
            return 0
        before = self._end
        new_end = 0
        # ascending offset order: the in-place shift only ever moves
        # bytes downward, so a source region is never clobbered before
        # it is read
        for docid, (off, length) in sorted(
            self._offsets.items(), key=lambda kv: kv[1][0]
        ):
            data = os.pread(self._fd, length, off)
            os.pwrite(self._fd, data, new_end)
            self._offsets[docid] = (new_end, length)
            new_end += length
        os.ftruncate(self._fd, new_end)
        self._end = new_end
        self._lru.clear()
        return before - new_end

    def close(self) -> None:
        if self._packed is not None:
            try:
                os.close(self._packed[0])
            except OSError:
                pass
            self._packed = None
        if self._fd is not None:
            try:
                os.close(self._fd)
            finally:
                self._fd = None
                if self._path and self._path.startswith(
                    tempfile.gettempdir()
                ):
                    try:
                        os.unlink(self._path)
                    except OSError:
                        pass

    def __del__(self):  # best-effort temp cleanup
        try:
            self.close()
        except Exception:
            pass
