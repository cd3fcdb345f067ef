"""ctypes bridge to the native tokenizer (native/tokenizer.cpp).

The native path handles ASCII/Latin text (the indexing hot path); anything it
can't fold byte-for-byte identically to the Python pipeline returns -1 and
the caller falls back, so the two implementations cannot diverge on accepted
input. Built on demand by native/build.sh; absence of the .so is fine.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_LIB = None
_LIB_TRIED = False

_MAX_TOKENS = 4096
_NORM_CAP = 1 << 16


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so_path = os.path.join(root, "native", "libmstpu.so")
    src = os.path.join(root, "native", "tokenizer.cpp")
    needs_build = not os.path.exists(so_path)
    if not needs_build and os.path.exists(src):
        # rebuild when any source is newer than the library
        so_mtime = os.path.getmtime(so_path)
        src_dir = os.path.join(root, "native")
        for name in os.listdir(src_dir):
            if name.endswith(".cpp") and (
                os.path.getmtime(os.path.join(src_dir, name)) > so_mtime
            ):
                needs_build = True
                break
    if needs_build and os.path.exists(src):
        try:
            subprocess.run(
                ["sh", os.path.join(root, "native", "build.sh")],
                capture_output=True,
                timeout=120,
                check=True,
            )
        except Exception:
            return None
    if not os.path.exists(so_path):
        return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.mstpu_tokenize.restype = ctypes.c_int32
        lib.mstpu_tokenize.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.mstpu_build_postings.restype = ctypes.c_int64
        lib.mstpu_build_postings.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ]
        lib.mstpu_free.restype = None
        lib.mstpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


class _Buffers:
    def __init__(self):
        self.raw_starts = (ctypes.c_int32 * _MAX_TOKENS)()
        self.raw_lens = (ctypes.c_int32 * _MAX_TOKENS)()
        self.positions = (ctypes.c_int32 * _MAX_TOKENS)()
        self.norm_lens = (ctypes.c_int32 * _MAX_TOKENS)()
        self.norm_buf = ctypes.create_string_buffer(_NORM_CAP)


_BUFS: Optional[_Buffers] = None


def native_indexed_words(text: str, stop_words) -> Optional[list[tuple[str, int]]]:
    """Native (word, position) extraction; None -> use the Python path."""
    lib = _load()
    if lib is None:
        return None
    global _BUFS
    if _BUFS is None:
        _BUFS = _Buffers()
    data = text.encode("utf-8")
    if len(data) > _NORM_CAP // 2:
        return None
    b = _BUFS
    n = lib.mstpu_tokenize(
        data,
        len(data),
        b.raw_starts,
        b.raw_lens,
        b.positions,
        b.norm_lens,
        b.norm_buf,
        _NORM_CAP,
        _MAX_TOKENS,
    )
    if n < 0:
        return None
    out = []
    norm_off = 0
    raw = data
    for i in range(n):
        nl = b.norm_lens[i]
        word = b.norm_buf.raw[norm_off : norm_off + nl].decode("ascii")
        norm_off += nl
        if stop_words:
            raw_tok = raw[b.raw_starts[i] : b.raw_starts[i] + b.raw_lens[i]].decode(
                "utf-8"
            )
            if raw_tok in stop_words:
                continue
        # MAX_WORD_LENGTH filter matches the Python tokenizer path and the
        # batch posting indexer (milli lib.rs:146)
        if word and nl <= 250:
            out.append((word, b.positions[i]))
    return out


# -- batch posting indexer -------------------------------------------------------


def native_build_postings(texts: bytes, entries, stop_words):
    """One call per document batch: tokenize + aggregate postings in C++
    (native/posting_builder.cpp). Returns the parsed sections or None when
    the native library is unavailable.

    `entries` is an int32 array of shape (n, 5): docid, fid, exact_flag,
    text_offset, text_length — all entries of one document consecutive.
    """
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "mstpu_build_postings"):
        return None
    entries = np.ascontiguousarray(entries, dtype=np.int32)
    stop_list = sorted(stop_words or [])
    stop_blob = b"".join(w.encode("utf-8") for w in stop_list)
    stop_offs = np.zeros(len(stop_list) + 1, dtype=np.int32)
    acc = 0
    for i, w in enumerate(stop_list):
        stop_offs[i] = acc
        acc += len(w.encode("utf-8"))
    stop_offs[len(stop_list)] = acc

    out_buf = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.mstpu_build_postings(
        texts,
        len(texts),
        entries.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(entries),
        stop_blob,
        stop_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(stop_list),
        ctypes.byref(out_buf),
    )
    if n < 0:
        return None
    # zero-copy view over the C buffer: the sections below are views into
    # `raw`, so numpy's .base chain keeps it (and therefore the C buffer)
    # alive; mstpu_free fires only when the last view dies. Copying the
    # whole buffer here measured ~15% of the batch-path cost.
    import weakref

    raw = np.frombuffer(
        ctypes.cast(out_buf, ctypes.POINTER(ctypes.c_uint8 * n)).contents,
        dtype=np.int32,
    )
    weakref.finalize(raw, lib.mstpu_free, out_buf)

    (magic, n_words, blob_bytes, n_fallback,
     nk_wd, tot_wd, nk_wf, tot_wf, nk_wp, tot_wp,
     nk_pp, tot_pp, nk_fc, tot_fc) = (int(x) for x in raw[:14])
    if magic != 0x4D535042:
        return None
    p = 14
    word_offs = raw[p : p + n_words + 1]
    p += n_words + 1
    blob_padded = (blob_bytes + 3) & ~3
    blob = raw[p : p + blob_padded // 4].tobytes()[:blob_bytes]
    p += blob_padded // 4
    words = [
        blob[word_offs[i] : word_offs[i + 1]].decode("ascii")
        for i in range(n_words)
    ]
    fallback = raw[p : p + n_fallback]
    p += n_fallback

    def section(nk, total, cols):
        nonlocal p
        out = []
        for _ in range(cols):
            out.append(raw[p : p + nk])
            p += nk
        lens = raw[p : p + nk]
        p += nk
        docids = raw[p : p + total]
        p += total
        return (*out, lens, docids)

    return {
        "words": words,
        "fallback": fallback,
        "wd": section(nk_wd, tot_wd, 1),
        "wf": section(nk_wf, tot_wf, 2),
        "wp": section(nk_wp, tot_wp, 2),
        "pp": section(nk_pp, tot_pp, 3),
        "fc": section(nk_fc, tot_fc, 2),
    }
