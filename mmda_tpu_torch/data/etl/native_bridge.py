"""ctypes bridge to the repository's C++ host library (native/mmda_native.cc).

The port's own copy of `mmda_tpu/data/etl/native_bridge.py`.  The library
is built at first use with `make -C native`, into a directory of its own
under `build/native/` named by a digest of the host CPU (model and flags:
the Makefile compiles with `-march=native`) and of the source, so a library
built on another host or from an older source is never loaded.  One build
runs at a time across processes (a lock file under `build/`).

`load()` returns None only on a host without `make` or a C++ compiler; its
callers (`tokenizer.py`, `vocab.py`, `segments.py`) then take their
pure-Python paths, as they do behind their `use_native=False` switches.  A
build that fails, or a library that does not load, raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_NAME = "libmmda_native.so"

_lib_cache: Optional[ctypes.CDLL] = None


def _cpu_id() -> str:
    """The host's CPU model and feature flags (the first core's lines)."""
    lines = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    lines.setdefault(key, line.strip())
    except OSError:
        pass
    return platform.machine() + "\n" + "\n".join(sorted(lines.values()))


def lib_path() -> str:
    """Where this host's build of the current source lives."""
    h = hashlib.sha256(_cpu_id().encode())
    for name in ("mmda_native.cc", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, h.hexdigest()[:16], _LIB_NAME)


def can_build() -> bool:
    return (shutil.which("make") is not None
            and shutil.which(os.environ.get("CXX", "g++")) is not None)


def build(path: str) -> None:
    """`make -C native` with its target at `path`, written under a temporary
    name and renamed, so another process sees the whole library or none."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        out = subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or not os.path.exists(tmp):
            raise RuntimeError(f"make -C native failed ({out.returncode}):\n"
                               f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        os.replace(tmp, path)


def load() -> Optional[ctypes.CDLL]:
    """This host's library, built at first use; None where it cannot be
    built (no make or no C++ compiler)."""
    global _lib_cache
    if _lib_cache is not None:
        return _lib_cache
    path = lib_path()
    if not os.path.exists(path):
        if not can_build():
            return None
        build(path)
    lib = ctypes.CDLL(path)

    lib.glove_scan.restype = ctypes.c_longlong
    lib.glove_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.pack_tokens.restype = None
    lib.pack_tokens.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pack_floats.restype = None
    lib.pack_floats.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.wordpiece_new.restype = ctypes.c_void_p
    lib.wordpiece_new.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
    ]
    lib.wordpiece_free.restype = None
    lib.wordpiece_free.argtypes = [ctypes.c_void_p]
    lib.wordpiece_encode_batch.restype = ctypes.c_longlong
    lib.wordpiece_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib_cache = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def glove_scan(lib: ctypes.CDLL, word2id: Dict[str, int], path: str,
               emb: np.ndarray) -> int:
    """emb: (rows, dim) float64 C-contiguous, mutated in place."""
    assert emb.dtype == np.float64 and emb.flags.c_contiguous
    words = "\n".join(word2id.keys()).encode("utf-8")
    ids = np.fromiter(word2id.values(), dtype=np.int64, count=len(word2id))
    found = lib.glove_scan(
        path.encode(), words, _ptr(ids, ctypes.c_longlong), len(word2id),
        _ptr(emb, ctypes.c_double), emb.shape[0], emb.shape[1])
    if found < 0:
        raise IOError(f"glove_scan failed to open {path}")
    return int(found)


def pack_tokens(lib: ctypes.CDLL, streams, max_len: int, pad_id: int):
    offsets = np.zeros(len(streams) + 1, np.int64)
    for i, s in enumerate(streams):
        offsets[i + 1] = offsets[i] + len(s)
    flat = (np.concatenate([np.asarray(s, np.int32) for s in streams])
            if len(streams) and offsets[-1] else np.zeros(0, np.int32))
    out = np.empty((len(streams), max_len), np.int32)
    lengths = np.empty(len(streams), np.int32)
    lib.pack_tokens(
        _ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_longlong),
        len(streams), max_len, pad_id,
        _ptr(out, ctypes.c_int32), _ptr(lengths, ctypes.c_int32))
    return out, lengths


def pack_floats(lib: ctypes.CDLL, feats_list, max_len: int, znorm: bool):
    n = len(feats_list)
    dim = feats_list[0].shape[1] if n else 0
    offsets = np.zeros(n + 1, np.int64)
    for i, f in enumerate(feats_list):
        offsets[i + 1] = offsets[i] + len(f)
    flat = (np.concatenate([np.ascontiguousarray(f, np.float32) for f in feats_list])
            if n and offsets[-1] else np.zeros((0, dim), np.float32))
    out = np.empty((n, max_len, dim), np.float32)
    lib.pack_floats(
        _ptr(flat, ctypes.c_float), _ptr(offsets, ctypes.c_longlong),
        n, max_len, dim, int(znorm), _ptr(out, ctypes.c_float))
    return out


class WordPieceHandle:
    """Owns a C++ vocab map (native/mmda_native.cc::wordpiece_new)."""

    def __init__(self, lib: ctypes.CDLL, vocab: Dict[str, int]):
        self._lib = lib
        entries = list(vocab.items())
        blob = b"".join(w.encode("utf-8") for w, _ in entries)
        offsets = np.zeros(len(entries) + 1, np.int64)
        for i, (w, _) in enumerate(entries):
            offsets[i + 1] = offsets[i] + len(w.encode("utf-8"))
        ids = np.asarray([i for _, i in entries], np.int32)
        self._handle = lib.wordpiece_new(
            blob, _ptr(offsets, ctypes.c_longlong),
            _ptr(ids, ctypes.c_int32), len(entries))

    def encode_batch(self, texts, max_length: int, lowercase: bool,
                     unk: int, cls: int, sep: int, pad: int):
        """Returns (ids (n, L) int32, mask (n, L) int32, fallback (n,) bool).
        Rows flagged in `fallback` contain non-ASCII text and were NOT
        encoded - the caller must run the Python path for them."""
        raw = [t.encode("utf-8") for t in texts]
        blob = b"".join(raw)
        offsets = np.zeros(len(raw) + 1, np.int64)
        for i, b in enumerate(raw):
            offsets[i + 1] = offsets[i] + len(b)
        out_ids = np.empty((len(raw), max_length), np.int32)
        out_mask = np.empty((len(raw), max_length), np.int32)
        fallback = np.zeros(len(raw), np.uint8)
        self._lib.wordpiece_encode_batch(
            self._handle, blob, _ptr(offsets, ctypes.c_longlong),
            len(raw), max_length, int(lowercase),
            unk, cls, sep, pad,
            _ptr(out_ids, ctypes.c_int32), _ptr(out_mask, ctypes.c_int32),
            _ptr(fallback, ctypes.c_uint8))
        return out_ids, out_mask, fallback.astype(bool)

    def __del__(self):
        try:
            self._lib.wordpiece_free(self._handle)
        except Exception:
            pass
