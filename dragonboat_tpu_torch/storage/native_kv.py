"""ctypes binding for the native C++ WAL KV store (native/walkv.cc).

The reference ships native storage backends behind its IKVStore seam
(internal/logdb/kv/rocksdb, internal/logdb/kv/leveldb with a vendored C++
tree — kv.go:28-74); this is their equivalent here. The shared library is
built on first use with g++ (no pip/apt needed) and cached next to the
source. The on-disk format is byte-compatible with the pure-Python WalKV,
so either backend can open a directory written by the other.

FFI design: one call per write *batch* (the Python side serializes all ops
into a single blob) and one call per iterated *range* (the C++ side returns
one serialized result blob) — the per-key cost stays in C++.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from typing import Callable, Optional

from .kv import IKVStore, WriteBatch

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libwalkv.so"))

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def _ensure_built(force: bool = False) -> str:
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "walkv.cc"))
    with _build_lock:
        if (
            not force
            and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src)
        ):
            return _LIB_PATH
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        cmd = [
            os.environ.get("CXX", "g++"),
            "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared",
            "-o", _LIB_PATH, src, "-lz",
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed: {' '.join(cmd)}\n{proc.stderr}"
            )
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_ensure_built())
    except OSError:
        # a stale/foreign-arch library on disk: rebuild from source once
        lib = ctypes.CDLL(_ensure_built(force=True))
    lib.walkv_open.restype = ctypes.c_void_p
    lib.walkv_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.walkv_close.argtypes = [ctypes.c_void_p]
    lib.walkv_get.restype = ctypes.c_int
    lib.walkv_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.walkv_free.argtypes = [ctypes.c_void_p]
    lib.walkv_commit_batch.restype = ctypes.c_int
    lib.walkv_commit_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.walkv_iterate.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.walkv_bulk_remove.restype = ctypes.c_int
    lib.walkv_bulk_remove.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.walkv_full_compaction.restype = ctypes.c_int
    lib.walkv_full_compaction.argtypes = [ctypes.c_void_p]
    lib.walkv_maybe_compact.restype = ctypes.c_int
    lib.walkv_maybe_compact.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.walkv_count.restype = ctypes.c_uint64
    lib.walkv_count.argtypes = [ctypes.c_void_p]
    lib.walkv_roll_segment.restype = ctypes.c_int
    lib.walkv_roll_segment.argtypes = [ctypes.c_void_p]
    lib.walkv_segment_count.restype = ctypes.c_uint64
    lib.walkv_segment_count.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (NativeBuildError, OSError):
        return False


_OP_HDR = struct.Struct("<BII")
_KV_HDR = struct.Struct("<II")
_COMPACT_THRESHOLD = 100_000


class NativeWalKV(IKVStore):
    """IKVStore over the C++ store; see module docstring."""

    def __init__(self, dirname: str, fsync: bool = True) -> None:
        lib = _load()
        err = ctypes.create_string_buffer(256)
        os.makedirs(dirname, exist_ok=True)
        self._h = lib.walkv_open(
            dirname.encode(), 1 if fsync else 0, err, len(err)
        )
        if not self._h:
            raise OSError(f"walkv_open failed: {err.value.decode()}")
        self._lib = lib
        self._closed = False

    def name(self) -> str:
        return "native-walkv"

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.walkv_close(self._h)

    def get_value(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        found = self._lib.walkv_get(
            self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen)
        )
        if not found:
            return None
        try:
            return ctypes.string_at(val, vlen.value)
        finally:
            self._lib.walkv_free(val)

    def commit_write_batch(self, wb: WriteBatch) -> None:
        parts = []
        for op, k, v in wb.ops:
            parts.append(_OP_HDR.pack(op, len(k), len(v)))
            parts.append(k)
            parts.append(v)
        blob = b"".join(parts)
        rc = self._lib.walkv_commit_batch(self._h, blob, len(blob))
        if rc != 0:
            raise OSError(f"walkv_commit_batch failed: rc={rc}")

    def iterate_value(
        self,
        fk: bytes,
        lk: bytes,
        inc_last: bool,
        op: Callable[[bytes, bytes], bool],
    ) -> None:
        out = ctypes.c_void_p()
        outlen = ctypes.c_size_t()
        self._lib.walkv_iterate(
            self._h, fk, len(fk), lk, len(lk), 1 if inc_last else 0,
            ctypes.byref(out), ctypes.byref(outlen),
        )
        try:
            data = ctypes.string_at(out, outlen.value)
        finally:
            self._lib.walkv_free(out)
        off = 0
        n = len(data)
        while off + _KV_HDR.size <= n:
            klen, vlen = _KV_HDR.unpack_from(data, off)
            off += _KV_HDR.size
            k = data[off : off + klen]
            v = data[off + klen : off + klen + vlen]
            off += klen + vlen
            if not op(k, v):
                break

    def bulk_remove_entries(self, fk: bytes, lk: bytes) -> None:
        rc = self._lib.walkv_bulk_remove(self._h, fk, len(fk), lk, len(lk))
        if rc != 0:
            raise OSError(f"walkv_bulk_remove failed: rc={rc}")

    def compact_entries(self, fk: bytes, lk: bytes) -> None:
        # range args unused: compaction is store-wide and threshold-gated
        self.maybe_compact()

    def full_compaction(self) -> None:
        rc = self._lib.walkv_full_compaction(self._h)
        if rc != 0:
            raise OSError(f"walkv_full_compaction failed: rc={rc}")

    def count(self) -> int:
        return int(self._lib.walkv_count(self._h))

    def maybe_compact(self, threshold: int = _COMPACT_THRESHOLD) -> None:
        rc = self._lib.walkv_maybe_compact(self._h, threshold)
        if rc != 0:
            raise OSError(f"walkv_maybe_compact failed: rc={rc}")

    def roll_segment(self) -> None:
        """Seal the active WAL as an immutable segment (O(1) rename)."""
        rc = self._lib.walkv_roll_segment(self._h)
        if rc != 0:
            raise OSError(f"walkv_roll_segment failed: rc={rc}")

    def segment_count(self) -> int:
        return int(self._lib.walkv_segment_count(self._h))


__all__ = ["NativeWalKV", "native_available", "NativeBuildError"]
