"""Load C++ state machine plugins through the SM SDK's C ABI.

Counterpart of the reference's Go->C++ SM wrapper
(internal/cpp/wrapper.go:268-424 RegularStateMachineWrapper,
wrapper.go:426-610 Concurrent/OnDisk wrappers, and the plugin loader
NewStateMachineWrapperFromPlugin wrapper.go:226): a shared library built
against native/sm_sdk/dragonboat_tpu/statemachine.h exports one SM type;
the wrappers below implement the matching Python state-machine contract
(IStateMachine / IConcurrentStateMachine / IOnDiskStateMachine) by calling
through ctypes, streaming snapshots across the ABI with callback-backed
writer/reader bridges (no full-image buffering on the boundary).

The plugin kind is discovered from its exported dbtpu_sm_type() symbol
(values match statemachine.py SM_TYPE_*); plugins predating the symbol are
treated as regular SMs.

Usage:
    factory = CppStateMachineFactory("/path/to/libmysm.so")
    nh.start_cluster(members, False, factory, cfg)
"""
from __future__ import annotations

import ctypes
from typing import BinaryIO, List

from .statemachine import (
    SM_TYPE_CONCURRENT,
    SM_TYPE_ONDISK,
    SM_TYPE_REGULAR,
    IConcurrentStateMachine,
    IOnDiskStateMachine,
    IStateMachine,
    Result,
    SMEntry,
)

_WRITE_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_size_t,
)
_READ_FN = ctypes.CFUNCTYPE(
    ctypes.c_long, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_size_t,
)


def _bind_common(lib: ctypes.CDLL) -> None:
    lib.dbtpu_sm_create.restype = ctypes.c_void_p
    lib.dbtpu_sm_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.dbtpu_sm_destroy.argtypes = [ctypes.c_void_p]
    lib.dbtpu_sm_lookup.restype = ctypes.c_int
    lib.dbtpu_sm_lookup.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.dbtpu_sm_get_hash.restype = ctypes.c_uint64
    lib.dbtpu_sm_get_hash.argtypes = [ctypes.c_void_p]
    lib.dbtpu_sm_recover_snapshot.restype = ctypes.c_int
    lib.dbtpu_sm_recover_snapshot.argtypes = [
        ctypes.c_void_p, _READ_FN, ctypes.c_void_p,
    ]
    lib.dbtpu_sm_free.argtypes = [ctypes.c_void_p]


def _bind_regular(lib: ctypes.CDLL) -> None:
    lib.dbtpu_sm_update.restype = ctypes.c_uint64
    lib.dbtpu_sm_update.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.dbtpu_sm_save_snapshot.restype = ctypes.c_int
    lib.dbtpu_sm_save_snapshot.argtypes = [
        ctypes.c_void_p, _WRITE_FN, ctypes.c_void_p,
    ]


def _bind_batched(lib: ctypes.CDLL) -> None:
    lib.dbtpu_sm_batched_update.restype = ctypes.c_int
    lib.dbtpu_sm_batched_update.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
    ]
    lib.dbtpu_sm_prepare_snapshot.restype = ctypes.c_int
    lib.dbtpu_sm_prepare_snapshot.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.dbtpu_sm_save_snapshot_ctx.restype = ctypes.c_int
    lib.dbtpu_sm_save_snapshot_ctx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, _WRITE_FN, ctypes.c_void_p,
    ]


def _bind_ondisk(lib: ctypes.CDLL) -> None:
    lib.dbtpu_sm_open.restype = ctypes.c_int
    lib.dbtpu_sm_open.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dbtpu_sm_sync.restype = ctypes.c_int
    lib.dbtpu_sm_sync.argtypes = [ctypes.c_void_p]


class _CppSMBase:
    """Shared ctypes plumbing over one plugin-exported SM instance."""

    def __init__(self, lib: ctypes.CDLL, cluster_id: int, node_id: int):
        self._lib = lib
        self._h = lib.dbtpu_sm_create(cluster_id, node_id)
        if not self._h:
            raise RuntimeError("dbtpu_sm_create returned NULL")

    def lookup(self, query) -> object:
        q = query if isinstance(query, bytes) else str(query).encode()
        out = ctypes.c_void_p()
        outlen = ctypes.c_size_t()
        rc = self._lib.dbtpu_sm_lookup(
            self._h, q, len(q), ctypes.byref(out), ctypes.byref(outlen)
        )
        if rc != 0:
            return None
        try:
            return ctypes.string_at(out, outlen.value)
        finally:
            self._lib.dbtpu_sm_free(out)

    def get_hash(self) -> int:
        return int(self._lib.dbtpu_sm_get_hash(self._h))

    def _recover(self, r: BinaryIO) -> None:
        error: list = []

        @_READ_FN
        def read_cb(ctx, buf, cap):
            try:
                chunk = r.read(cap)
                if not chunk:
                    return 0
                ctypes.memmove(buf, chunk, len(chunk))
                return len(chunk)
            except Exception as e:
                error.append(e)
                return -1

        rc = self._lib.dbtpu_sm_recover_snapshot(self._h, read_cb, None)
        if error:
            raise error[0]
        if rc != 0:
            raise RuntimeError("C++ RecoverFromSnapshot failed")

    def _save(self, fn, w, done, *pre_args) -> None:
        """Run a snapshot-save ABI fn(handle, *pre_args, write_cb, NULL)."""
        error: list = []

        @_WRITE_FN
        def write_cb(ctx, data, n):
            try:
                done.check() if hasattr(done, "check") else None
                w.write(ctypes.string_at(data, n))
                return 0
            except Exception as e:  # surfaces as rc!=0 on the C++ side
                error.append(e)
                return -1

        rc = fn(self._h, *pre_args, write_cb, None)
        if error:
            raise error[0]
        if rc != 0:
            raise RuntimeError("C++ SaveSnapshot failed")

    def _batched_update(self, entries: List[SMEntry]) -> List[SMEntry]:
        n = len(entries)
        if n == 0:
            return entries
        idxs = (ctypes.c_uint64 * n)(*[e.index for e in entries])
        cmds = (ctypes.c_char_p * n)(*[e.cmd for e in entries])
        lens = (ctypes.c_size_t * n)(*[len(e.cmd) for e in entries])
        results = (ctypes.c_uint64 * n)()
        rc = self._lib.dbtpu_sm_batched_update(
            self._h, idxs,
            ctypes.cast(cmds, ctypes.POINTER(ctypes.c_char_p)),
            lens, results, n,
        )
        if rc != 0:
            raise RuntimeError("C++ BatchedUpdate failed")
        for e, v in zip(entries, results):
            e.result = Result(value=int(v))
        return entries

    def _prepare_snapshot(self) -> object:
        ctx = ctypes.c_void_p()
        rc = self._lib.dbtpu_sm_prepare_snapshot(self._h, ctypes.byref(ctx))
        if rc != 0:
            raise RuntimeError("C++ PrepareSnapshot failed")
        return ctx

    def close(self) -> None:
        if self._h:
            self._lib.dbtpu_sm_destroy(self._h)
            self._h = None


class CppStateMachine(_CppSMBase, IStateMachine):
    """IStateMachine over a regular plugin SM."""

    def update(self, data: bytes) -> Result:
        v = self._lib.dbtpu_sm_update(self._h, data, len(data))
        return Result(value=int(v))

    def save_snapshot(self, w: BinaryIO, files, done) -> None:
        self._save(self._lib.dbtpu_sm_save_snapshot, w, done)

    def recover_from_snapshot(self, r: BinaryIO, files, done) -> None:
        self._recover(r)


class CppConcurrentStateMachine(_CppSMBase, IConcurrentStateMachine):
    """IConcurrentStateMachine over a concurrent plugin SM."""

    def update(self, entries: List[SMEntry]) -> List[SMEntry]:
        return self._batched_update(entries)

    def prepare_snapshot(self) -> object:
        return self._prepare_snapshot()

    def save_snapshot(self, ctx, w: BinaryIO, files, done) -> None:
        self._save(self._lib.dbtpu_sm_save_snapshot_ctx, w, done, ctx)

    def recover_from_snapshot(self, r: BinaryIO, files, done) -> None:
        self._recover(r)


class CppOnDiskStateMachine(_CppSMBase, IOnDiskStateMachine):
    """IOnDiskStateMachine over an on-disk plugin SM."""

    def open(self, stopc) -> int:
        idx = ctypes.c_uint64()
        rc = self._lib.dbtpu_sm_open(self._h, ctypes.byref(idx))
        if rc != 0:
            raise RuntimeError("C++ Open failed")
        return int(idx.value)

    def update(self, entries: List[SMEntry]) -> List[SMEntry]:
        return self._batched_update(entries)

    def sync(self) -> None:
        if self._lib.dbtpu_sm_sync(self._h) != 0:
            raise RuntimeError("C++ Sync failed")

    def prepare_snapshot(self) -> object:
        return self._prepare_snapshot()

    def save_snapshot(self, ctx, w: BinaryIO, done) -> None:
        self._save(self._lib.dbtpu_sm_save_snapshot_ctx, w, done, ctx)

    def recover_from_snapshot(self, r: BinaryIO, done) -> None:
        self._recover(r)


class CppStateMachineFactory:
    """SM factory over a plugin .so; pass directly to start_cluster
    (cf. wrapper.go:226 NewStateMachineWrapperFromPlugin). The plugin's
    exported dbtpu_sm_type() selects which Python contract the created
    instances implement, so the runtime's managed-SM dispatch
    (statemachine.py sm_type_of) picks the right apply discipline."""

    def __init__(self, plugin_path: str) -> None:
        self._lib = ctypes.CDLL(plugin_path)
        self.plugin_path = plugin_path
        try:
            type_fn = self._lib.dbtpu_sm_type
        except AttributeError:
            self.sm_type = SM_TYPE_REGULAR  # pre-type plugin
        else:
            type_fn.restype = ctypes.c_int
            type_fn.argtypes = []
            self.sm_type = int(type_fn())
        _bind_common(self._lib)
        if self.sm_type == SM_TYPE_CONCURRENT:
            _bind_batched(self._lib)
            self._cls = CppConcurrentStateMachine
        elif self.sm_type == SM_TYPE_ONDISK:
            _bind_batched(self._lib)
            _bind_ondisk(self._lib)
            self._cls = CppOnDiskStateMachine
        else:
            _bind_regular(self._lib)
            self._cls = CppStateMachine

    def __call__(self, cluster_id: int, node_id: int):
        return self._cls(self._lib, cluster_id, node_id)


__all__ = [
    "CppStateMachine",
    "CppConcurrentStateMachine",
    "CppOnDiskStateMachine",
    "CppStateMachineFactory",
]
