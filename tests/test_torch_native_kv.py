"""The port's native C++ WAL KV backend (`dragonboat_tpu_torch.storage.
native_kv`, a copy of the reference's over the same native/walkv.cc): the
reference's native KV tests on the port, and the on-disk format across the
two packages in both directions (each package's store opens a directory
the other's wrote).
"""
import os

import pytest

from dragonboat_tpu_torch.storage.kv import WalKV, WriteBatch
from dragonboat_tpu_torch.storage import native_kv
from dragonboat_tpu_torch.storage.native_kv import NativeWalKV, native_available

@pytest.fixture(scope="module", autouse=True)
def _native_lib():
    """libwalkv.so, built before the module's first test under the port's
    build lock (dragonboat_tpu_torch.native), never while the module is
    collected; skips where it cannot be built or loaded."""
    from dragonboat_tpu_torch import native

    with native._locked():
        ok = native_available()
    if not ok:
        pytest.skip("native toolchain unavailable")


def test_put_get_delete(tmp_path):
    kv = NativeWalKV(str(tmp_path / "kv"))
    kv.put_value(b"a", b"1")
    kv.put_value(b"b", b"2")
    assert kv.get_value(b"a") == b"1"
    assert kv.get_value(b"missing") is None
    kv.delete_value(b"a")
    assert kv.get_value(b"a") is None
    assert kv.count() == 1
    kv.close()


def test_batch_atomic_and_empty_values(tmp_path):
    kv = NativeWalKV(str(tmp_path / "kv"))
    wb = WriteBatch()
    wb.put(b"k1", b"")
    wb.put(b"k2", b"v" * 4096)
    wb.delete(b"k1")
    kv.commit_write_batch(wb)
    assert kv.get_value(b"k1") is None
    assert kv.get_value(b"k2") == b"v" * 4096
    kv.close()


def test_iterate_bounds(tmp_path):
    kv = NativeWalKV(str(tmp_path / "kv"))
    for i in range(10):
        kv.put_value(bytes([i]), str(i).encode())
    seen = []
    kv.iterate_value(bytes([2]), bytes([5]), False, lambda k, v: (seen.append(k), True)[1])
    assert seen == [bytes([2]), bytes([3]), bytes([4])]
    seen = []
    kv.iterate_value(bytes([2]), bytes([5]), True, lambda k, v: (seen.append(k), True)[1])
    assert seen == [bytes([2]), bytes([3]), bytes([4]), bytes([5])]
    # early stop
    seen = []
    kv.iterate_value(bytes([0]), bytes([9]), True, lambda k, v: (seen.append(k), len(seen) < 2)[1])
    assert len(seen) == 2
    kv.close()


def test_range_delete(tmp_path):
    kv = NativeWalKV(str(tmp_path / "kv"))
    for i in range(10):
        kv.put_value(bytes([i]), b"x")
    kv.bulk_remove_entries(bytes([3]), bytes([7]))
    left = []
    kv.iterate_value(bytes([0]), bytes([9]), True, lambda k, v: (left.append(k[0]), True)[1])
    assert left == [0, 1, 2, 7, 8, 9]
    kv.close()


def test_reopen_recovers(tmp_path):
    d = str(tmp_path / "kv")
    kv = NativeWalKV(d)
    for i in range(100):
        kv.put_value(f"key-{i:04d}".encode(), f"val-{i}".encode())
    kv.bulk_remove_entries(b"key-0000", b"key-0050")
    kv.close()

    kv2 = NativeWalKV(d)
    assert kv2.get_value(b"key-0049") is None
    assert kv2.get_value(b"key-0050") == b"val-50"
    assert kv2.count() == 50
    kv2.close()


def test_compaction_preserves_state(tmp_path):
    d = str(tmp_path / "kv")
    kv = NativeWalKV(d)
    for i in range(50):
        kv.put_value(f"k{i:03d}".encode(), b"v" * 100)
    kv.full_compaction()
    # WAL truncated, table.log holds the image
    assert os.path.getsize(os.path.join(d, "wal.log")) == 0
    assert os.path.getsize(os.path.join(d, "table.log")) > 0
    kv.put_value(b"after", b"compact")
    kv.close()

    kv2 = NativeWalKV(d)
    assert kv2.count() == 51
    assert kv2.get_value(b"k049") == b"v" * 100
    assert kv2.get_value(b"after") == b"compact"
    kv2.close()


def test_torn_tail_discarded(tmp_path):
    d = str(tmp_path / "kv")
    kv = NativeWalKV(d)
    kv.put_value(b"good", b"1")
    kv.put_value(b"alsogood", b"2")
    kv.close()
    # corrupt the tail: chop bytes off the last record
    path = os.path.join(d, "wal.log")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    kv2 = NativeWalKV(d)
    assert kv2.get_value(b"good") == b"1"
    assert kv2.get_value(b"alsogood") is None
    kv2.close()


def test_interop_python_reads_native(tmp_path):
    d = str(tmp_path / "kv")
    kv = NativeWalKV(d)
    for i in range(20):
        kv.put_value(f"n{i}".encode(), f"v{i}".encode())
    kv.delete_value(b"n3")
    kv.close()

    py = WalKV(d)
    assert py.get_value(b"n4") == b"v4"
    assert py.get_value(b"n3") is None
    py.close()


def test_interop_native_reads_python(tmp_path):
    d = str(tmp_path / "kv")
    py = WalKV(d)
    for i in range(20):
        py.put_value(f"p{i}".encode(), f"v{i}".encode())
    py.full_compaction()
    py.put_value(b"tail", b"wal")
    py.close()

    kv = NativeWalKV(d)
    assert kv.get_value(b"p7") == b"v7"
    assert kv.get_value(b"tail") == b"wal"
    kv.close()


def test_logdb_over_native_kv(tmp_path):
    """ShardedLogDB accepts the native store through its kv_factory seam."""
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.types import Entry, EntryType, State, Update

    db = ShardedLogDB(
        dirname=str(tmp_path / "db"),
        kv_factory=lambda d: NativeWalKV(d),
    )
    ud = Update(
        cluster_id=7,
        node_id=1,
        state=State(term=3, vote=2, commit=1),
        entries_to_save=[
            Entry(type=EntryType.APPLICATION, index=1, term=3, cmd=b"x"),
            Entry(type=EntryType.APPLICATION, index=2, term=3, cmd=b"y"),
        ],
    )
    db.save_raft_state([ud])
    ents, _ = db.iterate_entries(7, 1, 1, 3, 1 << 30)
    assert [e.index for e in ents] == [1, 2]
    st = db.read_raft_state(7, 1, 0)
    assert st.state.term == 3
    db.close()


def test_logdb_reopen_native(tmp_path):
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.types import Entry, EntryType, State, Update

    d = str(tmp_path / "db")
    db = ShardedLogDB(dirname=d, kv_factory=lambda p: NativeWalKV(p))
    ud = Update(
        cluster_id=1,
        node_id=1,
        state=State(term=2, vote=1, commit=5),
        entries_to_save=[
            Entry(type=EntryType.APPLICATION, index=i, term=2, cmd=b"z")
            for i in range(1, 6)
        ],
    )
    db.save_raft_state([ud])
    db.close()

    db2 = ShardedLogDB(dirname=d, kv_factory=lambda p: NativeWalKV(p))
    ents, _ = db2.iterate_entries(1, 1, 1, 6, 1 << 30)
    assert len(ents) == 5
    db2.close()


def test_segmented_compaction_roll_and_replay(tmp_path):
    """Segmented compaction: sealing the WAL is an O(1) rename;
    state survives restart across table.log + segments + live WAL."""
    d = str(tmp_path / "seg")
    kv = NativeWalKV(d)
    for i in range(20):
        kv.put_value(b"k%03d" % i, b"v%d" % i)
    assert kv.segment_count() == 0
    kv.roll_segment()
    assert kv.segment_count() == 1
    for i in range(20, 40):
        kv.put_value(b"k%03d" % i, b"v%d" % i)
    kv.delete_value(b"k001")
    kv.roll_segment()
    assert kv.segment_count() == 2
    kv.put_value(b"tail", b"t")
    kv.close()
    # restart: replay table + segments + wal in order
    kv2 = NativeWalKV(d)
    assert kv2.get_value(b"k000") == b"v0"
    assert kv2.get_value(b"k001") is None
    assert kv2.get_value(b"k039") == b"v39"
    assert kv2.get_value(b"tail") == b"t"
    assert kv2.segment_count() == 2
    kv2.close()


def test_segment_tier_merge_bounds_segment_count(tmp_path):
    """Crossing the segment bound merges the oldest tier; live data
    survives, deletions from newer segments still apply on replay."""
    d = str(tmp_path / "tier")
    kv = NativeWalKV(d)
    for round_ in range(12):
        for i in range(8):
            kv.put_value(b"r%02d-%d" % (round_, i), b"x" * 32)
        if round_ == 5:
            kv.delete_value(b"r00-0")
        kv.roll_segment()
    # force the tier merge through the maybe-compact path: one pending op
    # crosses threshold=1, rolls the WAL, and segment_count > 8 merges the
    # oldest half into ONE compacted segment
    kv.put_value(b"final", b"y")
    before = kv.segment_count()
    kv.maybe_compact(threshold=1)
    assert kv.segment_count() < before
    kv.close()
    kv2 = NativeWalKV(d)
    assert kv2.get_value(b"r00-0") is None
    assert kv2.get_value(b"r00-1") == b"x" * 32
    assert kv2.get_value(b"r11-7") == b"x" * 32
    assert kv2.get_value(b"final") == b"y"
    kv2.close()


def test_full_compaction_clears_segments(tmp_path):
    d = str(tmp_path / "full")
    kv = NativeWalKV(d)
    for i in range(30):
        kv.put_value(b"f%03d" % i, b"v")
        if i % 10 == 9:
            kv.roll_segment()
    assert kv.segment_count() == 3
    kv.full_compaction()
    assert kv.segment_count() == 0
    kv.close()
    kv2 = NativeWalKV(d)
    assert kv2.count() == 30
    assert kv2.get_value(b"f029") == b"v"
    kv2.close()


# ------------------------------------------------- across the two packages


def _write_then_read(d, writer_cls, reader_cls):
    w = writer_cls(d)
    for i in range(40):
        w.put_value(f"x{i:02d}".encode(), f"v{i}".encode() * (i % 5))
    w.delete_value(b"x07")
    w.bulk_remove_entries(b"x20", b"x25")
    w.full_compaction()
    w.put_value(b"tail", b"after-compaction")
    w.delete_value(b"x30")
    w.close()
    r = reader_cls(d)
    seen = []
    r.iterate_value(b"a", b"zzzz", True, lambda k, v: (seen.append((k, v)), True)[1])
    r.close()
    return seen


def _expected():
    out = [(f"x{i:02d}".encode(), f"v{i}".encode() * (i % 5))
           for i in range(40) if i != 7 and not 20 <= i < 25 and i != 30]
    return sorted(out + [(b"tail", b"after-compaction")])


def test_port_native_reads_reference_walkv(tmp_path):
    from dragonboat_tpu.storage.kv import WalKV as RefWalKV

    assert _write_then_read(str(tmp_path / "kv"), RefWalKV, NativeWalKV) == _expected()


def test_reference_walkv_reads_port_native(tmp_path):
    from dragonboat_tpu.storage.kv import WalKV as RefWalKV

    assert _write_then_read(str(tmp_path / "kv"), NativeWalKV, RefWalKV) == _expected()


def test_reference_native_reads_port_native(tmp_path):
    """Both packages load one library built from one source: a directory
    the port's store wrote opens in the reference's, segments included."""
    from dragonboat_tpu.storage import native_kv as ref_native

    d = str(tmp_path / "kv")
    kv = NativeWalKV(d)
    for i in range(12):
        kv.put_value(b"s%02d" % i, b"v")
        if i % 4 == 3:
            kv.roll_segment()
    kv.close()
    assert ref_native._ensure_built() == native_kv._ensure_built()
    ref = ref_native.NativeWalKV(d)
    assert ref.count() == 12 and ref.segment_count() == 3
    assert ref.get_value(b"s11") == b"v"
    ref.close()
