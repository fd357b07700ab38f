"""Twin of tests/test_storage.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the memory, WAL and SQLite key-value stores, the
log database over each (state, entries, overwrite, compaction, bootstrap,
snapshots, removal, restart), the log reader, and a NodeHost on the vector
engine over SQLite restarting from its directory (slow).

The test below writes a log database with one package and reads it with the
other, over the WAL and the SQLite stores, both ways, and holds the state,
entries, bootstrap record and snapshot read back equal to what was
written."""
import importlib

import pytest

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_storage")
globals().update(reference_tests(R))

PKGS = ("dragonboat_tpu", "dragonboat_tpu_torch")


def open_db(pkg, backend, d):
    if backend == "sqlite":
        f = importlib.import_module(pkg + ".storage.sqlite_kv").sqlite_logdb_factory
        return f(d, num_shards=2)
    return importlib.import_module(pkg + ".storage.logdb").ShardedLogDB(d)


def write(pkg, backend, d):
    T = importlib.import_module(pkg + ".types")
    db = open_db(pkg, backend, d)
    try:
        ents = [T.Entry(index=i, term=1 + i // 4, cmd=b"c%d" % i) for i in range(1, 13)]
        db.save_raft_state([
            T.Update(cluster_id=c, node_id=1, entries_to_save=ents[: 6 + c],
                     state=T.State(term=3, vote=c, commit=4 + c))
            for c in (1, 2)])
        db.save_snapshots([T.Update(cluster_id=2, node_id=1,
                                    snapshot=T.Snapshot(index=2, term=1))])
        db.save_bootstrap_info(1, 1, T.Bootstrap(addresses={1: "a:1", 2: "b:2"}, join=False))
    finally:
        db.close()


def read(pkg, backend, d):
    db = open_db(pkg, backend, d)
    try:
        out = []
        for c in (1, 2):
            rs = db.read_raft_state(c, 1, 0)
            ents, _ = db.iterate_entries(c, 1, 1, 100, 1 << 30)
            out.append(((rs.state.term, rs.state.vote, rs.state.commit), rs.first_index,
                        rs.entry_count, [(e.index, e.term, e.cmd) for e in ents]))
        snaps = [(ss.index, ss.term) for ss in db.list_snapshots(2, 1, 100)]
        b = db.get_bootstrap_info(1, 1)
        return out, snaps, (dict(b.addresses), b.join)
    finally:
        db.close()


@pytest.mark.parametrize("backend", ["wal", "sqlite"])
@pytest.mark.parametrize("writer", PKGS)
def test_logdb_reads_across_packages(tmp_path, backend, writer):
    d = str(tmp_path / "db")
    write(writer, backend, d)
    got = [read(pkg, backend, d) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[1][0][0][0] == (3, 1, 5) and len(got[1][0][1][3]) == 8
    assert got[1][1] == [(2, 1)]
