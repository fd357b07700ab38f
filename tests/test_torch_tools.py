"""Twin of test_tools.py for the port's operator tools: import_snapshot
quorum repair, checkdisk, the export path, raft-top (checked-in fixture
through the CLI, equal to the reference's output; live collection from
the port's NodeHosts) and the logdb consistency checker. The live hosts
run the port's vector engine on `device="cpu"` with 50 ms ticks (the
plain CPU step costs milliseconds)."""
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import pytest

from dragonboat_tpu.tools import top as REF_TOP
from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.tools import (
    ErrIncompleteSnapshot,
    ErrInvalidMembers,
    ErrPathNotExist,
    check_disk,
    import_snapshot,
)
from dragonboat_tpu_torch.tools import top
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER = 1
RTT_MS = 50


class KV(IStateMachine):
    def __init__(self):
        self.d = {}

    def update(self, data):
        k, v = data.decode().split("=", 1)
        self.d[k] = v
        return Result(value=1)

    def lookup(self, q):
        return self.d.get(q)

    def save_snapshot(self, w, files, done):
        w.write(json.dumps(self.d).encode())

    def recover_from_snapshot(self, r, files, done):
        self.d = json.loads(r.read().decode())


def _nh_config(nid, tmp, reg, share_scope=None, groups=4):
    return NodeHostConfig(
        deployment_id=11, rtt_millisecond=RTT_MS,
        nodehost_dir=f"{tmp}/h{nid}", raft_address=f"t{nid}:1",
        raft_rpc_factory=lambda l, reg=reg: loopback_factory(l, reg),
        engine=EngineConfig(kind="vector", max_groups=groups, max_peers=4, log_window=64,
                            share_scope=share_scope, device="cpu"),
    )


def _cfg(nid, cid=CLUSTER, **kw):
    return Config(cluster_id=cid, node_id=nid, election_rtt=20, heartbeat_rtt=4, **kw)


def _wait_leader(hosts, deadline_s=60):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        for nid, nh in hosts.items():
            lid, ok = nh.get_leader_id(CLUSTER)
            if ok and lid == nid:
                return nid
        time.sleep(0.02)
    raise AssertionError("no leader")


def test_tools_package_exports_the_reference_surface():
    import dragonboat_tpu.tools as ref
    import dragonboat_tpu_torch.tools as port

    assert port.__all__ == ref.__all__


def test_check_disk(tmp_path):
    out = check_disk(str(tmp_path), count=20, payload_size=512)
    assert out["count"] == 20
    assert out["fsync_p50_us"] > 0
    assert out["synced_writes_per_sec"] > 0
    assert os.listdir(str(tmp_path)) == []


def test_import_snapshot_quorum_repair(tmp_path):
    """A 3-node group loses 2 nodes for good; the exported snapshot is
    imported on the survivor with a one-member membership; the survivor
    restarts alone with all the data and makes progress."""
    reg = _Registry()
    members = {n: f"t{n}:1" for n in (1, 2, 3)}
    hosts = {}
    for nid in (1, 2, 3):
        hosts[nid] = NodeHost(_nh_config(nid, str(tmp_path), reg))
        hosts[nid].start_cluster(members, False, lambda c, n: KV(), _cfg(nid))
    leader = _wait_leader(hosts)
    s = hosts[leader].get_noop_session(CLUSTER)
    for i in range(10):
        hosts[leader].sync_propose(s, f"k{i}=v{i}".encode(), timeout_s=45.0)
    export_root = str(tmp_path / "export")
    os.makedirs(export_root)
    hosts[leader].sync_request_snapshot(CLUSTER, export_path=export_root, timeout_s=30.0)
    exported = [os.path.join(export_root, d) for d in os.listdir(export_root)]
    assert len(exported) == 1, exported
    src = exported[0]
    assert os.path.exists(os.path.join(src, "snapshot.metadata"))
    for nh in hosts.values():
        nh.stop()

    ss = import_snapshot(_nh_config(1, str(tmp_path), reg), src, {1: "t1:1"}, 1)
    assert ss.imported and ss.membership.addresses == {1: "t1:1"}
    assert ss.membership.removed.keys() >= {2, 3}

    nh1 = NodeHost(_nh_config(1, str(tmp_path), reg))
    try:
        nh1.start_cluster({}, False, lambda c, n: KV(), _cfg(1))
        assert _wait_leader({1: nh1}) == 1
        assert nh1.sync_read(CLUSTER, "k9", timeout_s=30.0) == "v9"
        assert set(nh1.get_cluster_membership(CLUSTER).addresses) == {1}
        nh1.sync_propose(nh1.get_noop_session(CLUSTER), b"post=repair", timeout_s=30.0)
        assert nh1.sync_read(CLUSTER, "post", timeout_s=30.0) == "repair"
    finally:
        nh1.stop()


def test_import_snapshot_validation(tmp_path):
    cfg = NodeHostConfig(deployment_id=1, rtt_millisecond=5,
                         nodehost_dir=str(tmp_path / "nh"), raft_address="v1:1")
    with pytest.raises(ErrInvalidMembers):
        import_snapshot(cfg, str(tmp_path), {2: "v2:1"}, 1)
    with pytest.raises(ErrPathNotExist):
        import_snapshot(cfg, str(tmp_path / "nope"), {1: "v1:1"}, 1)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ErrIncompleteSnapshot):
        import_snapshot(cfg, str(empty), {1: "v1:1"}, 1)


def test_export_does_not_compact_own_history(tmp_path):
    """An exported snapshot leaves the node's own log and snapshot records
    alone: with compaction_overhead set, a restart after the export still
    replays."""
    reg = _Registry()
    nh = NodeHost(_nh_config(1, str(tmp_path), reg))
    nh.start_cluster({1: "t1:1"}, False, lambda c, n: KV(), _cfg(1, compaction_overhead=3))
    _wait_leader({1: nh})
    s = nh.get_noop_session(CLUSTER)
    for i in range(20):
        nh.sync_propose(s, f"e{i}=x{i}".encode(), timeout_s=20.0)
    exp = tmp_path / "exp"
    exp.mkdir()
    nh.sync_request_snapshot(CLUSTER, export_path=str(exp), timeout_s=30.0)
    nh.stop()

    nh2 = NodeHost(_nh_config(1, str(tmp_path), reg))
    try:
        nh2.start_cluster({}, False, lambda c, n: KV(), _cfg(1, compaction_overhead=3))
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if nh2.stale_read(CLUSTER, "e19") == "x19":
                    break
            except Exception:
                pass
            time.sleep(0.02)
        else:
            raise AssertionError("node failed to recover after export")
    finally:
        nh2.stop()


def test_request_snapshot_bad_export_path(tmp_path):
    from dragonboat_tpu_torch.nodehost import ErrDirNotExist

    nh = NodeHost(_nh_config(1, str(tmp_path), _Registry()))
    nh.start_cluster({1: "t1:1"}, False, lambda c, n: KV(), _cfg(1))
    try:
        with pytest.raises(ErrDirNotExist):
            nh.request_snapshot(CLUSTER, export_path=str(tmp_path / "missing"))
    finally:
        nh.stop()


def _main(mod, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(args))
    return rc, out.getvalue(), err.getvalue()


def test_raft_top_renders_checked_in_snapshot_via_cli():
    """`python -m dragonboat_tpu_torch.tools.top` over the checked-in
    snapshot: the reference's output, byte for byte, in every mode."""
    fixture = os.path.join(_REPO, "tests", "data", "top_snapshot.json")

    def cli(*args):
        port = _main(top, *args)
        assert port == _main(REF_TOP, *args), args
        return port

    p = subprocess.run([sys.executable, "-m", "dragonboat_tpu_torch.tools.top", fixture],
                       cwd=_REPO, capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
    assert (p.returncode, p.stdout) == cli(fixture)[:2]
    out = p.stdout.splitlines()
    assert out[0].startswith("raft-top  lanes=4")
    assert "hbm=52.0MiB" in out[0] and "waste=0.69" in out[0]
    assert "elections 6/5" in out[1] and "backlog 3" in out[1]
    assert out[3].split()[1] == "101"
    assert cli(fixture, "--sort", "ingest")[0] == 0
    assert len(cli(fixture, "--limit", "1")[1].splitlines()) == 4
    rc, out, _ = cli(fixture, "--json")
    snap = json.loads(out)
    assert snap["lanes"][0]["cluster_id"] == 101
    assert snap["lanes"][0]["heat"] > snap["lanes"][-1]["heat"]
    assert snap["census"]["hbm_waste_ratio"] == 0.69
    for sort in ("heat", "gap", "elections", "ingest"):
        cli(fixture, "--sort", sort, "--limit", "0")
    rc, _, err = cli(os.path.join(_REPO, "tests", "data", "perfdiff_base.json"))
    assert rc == 2 and "error" in err


def test_raft_top_collects_and_ranks_from_live_host(tmp_path):
    """collect_snapshot folds a live port host's lane_stats, lane_counters,
    census and pressure into the snapshot schema the CLI renders; the
    census is the engine's tensors; two snapshots give ingest rates."""
    nh = NodeHost(_nh_config(1, str(tmp_path), _Registry()))
    try:
        nh.start_cluster({1: "t1:1"}, False, lambda c, n: KV(), _cfg(1))
        _wait_leader({1: nh})
        sess = nh.get_noop_session(1)
        first = top.collect_snapshot({1: nh})
        for i in range(4):
            nh.sync_propose(sess, f"k{i}=v".encode(), timeout_s=20.0)
        snap = top.collect_snapshot({1: nh})
        assert snap["schema"] == 1
        rows = snap["lanes"]
        assert len(rows) == 1 and rows[0]["cluster_id"] == 1
        assert rows[0]["counters"]["commit_advances"] >= 4
        census = nh.engine.device_census()
        assert snap["census"]["hbm_bytes_total"] == census["hbm_bytes_total"] > 0
        assert snap["counters"]["elections_won"] >= 1
        snap["ts"] = first["ts"] + 2.0
        ranked = top.rank_lanes(snap, prev=first)
        assert ranked[0]["ingest_rate"] > 0
        assert ranked == REF_TOP.rank_lanes(snap, prev=first)
        buf = io.StringIO()
        top.render(snap, prev=first, out=buf)
        ref_buf = io.StringIO()
        REF_TOP.render(snap, prev=first, out=ref_buf)
        assert buf.getvalue() == ref_buf.getvalue()
        assert "raft-top  lanes=1" in buf.getvalue()
    finally:
        nh.stop()


def test_raft_top_shared_core_rows_never_double(tmp_path):
    """Three hosts on one shared core (the engine layout of the BASELINE
    configs): one row per (host, group) lane, none doubled, and the
    core's census and counters folded once."""
    reg = _Registry()
    members = {n: f"t{n}:1" for n in (1, 2, 3)}
    hosts = {nid: NodeHost(_nh_config(nid, str(tmp_path), reg, share_scope="top-shared",
                                      groups=12)) for nid in members}
    try:
        for nid, nh in hosts.items():
            nh.start_clusters([(members, False, lambda c, n: KV(), _cfg(nid, cid))
                               for cid in (1, 2, 3)])
        deadline = time.time() + 60
        while not all(hosts[1].get_leader_id(c)[1] for c in (1, 2, 3)):
            assert time.time() < deadline, "no leaders"
            time.sleep(0.05)
        snap = top.collect_snapshot(hosts)
        keys = [(r["host"], r["cluster_id"]) for r in snap["lanes"]]
        assert sorted(keys) == [(h, c) for h in (1, 2, 3) for c in (1, 2, 3)]
        core = hosts[1].engine.core
        assert all(nh.engine.core is core for nh in hosts.values())
        # each host's counters fold covers exactly its own lanes of the
        # core's, with every counter of the vocabulary
        every = core.lane_counters()
        assert len(every) == 9
        for h in members:
            mine = core.lane_counters(h)
            assert set(mine) == {k for k in every if k[0] == h}
            assert all(set(v) == set(every[k]) for k, v in mine.items())
        assert snap["census"]["hbm_bytes_total"] == hosts[1].engine.device_census()["hbm_bytes_total"]
        assert snap["counters"] == {k: int(v) for k, v in hosts[1].engine.counter_stats().items()}
    finally:
        for nh in hosts.values():
            nh.stop()


def test_logdb_checker_accepts_replicas_and_detects_divergence():
    from dragonboat_tpu_torch.storage.kv import MemKV
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.tools.logdbcheck import check_logdb_consistency
    from dragonboat_tpu_torch.types import Entry, State, Update

    def mk_db(node_id, cmds, commit, divergent_at=None):
        db = ShardedLogDB(kv_factory=lambda shard: MemKV())
        ents = [Entry(index=i, term=2 if divergent_at is not None and i >= divergent_at else 1,
                      cmd=cmd) for i, cmd in enumerate(cmds, start=1)]
        db.save_raft_state([Update(cluster_id=CLUSTER, node_id=node_id,
                                   state=State(term=2, vote=1, commit=commit),
                                   entries_to_save=ents)])
        return db

    cmds = [f"c{i}".encode() for i in range(1, 8)]
    dbs = {nid: mk_db(nid, cmds, commit=7) for nid in (1, 2)}
    report = check_logdb_consistency(dbs, CLUSTER)
    assert report.ok, report.violations
    assert len(report.replicas) == 2
    dbs[3] = mk_db(3, cmds, commit=7, divergent_at=5)
    report = check_logdb_consistency(dbs, CLUSTER)
    assert not report.ok
    assert any("divergence" in v for v in report.violations)
    report = check_logdb_consistency({1: mk_db(1, cmds, commit=99)}, CLUSTER)
    assert any("beyond last persisted" in v for v in report.violations)


def test_chip_smoke_tools_phase_on_cpu():
    """chip_smoke.py's phase 7 (the tools against live NodeHosts, the
    quorum repair, perfdiff, tools.check, helloworld) at 4 groups on the
    CPU: every step of the card's run passes here too."""
    import chip_smoke
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.ops import cuda, kernel

    record = {"host": e2e.host_stamp(), "backend": "torch", "value": 1.0, "groups": 4}
    out = chip_smoke.phase_tools(cuda, kernel, record, device="cpu", groups=4)
    assert out["top"]["rows"] == 12 and out["logdbcheck"]["violations"] == 0
    assert out["importer"]["acked_read_back"] > 0 and out["importer"]["members"] == [1]
    assert out["perfdiff"] == {**out["perfdiff"], "self_rc": 0, "vs_jax_fixture_rc": 2,
                               "unstamped_rc": 2}
    assert ": 0 finding(s)" in out["check"]
    for part in ("hosts", "importer", "helloworld"):
        assert out[part]["plain_step_calls"] > 0 and not any(out[part]["launches"].values())
