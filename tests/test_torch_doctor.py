"""Twin of test_doctor.py for the port's `tools.doctor` (and `tools.top
--history`).

* The synthetic rule tests of the reference run unchanged against the
  port (test_torch_static_analysis.run_reference_test): every call of
  `diagnose_data`, `diagnosis_report` and `load_bundle` goes through both
  packages and the port's verdicts must EQUAL the reference's, field for
  field, before the reference's assertions check them.
* The live single-fault scenarios run on the port's NodeHosts (the
  vector engine on `device="cpu"`, 50 ms ticks: the plain CPU step costs
  milliseconds) and must reach the reference's verdicts.
* The checked-in bundle (tests/data/doctor_bundle) through the port's
  CLI: output equal to the reference's, byte for byte.
* Rings and history written by the port's CPU NodeHost read by both
  packages' doctor and timeline: equal output (the formats did not drift).
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import pytest

from dragonboat_tpu.tools import doctor as RD
from dragonboat_tpu.tools import timeline as RT
from dragonboat_tpu.tools import top as RTOP
from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.faults import ClockPlane, FaultPlane, FaultSpec
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.profile import sample_host
from dragonboat_tpu_torch.serving import AdmissionConfig, ErrOverloaded, TenantSpec
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.storage import ShardedLogDB
from dragonboat_tpu_torch.storage.kv import WalKV
from dragonboat_tpu_torch.tools import doctor as PD
from dragonboat_tpu_torch.tools import timeline as PT
from dragonboat_tpu_torch.tools import top as PTOP
from dragonboat_tpu_torch.trace import flight_recorder
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

from test_torch_static_analysis import run_reference_test

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "doctor_bundle")

CLUSTER = 1
RTT_MS = 50
FAULT_KINDS = frozenset({
    "no_quorum_partition", "election_churn", "wal_fsync_stall",
    "clock_anomaly", "admission_shed_storm",
})


# ------------------------------------------- the reference's rule tests
def _verdicts(vs):
    return [v.to_dict() for v in vs]


def dual_diagnose_data(history, flight=(), top=None):
    port = PD.diagnose_data(history, flight=flight, top=top)
    assert _verdicts(port) == _verdicts(RD.diagnose_data(history, flight=flight, top=top))
    return port


def dual_diagnosis_report(history, flight=(), top=None, source=""):
    port = PD.diagnosis_report(history, flight=flight, top=top, source=source)
    assert port == RD.diagnosis_report(history, flight=flight, top=top, source=source)
    return port


def dual_load_bundle(path):
    port = PD.load_bundle(path)
    assert port == RD.load_bundle(path)
    return port


PORT_NAMES = {
    "diagnose_data": dual_diagnose_data,
    "diagnosis_report": dual_diagnosis_report,
    "load_bundle": dual_load_bundle,
    "top_verdict_line": PD.top_verdict_line,
}

RULE_TESTS = (
    "test_rule_healthy_idle_is_the_empty_verdict",
    "test_rule_no_quorum_partition",
    "test_rule_election_churn_needs_wins_not_just_campaigns",
    "test_rule_wal_fsync_stall",
    "test_rule_clock_anomaly_delta_and_single_sample_forms",
    "test_rule_admission_shed_storm",
    "test_rule_lease_fallback_storm_subsumed_by_clock_anomaly",
    "test_rule_migration_wedged_requires_zero_progress",
    "test_rule_lane_leak_needs_monotone_growth",
    "test_rule_snapshot_parked_remote_needs_flight_corroboration",
    "test_verdicts_rank_most_severe_first_and_footer_line",
    "test_diagnosis_report_schema",
    "test_fixture_bundle_loads_both_planes",
)


@pytest.mark.parametrize("name", RULE_TESTS)
def test_reference_rule_test_holds_on_the_port(name, request):
    run_reference_test("test_doctor", name, request, PORT_NAMES)


def test_thresholds_and_hints_equal_the_reference():
    assert PD.SEVERITY == RD.SEVERITY and PD.HINTS == RD.HINTS
    for k in ("WAL_STALL_EWMA_S", "SHED_STORM_MIN", "FALLBACK_STORM_MIN",
              "CHURN_MIN_WINS", "LANE_LEAK_MIN_GROWTH", "PARKED_MIN_SAMPLES"):
        assert getattr(PD, k) == getattr(RD, k), k


# ------------------------------------------------- live fault scenarios
class KV(IStateMachine):
    def __init__(self):
        self.d = {}

    def update(self, data):
        k, v = data.decode().split("=", 1)
        self.d[k] = v
        return Result(value=len(self.d))

    def lookup(self, q):
        return self.d.get(q)

    def save_snapshot(self, w, files, done):
        w.write(json.dumps(self.d).encode())

    def recover_from_snapshot(self, r, files, done):
        self.d = json.loads(r.read().decode())


def _mk_host(nid, reg, tmp, logdb_factory=None):
    return NodeHost(NodeHostConfig(
        deployment_id=7, rtt_millisecond=RTT_MS,
        nodehost_dir=os.path.join(tmp, f"h{nid}"), raft_address=f"d{nid}:1",
        raft_rpc_factory=lambda listen, reg=reg: loopback_factory(listen, reg),
        logdb_factory=logdb_factory,
        engine=EngineConfig(kind="vector", max_groups=4, max_peers=4, log_window=64,
                            device="cpu"),
    ))


def _group_cfg(nid):
    return Config(cluster_id=CLUSTER, node_id=nid, election_rtt=10, heartbeat_rtt=2)


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def kinds(verdicts):
    return [v.kind for v in verdicts]


def _assert_single_fault(verdicts, expected):
    ks = set(kinds(verdicts))
    assert expected in ks, f"{expected} missing from {sorted(ks)}"
    assert not (ks & (FAULT_KINDS - {expected})), sorted(ks)
    assert "healthy_idle" not in ks


def test_live_healthy_host_diagnoses_idle(tmp_path):
    nh = _mk_host(1, _Registry(), str(tmp_path))
    try:
        nh.start_cluster({1: "d1:1"}, False, lambda *_a: KV(), _group_cfg(1))
        assert _wait(lambda: nh.get_leader_id(CLUSTER)[1])
        for i in range(4):
            nh.sync_propose(nh.get_noop_session(CLUSTER), b"k=%d" % i, timeout_s=20.0)
        vs = PD.diagnose({1: nh}, window_s=0.8, interval_s=0.2, flight=[])
        assert kinds(vs) == ["healthy_idle"]
        assert vs[0].hosts == ["d1:1"]
    finally:
        nh.stop()


def test_live_partition_diagnoses_no_quorum(tmp_path):
    reg = _Registry()
    hosts = {n: _mk_host(n, reg, str(tmp_path)) for n in (1, 2, 3)}
    members = {n: f"d{n}:1" for n in (1, 2, 3)}
    try:
        for n, nh in hosts.items():
            nh.start_cluster(members, False, lambda *_a: KV(), _group_cfg(n))
        assert _wait(lambda: any(nh.get_leader_id(CLUSTER)[1] for nh in hosts.values()))
        for nh in hosts.values():
            nh.set_partitioned(True)
        # past a few election timeouts (10 x 50 ms ticks, randomized)
        time.sleep(2.0)
        s1 = [sample_host(nh) for nh in hosts.values()]
        time.sleep(2.5)
        s2 = [sample_host(nh) for nh in hosts.values()]
        vs = dual_diagnose_data(s1 + s2, flight=[])
        _assert_single_fault(vs, "no_quorum_partition")
        v = vs[kinds(vs).index("no_quorum_partition")]
        assert v.evidence["elections_started_delta"] > 0
        assert v.evidence["elections_won_delta"] == 0
        assert v.lanes == [str(CLUSTER)]
    finally:
        for nh in hosts.values():
            nh.stop()


def test_live_fsync_stall_diagnoses_wal(tmp_path):
    fp = FaultPlane(0xD0C)

    def logdb_factory(d):
        return ShardedLogDB(os.path.join(d, "logdb"),
                            kv_factory=fp.kv_factory("fsync:doc", WalKV))

    nh = _mk_host(1, _Registry(), str(tmp_path), logdb_factory=logdb_factory)
    try:
        nh.start_cluster({1: "d1:1"}, False, lambda *_a: KV(), _group_cfg(1))
        assert _wait(lambda: nh.get_leader_id(CLUSTER)[1])
        nh.sync_propose(nh.get_noop_session(CLUSTER), b"w=0", timeout_s=20.0)
        s1 = sample_host(nh)
        fp.set_spec(FaultSpec(fsync_stall=1.0, fsync_stall_s=(0.08, 0.08)))
        for i in range(10):
            nh.sync_propose(nh.get_noop_session(CLUSTER), b"k=%d" % i, timeout_s=30.0)
        s2 = sample_host(nh)
        assert s2["wal"]["ewma_s"] > s1["wal"]["ewma_s"]
        vs = dual_diagnose_data([s1, s2], flight=[])
        _assert_single_fault(vs, "wal_fsync_stall")
        v = vs[kinds(vs).index("wal_fsync_stall")]
        assert v.evidence["fsync_ewma_max_s"] >= 0.05
        assert v.evidence["barriers_delta"] > 0
    finally:
        fp.set_spec(FaultSpec())
        nh.stop()


def test_live_clock_jump_diagnoses_clock_anomaly(tmp_path):
    cp = ClockPlane(FaultPlane(0xC10))
    nh = _mk_host(1, _Registry(), str(tmp_path))
    try:
        nh.set_tick_clock(cp.clock_fn("h1"))
        nh.start_cluster({1: "d1:1"}, False, lambda *_a: KV(), _group_cfg(1))
        assert _wait(lambda: nh.get_leader_id(CLUSTER)[1])
        nh.sync_propose(nh.get_noop_session(CLUSTER), b"k=v", timeout_s=20.0)
        s1 = sample_host(nh)
        assert s1["clock_anomalies"] == 0
        cp.step_jump("h1", 5.0)
        assert _wait(lambda: nh.clock_anomalies() >= 1, timeout=10.0)
        s2 = sample_host(nh)
        vs = dual_diagnose_data([s1, s2], flight=[])
        _assert_single_fault(vs, "clock_anomaly")
        assert vs[kinds(vs).index("clock_anomaly")].evidence["clock_anomalies_delta"] >= 1
    finally:
        nh.stop()


def test_live_overload_storm_diagnoses_shed_storm(tmp_path):
    nh = _mk_host(1, _Registry(), str(tmp_path))
    try:
        nh.start_cluster({1: "d1:1"}, False, lambda *_a: KV(), _group_cfg(1))
        assert _wait(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front(
            admission=AdmissionConfig(default=TenantSpec(rate=1.0, burst=2.0)))
        s1 = sample_host(nh)
        tickets, shed = [], 0
        for i in range(30):
            try:
                tickets.append(front.propose(11, CLUSTER, b"s=%d" % i, 20.0))
            except ErrOverloaded:
                shed += 1
        assert shed >= 5
        for t in tickets:
            t.wait()
        s2 = sample_host(nh)
        vs = dual_diagnose_data([s1, s2], flight=[])
        _assert_single_fault(vs, "admission_shed_storm")
        assert vs[kinds(vs).index("admission_shed_storm")].evidence["shed_delta"] >= 5
    finally:
        nh.stop()


# --------------------------------------------------- bundle fixture/CLI
def _main(mod, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(args))
    return rc, out.getvalue(), err.getvalue()


def test_doctor_cli_renders_fixture_bundle():
    proc = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.tools.doctor", _FIXTURE],
        capture_output=True, text=True, cwd=_REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (proc.returncode, proc.stdout) == _main(RD, _FIXTURE)[:2]
    out = proc.stdout
    assert "raft-doctor:" in out and "snapshot_parked_remote" in out
    assert "commit_gap_frozen=6" in out and "hint:" in out


def test_doctor_cli_json_mode():
    rc, out, _ = _main(PD, _FIXTURE, "--json")
    assert (rc, out) == _main(RD, _FIXTURE, "--json")[:2]
    rep = json.loads(out)
    assert rep["schema"] == 1 and rep["source"] == "doctor_bundle"
    assert rep["verdicts"][0]["kind"] == "snapshot_parked_remote"
    assert rep["verdicts"][0]["severity"] == 70
    assert rep["verdicts"][0]["evidence"]["commit_gap_frozen"] == 6


def test_doctor_cli_rejects_garbage_input(tmp_path):
    bad = os.path.join(str(tmp_path), "nope.ring")
    rc, out, err = _main(PD, bad)
    assert rc == 2 and "doctor:" in err
    assert (rc, out, err) == _main(RD, bad)


def test_top_history_renders_fixture_with_doctor_footer():
    hist = os.path.join(_FIXTURE, "history.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.tools.top", "--history", hist],
        capture_output=True, text=True, cwd=_REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (proc.returncode, proc.stdout) == _main(RTOP, "--history", hist)[:2]
    assert "doctor: healthy_idle" in proc.stdout and "fix1:1" in proc.stdout


# ----------------------------------- rings written by the port's NodeHost
@pytest.fixture
def port_artifacts(tmp_path):
    """A port CPU NodeHost with the flight recorder teed into an mmap ring
    and its history sampler on, a few proposals, then stop: the ring,
    the history ring and a JSONL flight dump it leaves behind."""
    ring = str(tmp_path / "flight.ring")
    flight_recorder().attach_mmap(ring)
    nh = _mk_host(1, _Registry(), str(tmp_path))
    try:
        nh.start_history(interval_s=0.1)
        nh.start_cluster({1: "d1:1"}, False, lambda *_a: KV(), _group_cfg(1))
        assert _wait(lambda: nh.get_leader_id(CLUSTER)[1])
        for i in range(6):
            nh.sync_propose(nh.get_noop_session(CLUSTER), b"k=%d" % i, timeout_s=20.0)
        time.sleep(0.5)
        dump = str(tmp_path / "flight_dump.jsonl")
        nh.dump_flight(dump)
        hist = os.path.join(nh._dir, "history.ring")
    finally:
        nh.stop()
        flight_recorder().detach_mmap()
    return {"ring": ring, "history": hist, "dump": dump, "root": str(tmp_path)}


def test_both_packages_read_the_ports_rings_alike(port_artifacts):
    a = port_artifacts
    # timeline: the merged, filtered events, every rendering
    for args in ([a["ring"], a["history"], a["dump"], "--json"],
                 [a["ring"], a["dump"]],
                 ["--sweep", a["root"], "--chains"],
                 ["--sweep", a["root"], "--spans"],
                 [a["ring"], "--cluster", str(CLUSTER), "--json"]):
        port = _main(PT, *args)
        assert port == _main(RT, *args), args
        assert port[0] == 0 and port[1].strip()
    samples = [json.loads(ln) for ln in _main(PT, a["history"], "--json")[1].splitlines()]
    assert len(samples) >= 3 and all(s["event"] == "history_sample" for s in samples)
    # doctor over each artifact and over a bundle of them
    bundle = os.path.join(a["root"], "bundle")
    os.makedirs(bundle)
    os.replace(a["history"], os.path.join(bundle, "history.ring"))
    os.replace(a["dump"], os.path.join(bundle, "flight_dump.jsonl"))
    for path in (os.path.join(bundle, "history.ring"), a["ring"], bundle):
        for extra in ((), ("--json",)):
            port = _main(PD, path, *extra)
            assert port == _main(RD, path, *extra), path
            assert port[0] == 0
    rep = json.loads(_main(PD, bundle, "--json")[1])
    assert rep["hosts"] == ["d1:1"] and rep["samples"] >= 3
    # top's history view of the same ring
    ring = os.path.join(bundle, "history.ring")
    assert _main(PTOP, "--history", ring) == _main(RTOP, "--history", ring)
    assert _main(PTOP, "--history", ring, "--json") == _main(RTOP, "--history", ring, "--json")
