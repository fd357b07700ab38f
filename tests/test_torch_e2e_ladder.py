"""The BASELINE ladder through the port's NodeHost on the CPU
(`dragonboat_tpu_torch.e2e.run_ladder_config`, `device="cpu"`, 1-2 groups,
1.5 s windows): every config passes the gates chip_smoke's phase 5 holds it
to on the card (`e2e.gate_failures`: elections, commits, convergence,
lincheck, kernel builds, out-of-seam syncs, and per config the reads, the
lease serves, the drops, the snapshots and membership changes), and its
report carries every key that the JAX package's `bench.py` puts in that
config's record, plus the port's stamps. One run of `bench.bench_e2e` and
one of the port's, at the same tiny config-5 shape, hold the key sets and
the verdicts against each other."""
import json
import tempfile
import time

import pytest
import torch

from dragonboat_tpu_torch import e2e

# what the port's record adds to bench.py's (its stamps, the window's
# audit, the busy share on the card, convergence and lincheck)
PORT_EXTRAS = {
    "device", "backend", "host", "card", "power_limit", "groups_elected",
    "engine_steps", "engine_steps_per_s", "pipelined_steps", "wall_s",
    "groups_committed_in_window", "elections_in_window", "thread_cpu_share",
    "out_of_seam_syncs", "out_of_seam_sites", "in_seam_syncs", "kernel_builds",
    "host_stage_window_s", "busy", "groups_applied", "groups_diverged",
    "converged", "lincheck_ops", "lincheck_errors", "lincheck_ok",
    "engine_steps_total", "config", "drops_applied", "readindex_run", "msgs_in_window",
}
# the keys bench.py's ladder runner stamps on every config's record
LADDER_KEYS = {"label", "nominal_groups", "actual_groups", "scaled_down", "entries_per_msg"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_record_keys(n: int, ladder: bool = True) -> set:
    """The keys of bench.py's record for config n: the literal stamps of
    `_bench_e2e_body` (`bench.py:552-567`), its folds' keys as they come
    from bench.py itself, the keys it adds per traffic (`:568-576`,
    `_latency_report`'s read p99 when reads ran), and with `ladder` the
    stamps of `_run_ladder_config`. The config-5 run below holds this set
    against a real record."""
    import bench

    spec = bench.LADDER[n]
    keys = {"value", "groups", "replicas", "payload_bytes", "committed",
            "client_dropped", "seconds", "bring_up_s", "fsync", "shared_engine",
            "wave", "steps_per_sync", "host_stage_total_s", "fanout_pack_share"}
    for fold in (bench._mesh_report({}, False), bench._attribution_report({}, None, None),
                 bench._latency_report({}), bench._lane_report({}),
                 bench._serving_report({}), bench._read_report({}, 0, 0.0, "readindex"),
                 bench._census_report({}), bench._history_report(None)):
        keys |= set(fold)
    if spec.get("read_ratio"):
        keys |= {"reads_completed", "reads_submitted", "read_ratio", "readindex_latency_p99_s"}
    if spec.get("drop_rate"):
        keys.add("drop_rate")
    if spec.get("churn"):
        keys |= {"snapshots_requested", "membership_changes"}
    if spec.get("through_front"):
        # _front_measure's literal keys (bench.py:808-825)
        keys |= {"workload", "session_mode", "placement_enabled", "tenants",
                 "session_registered_total", "session_proposals_total",
                 "session_safe_retries_total", "session_errors_total"}
    if ladder:
        keys |= LADDER_KEYS
        if spec.get("both_read_modes"):
            keys |= {"readindex_mode", "lease_vs_readindex_reads"}
    return keys


def test_ladder_holds_bench_shapes():
    """Configs 1-8 with bench.py's labels, group counts (nominal and cut),
    replicas, payloads, waves, windows and traffic."""
    import bench

    assert sorted(e2e.LADDER) == sorted(bench.LADDER) == [1, 2, 3, 4, 5, 6, 7, 8]
    for n, spec in e2e.LADDER.items():
        ref = bench.LADDER[n]
        assert spec == ref, n


@pytest.mark.parametrize("config", sorted(e2e.LADDER), ids=lambda c: f"config{c}")
def test_ladder_config_on_the_cpu(config):
    """The config's gates, and bench.py's keys for it, at 1-2 groups
    (config 7 at 4, one group for each tenant)."""
    spec = e2e.LADDER[config]
    groups = min(max(2, spec.get("tenants", 0)), spec["groups"])
    r = e2e.run_ladder_config(config, groups=groups, duration=1.5, device="cpu")
    assert e2e.gate_failures(r) == [], json.dumps(r, default=str)
    assert r["actual_groups"] == groups and r["scaled_down"] == (groups != spec["nominal_groups"])
    assert r["backend"] == "torch" and set(r["host"]) == {"id", "calib_s"}
    want = bench_record_keys(config)
    assert want <= set(r), sorted(want - set(r))
    assert set(r) - want <= PORT_EXTRAS, sorted(set(r) - want - PORT_EXTRAS)
    assert set(r["phase_breakdown"]) >= {"pack", "dispatch", "fetch", "save", "apply"}
    if spec.get("read_ratio"):
        assert r["reads_submitted"] >= r["reads_completed"] > 0
        assert r["read_latency_samples"] > 0
        assert r["value"] == pytest.approx((r["committed"] + r["reads_completed"])
                                           / (r["seconds"] or 1), rel=0.01)
    if spec.get("both_read_modes"):
        assert r["read_mode"] == "lease"
        assert set(r["readindex_mode"]) == set(e2e._READINDEX_MODE_KEYS)
        assert r["lease_vs_readindex_reads"] > 0
    if spec.get("churn"):
        assert all(s.rsplit(":", 1)[-1] in e2e.RARE_PATH_SYNCS for s in r["out_of_seam_sites"])
    if spec.get("through_front"):
        assert r["workload"] == "through_front" and r["tenants"] == spec["tenants"]
        assert r["session_registered_total"] == spec["tenants"]
        assert r["serving_admitted_total"] >= r["committed"] - r["session_proposals_total"] > 0
        assert set(r["serving_tenant_latency"]) == {str(t) for t in range(spec["tenants"])}


def test_serving_fold_matches_bench():
    """The port's serving fold against bench.py's: on no hosts, and on
    live hosts of both packages, each with a serving front that admitted
    and completed the same proposals and a placement plane with no
    targets, the same counts and the same keys (latencies are each
    package's own)."""
    import bench
    from dragonboat_tpu import nodehost as ref_nodehost
    from dragonboat_tpu.config import (Config as RConfig, EngineConfig as REngineConfig,
                                       NodeHostConfig as RNodeHostConfig)
    from dragonboat_tpu.statemachine import IStateMachine as RSM, Result as RResult
    from dragonboat_tpu.transport.loopback import _Registry as RReg, loopback_factory as rlf
    from dragonboat_tpu_torch import nodehost as port_nodehost
    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.statemachine import IStateMachine, Result
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    assert e2e._serving_report({}) == bench._serving_report({})

    def live(NH, NHC, EC, C, SM, R, Reg, lf, engine):
        class Counter(SM):
            def __init__(self, *_):
                self.n = 0

            def update(self, cmd):
                self.n += 1
                return R(value=self.n)

            def lookup(self, q):
                return self.n

            def save_snapshot(self, w, files, done):
                w.write(str(self.n).encode())

            def recover_from_snapshot(self, r, files, done):
                self.n = int(r.read())

        reg = Reg()
        nh = NH(NHC(deployment_id=3, rtt_millisecond=50, raft_address="sf:1",
                    raft_rpc_factory=lambda a: lf(a, reg), engine=engine(EC)))
        try:
            nh.start_cluster({1: "sf:1"}, False, Counter,
                             C(cluster_id=9, node_id=1, election_rtt=10, heartbeat_rtt=2))
            deadline = time.monotonic() + 30
            while not nh.get_leader_id(9)[1] and time.monotonic() < deadline:
                time.sleep(0.02)
            front = nh.serving_front()
            nh.placement_plane(targets=[])
            for t in (1, 2):
                for tk in [front.propose(t, 9, b"x", 20.0) for _ in range(3 * t)]:
                    assert tk.wait().completed
            return nh, front

        except BaseException:
            nh.stop()
            raise

    ref_nh, _ = live(ref_nodehost.NodeHost, RNodeHostConfig, REngineConfig, RConfig, RSM,
                     RResult, RReg, rlf, lambda E: E(kind="vector", max_groups=8, max_peers=4,
                                                     log_window=64))
    try:
        port_nh, _ = live(port_nodehost.NodeHost, NodeHostConfig, EngineConfig, Config,
                          IStateMachine, Result, _Registry, loopback_factory,
                          lambda E: E(kind="vector", max_groups=8, max_peers=4, log_window=64,
                                      device="cpu"))
        try:
            ref, port = bench._serving_report({1: ref_nh}), e2e._serving_report({1: port_nh})
        finally:
            port_nh.stop()
    finally:
        ref_nh.stop()
    assert set(port) == set(ref)
    assert set(port["serving_tenant_latency"]) == set(ref["serving_tenant_latency"]) == {"1", "2"}
    for k in ("serving_admitted_total", "serving_shed_total", "serving_wakes_total",
              "migrations_started", "migrations_completed", "migrations_aborted",
              "migration_streams"):
        assert port[k] == ref[k], k
    assert port["serving_admitted_total"] == 9
    assert port["serving_bulk_p99_s"] >= port["serving_bulk_p50_s"] > 0


def test_drop_hook_keeps_the_decode_pipelined(monkeypatch):
    """Config 4 with the K=1 decode pipelined (the card's default, forced
    here on the CPU): with the drop hook installed, most of the window's
    steps are still decoded while the next one is in flight."""
    import functools

    from dragonboat_tpu_torch.config import EngineConfig

    monkeypatch.setattr(e2e, "EngineConfig",
                        functools.partial(EngineConfig, overlap_decode=True))
    r = e2e.run_ladder_config(4, groups=2, duration=1.5, device="cpu")
    assert e2e.gate_failures(r) == [], json.dumps(r, default=str)
    assert r["drops_applied"] > 0
    assert 2 * r["pipelined_steps"] > r["engine_steps"] > 0, (
        r["pipelined_steps"], r["engine_steps"])


def test_gates_catch_a_failed_run():
    """The gates see what each config must show."""
    ok = dict(config=5, actual_groups=2, groups_elected=2, committed=1, converged=True,
              lincheck_ok=True, lincheck_errors=0, kernel_builds=0, out_of_seam_syncs=2,
              out_of_seam_sites={"dragonboat_tpu_torch/engine/vector.py:1:"
                                 "_reconcile_membership": 2},
              snapshots_requested=1, membership_changes=1)
    assert e2e.gate_failures(ok) == []
    hot = dict(ok, out_of_seam_sites={"dragonboat_tpu_torch/engine/vector.py:9:_decode": 1})
    assert any("out-of-seam" in b for b in e2e.gate_failures(hot))
    assert e2e.gate_failures(dict(ok, membership_changes=0))
    assert e2e.gate_failures(dict(ok, config=4, out_of_seam_sites={}, out_of_seam_syncs=0))
    assert e2e.gate_failures(dict(ok, config=3, out_of_seam_sites={}, out_of_seam_syncs=0))
    lease = dict(ok, config=8, out_of_seam_sites={}, out_of_seam_syncs=0, reads_completed=5,
                 lease_reads_local=3)
    lease["readindex_run"] = dict(lease, lease_reads_local=0)
    assert e2e.gate_failures(lease) == []
    assert e2e.gate_failures(dict(lease, lease_reads_local=0))
    assert e2e.gate_failures(dict(lease, readindex_run=dict(lease, lease_reads_local=1)))
    assert e2e.gate_failures(dict(ok, error="2 groups never elected"))
    front = dict(ok, config=7, actual_groups=64, groups_elected=64, out_of_seam_sites={},
                 out_of_seam_syncs=0, session_registered_total=4, session_proposals_total=3)
    assert e2e.gate_failures(front) == []
    assert e2e.gate_failures(dict(front, session_registered_total=3))
    assert e2e.gate_failures(dict(front, session_proposals_total=0))
    assert e2e.gate_failures(dict(front, actual_groups=2, groups_elected=2,
                                  session_registered_total=2)) == []


def test_main_defaults_to_the_nominal_width(monkeypatch, capsys):
    seen = []

    def fake(n, groups=None, duration=None, device="cuda", shard_over_mesh=False):
        seen.append((n, groups, duration, device, shard_over_mesh))
        return dict(config=n, actual_groups=groups, error="not run")

    monkeypatch.setattr(e2e, "run_ladder_config", fake)
    assert e2e.main(["--config", "3"]) == 1  # a failed gate fails the run
    assert e2e.main(["--config", "5", "--device", "cpu", "--groups", "4",
                     "--duration", "3"]) == 1
    assert e2e.main(["--config", "7", "--device", "cpu", "--groups", "4",
                     "--duration", "3"]) == 1
    assert e2e.main(["--config", "6", "--shard-over-mesh"]) == 1
    assert seen == [(3, 10_000, None, "cuda", False), (5, 4, 3.0, "cpu", False),
                    (7, 4, 3.0, "cpu", False), (6, 1024, None, "cuda", True)]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["gate_failures"]
    with pytest.raises(SystemExit):
        e2e.main(["--config", "9"])


def test_config5_against_bench(tmp_path):
    """One run of bench.bench_e2e and one of the port's bench_e2e at the
    same tiny config-5 shape (2 groups x 5 replicas, wave 64, churn, 1.5 s):
    bench.py's record has exactly the keys bench_record_keys names, the
    port's carries all of them, and both reach the same verdicts: every
    group elected, proposals committed, snapshots and membership changes
    requested, and no device read outside the rare reconcile paths."""
    import bench
    from dragonboat_tpu.profile import compile_watch, sync_audit

    sa = sync_audit().install()
    compile_watch().install()
    try:
        ref = bench.bench_e2e(2, 1.5, 16, str(tmp_path / "ref"), wave=64, replicas=5,
                              churn=True)
    finally:
        sa.uninstall()
    with tempfile.TemporaryDirectory() as d:
        port = e2e.bench_e2e(2, 1.5, 16, d, wave=64, replicas=5, churn=True, device="cpu")
    assert set(ref) == bench_record_keys(5, ladder=False)
    assert set(ref) <= set(port) and set(port) - set(ref) <= PORT_EXTRAS
    for r in (ref, port):
        assert "error" not in r
        assert r["committed"] > 0
        assert r["snapshots_requested"] > 0 and r["membership_changes"] > 0
        sites = r["device_syncs"]["sites"]
        assert all(s.rsplit(":", 1)[-1] in e2e.RARE_PATH_SYNCS for s in sites), sites
    assert port["groups_elected"] == 2 and port["converged"] and port["lincheck_ok"]
    for k in ("read_mode", "shard_over_mesh", "n_devices", "mesh_shape", "padded_groups",
              "fsync", "shared_engine", "replicas", "wave", "payload_bytes"):
        assert port[k] == ref[k], k
