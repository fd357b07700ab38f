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
    "engine_steps_total", "config", "drops_applied", "readindex_run",
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
    if ladder:
        keys |= LADDER_KEYS
        if spec.get("both_read_modes"):
            keys |= {"readindex_mode", "lease_vs_readindex_reads"}
    return keys


def test_ladder_holds_bench_shapes():
    """Configs 1-6 and 8 with bench.py's labels, group counts (nominal and
    cut), replicas, payloads, waves, windows and traffic."""
    import bench

    assert sorted(e2e.LADDER) == [1, 2, 3, 4, 5, 6, 8]
    for n, spec in e2e.LADDER.items():
        ref = bench.LADDER[n]
        assert spec == ref, n


@pytest.mark.parametrize("config", sorted(e2e.LADDER), ids=lambda c: f"config{c}")
def test_ladder_config_on_the_cpu(config):
    """The config's gates, and bench.py's keys for it, at 1-2 groups."""
    spec = e2e.LADDER[config]
    groups = min(2, spec["groups"])
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


def test_serving_fold_is_bench_zero_fold():
    """The port has no serving front: its record carries bench.py's
    serving keys with the values bench.py reads off hosts without one."""
    import bench

    assert e2e.SERVING_ZERO == bench._serving_report({})


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


def test_main_defaults_to_the_nominal_width(monkeypatch, capsys):
    seen = []

    def fake(n, groups=None, duration=None, device="cuda"):
        seen.append((n, groups, duration, device))
        return dict(config=n, actual_groups=groups, error="not run")

    monkeypatch.setattr(e2e, "run_ladder_config", fake)
    assert e2e.main(["--config", "3"]) == 1  # a failed gate fails the run
    assert e2e.main(["--config", "5", "--device", "cpu", "--groups", "4",
                     "--duration", "3"]) == 1
    assert seen == [(3, 10_000, None, "cuda"), (5, 4, 3.0, "cpu")]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["gate_failures"]
    with pytest.raises(SystemExit):
        e2e.main(["--config", "7"])


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
