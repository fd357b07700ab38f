"""The `-m perf` gates of tests/test_profile.py on the PyTorch port, on the
CPU: a live port NodeHost with `EngineConfig(kind="vector", device="cpu")`
(the reference fixture's shape: 8 groups, `max_peers=4`, `log_window=64`,
every step sampled) makes no device read outside the blessed fetch seams
and builds no kernel, while the phase plane, the gauges and the exposition
carry the attribution; the census, the counters and the history sampler
add no read; the e2e harness's report folds keep their schema on the
bring-up-failed path. The audit counts reads of tensors on the engine's
own device (`sync_audit().install(device="cpu")` here), and two mutation
tests prove it: an `.item()` added to a decode stage and a `.cpu()` added
to `_pack` are each reported by site."""
from __future__ import annotations

import io
import os
import time

import pytest
import torch

from dragonboat_tpu_torch.profile import (
    VECTOR_PHASES,
    compile_watch,
    diff_compiles,
    phase_plane,
    sync_audit,
    write_exposition,
)

# a plain CPU step costs a few ms; a 50 ms tick keeps the election timer
# clear of the step time
RTT_MS = 50


@pytest.fixture()
def vec_host(tmp_path):
    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory
    from test_torch_nodehost import KVSM

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reg = _Registry()
    nh = NodeHost(
        NodeHostConfig(
            deployment_id=1,
            rtt_millisecond=RTT_MS,
            raft_address="perf1:1",
            nodehost_dir=str(tmp_path),
            raft_rpc_factory=lambda l: loopback_factory(l, reg),
            enable_metrics=True,
            engine=EngineConfig(
                kind="vector",
                max_groups=8,
                max_peers=4,
                log_window=64,
                profile_sample_ratio=1,  # sample EVERY step
                device="cpu",
            ),
        )
    )
    try:
        nh.start_cluster(
            {1: "perf1:1"},
            False,
            lambda c, n: KVSM(c, n),
            Config(cluster_id=1, node_id=1, election_rtt=10, heartbeat_rtt=2),
        )
        deadline = time.time() + 60
        while time.time() < deadline:
            lid, ok = nh.get_leader_id(1)
            if ok and lid == 1:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("no leader")
        yield nh
    finally:
        nh.stop()
        torch.set_num_threads(n)


def _new_sites(sa, mark):
    return {s: n for s, n in sa.out_of_seam_in_package().items() if n > mark.get(s, 0)}


def _audited_traffic(nh, prefix, n=8):
    """Warm up, mark the audit, drive `n` proposals and a ReadIndex read;
    returns (sync mark, sync now, new package sites, kernel-build delta)."""
    sa = sync_audit().install(device="cpu")
    cw = compile_watch().install()
    sess = nh.get_noop_session(1)
    for i in range(4):
        nh.sync_propose(sess, f"{prefix}w{i}=v".encode(), timeout_s=10.0)
    sync_mark = sa.snapshot()
    pkg_mark = dict(sa.out_of_seam_in_package())
    compile_mark = cw.snapshot()
    for i in range(n):
        nh.sync_propose(sess, f"{prefix}k{i}=v".encode(), timeout_s=10.0)
    rs = nh.read_index(1, 5.0)
    assert rs.wait(10.0).completed
    return (sync_mark, sa.snapshot(), _new_sites(sa, pkg_mark),
            diff_compiles(compile_mark, cw.snapshot()))


@pytest.mark.perf
def test_vector_scenario_runtime_audit_clean(vec_host):
    """Acceptance: during a live vector-engine scenario on the CPU the ONLY
    reads of engine tensors are the blessed `_fetch_output` seam's, and
    steady state builds no kernel."""
    nh = vec_host
    try:
        sync_mark, sync_now, new_pkg, d = _audited_traffic(nh, "")
        # the seam kept transferring (the engine stepped)...
        assert sync_now["in_seam"] > sync_mark["in_seam"]
        # ...and NOTHING ELSE in the package read a CPU tensor on the host
        assert not new_pkg, f"out-of-seam device syncs at {new_pkg}"
        assert d["total"] == 0, f"steady-state kernel builds: {d}"
        assert not d["per_function"]
    finally:
        sync_audit().uninstall()
    # the phase plane saw every vector step phase that ran
    plane = phase_plane()
    for phase in ("pack", "dispatch", "fetch", "place", "save", "apply"):
        h = plane.histogram("vector", phase)
        assert h is not None and h.count > 0, f"phase {phase} unattributed"
    # gauges + exposition carry the audit
    nh._export_health_gauges()
    m = nh.metrics
    assert m.gauge_value("engine_device_syncs_total", (0, 0)) > 0
    assert m.gauge_value("engine_device_syncs_out_of_seam", (0, 0)) is not None
    assert m.gauge_value("engine_compile_events_total", (0, 0)) is not None
    assert m.gauge_value("engine_steps_per_sync", (0, 0)) is not None
    out = io.StringIO()
    nh.write_health_metrics(out)
    text = out.getvalue()
    assert "engine_phase_seconds_bucket" in text
    assert 'phase="fetch"' in text
    assert 'engine="vector"' in text
    assert "dragonboat_tpu_engine_device_syncs_total" in text


@pytest.mark.perf
def test_audit_sees_the_cpu_engine():
    """The repair itself: with the audit on the CPU, a CPU tensor's host
    reads are counted by site; with the audit on the card (the default),
    they are not."""
    sa = sync_audit()
    try:
        sa.install(device="cpu")
        before = sa.snapshot()["out_of_seam"]
        t = torch.arange(3)
        t[0].item()
        t.tolist()
        t.cpu()
        t.numpy()
        assert sa.snapshot()["out_of_seam"] - before == 4
        sa.install(device="cuda")
        before = sa.snapshot()["out_of_seam"]
        t.tolist()
        assert sa.snapshot()["out_of_seam"] == before
    finally:
        sa.uninstall()
    assert sa.device_type == "cuda"


# the mutations: (engine method, the read added at its entry)
MUTATIONS = {
    "decode_item": ("_decode_apply", "self._shards[0].state.term[0].item()"),
    "pack_cpu": ("_pack", "self._shards[0].state.committed.cpu()"),
}


@pytest.mark.perf
@pytest.mark.parametrize("stage", sorted(MUTATIONS))
def test_audit_reports_a_read_added_to_a_stage(vec_host, monkeypatch, stage):
    """Mutation: an `.item()` on an engine tensor inside a decode stage
    (`_decode_apply`), or a `.cpu()` inside `_pack`, fails the clean-audit
    assertion of the test above and is reported by site. The mutant is
    compiled under the engine module's file name, so the audit attributes
    it to the package as it would a read written into vector.py."""
    from dragonboat_tpu_torch.engine import vector

    method, read = MUTATIONS[stage]
    ns = {"orig": getattr(vector.VectorEngine, method)}
    src = (f"def mutant_{method}(self, *a, **k):\n"
           f"    {read}\n"
           f"    return orig(self, *a, **k)\n")
    exec(compile(src, vector.__file__, "exec"), ns)
    monkeypatch.setattr(vector.VectorEngine, method, ns[f"mutant_{method}"])
    assert vec_host.engine.core._shards[0].state.term.device.type == "cpu"
    try:
        _mark, _now, new_pkg, _d = _audited_traffic(vec_host, stage, n=4)
    finally:
        sync_audit().uninstall()
    site = f"dragonboat_tpu_torch/engine/vector.py:2:mutant_{method}"
    assert new_pkg, "the audit passed a read added to " + method
    assert new_pkg.get(site, 0) > 0, new_pkg


@pytest.mark.perf
def test_census_folds_a_private_copy_of_the_live_mirrors():
    """The census runs on tick and sampler threads while the engine's loop
    thread flips lanes active. It must fold copies of the mirrors: a
    boolean mask that gains True entries between numpy's count of them
    and its copy loop overran the output buffer (glibc heap corruption
    at 5 hosts x 1024 groups on the card) or, here, left the fill empty
    with lanes counted active. Two seconds of snapshots against a thread
    that rewrites the mask must all succeed and stay consistent."""
    import threading

    import numpy as np

    from dragonboat_tpu_torch.profile import DeviceCensus

    G = 1 << 16
    c = DeviceCensus()
    c.set_planes({"state.log_term": G * 256 * 4}, ("state.log_term",), log_window=256)
    active = np.zeros(G, bool)
    last, first = np.arange(G, dtype=np.int64), np.ones(G, np.int64)
    stop = threading.Event()

    def flip():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            active[:] = False
            for g in rng.permutation(G)[: G // 2]:
                active[g] = True

    t = threading.Thread(target=flip)
    t.start()
    n, deadline = 0, time.monotonic() + 2.0
    try:
        while time.monotonic() < deadline:
            out = c.snapshot(last=last, devfirst=first, active=active)
            assert 0 <= out["lanes_active"] <= G // 2
            assert 0.0 <= out["log_fill_p50"] <= 1.0
            n += 1
    finally:
        stop.set()
        t.join()
    assert n > 10


@pytest.mark.perf
def test_census_and_counters_add_zero_syncs(vec_host):
    """Reading the census and the counter plane on a LIVE vector scenario
    adds ZERO out-of-seam reads and zero kernel builds."""
    from dragonboat_tpu_torch.ops.state import CTR_NAMES

    nh = vec_host
    sa = sync_audit().install(device="cpu")
    cw = compile_watch().install()
    try:
        sess = nh.get_noop_session(1)
        for i in range(4):
            nh.sync_propose(sess, f"c{i}=v".encode(), timeout_s=10.0)
        pkg_mark = dict(sa.out_of_seam_in_package())
        compile_mark = cw.snapshot()
        census = counters = lanes = None
        for i in range(4):
            census = nh.engine.device_census()
            counters = nh.engine.counter_stats()
            lanes = nh.engine.lane_counters()
            nh.sync_propose(sess, f"z{i}=v".encode(), timeout_s=10.0)
        new_pkg = _new_sites(sa, pkg_mark)
        assert not new_pkg, f"telemetry read synced the device at {new_pkg}"
        d = diff_compiles(compile_mark, cw.snapshot())
        assert d["total"] == 0, f"telemetry read built a kernel: {d}"
    finally:
        sa.uninstall()
    assert census["hbm_bytes_total"] > 0
    assert 0 < census["hbm_log_bytes"] < census["hbm_bytes_total"]
    assert census["lanes_active"] == 1
    assert census["log_window"] == 64
    assert 0.0 < census["log_fill_p50"] <= 1.0
    assert 0.0 <= census["hbm_waste_ratio"] < 1.0
    assert "state.log_term" in census["planes"]
    assert set(counters) == set(CTR_NAMES)
    assert counters["elections_won"] >= 1
    assert counters["commit_advances"] >= 8
    assert set(lanes) == {1}
    assert lanes[1]["commit_advances"] == counters["commit_advances"]


@pytest.mark.perf
def test_history_sampler_adds_zero_syncs_and_zero_builds(vec_host, tmp_path):
    """A LIVE HistorySampler ticking at a hot cadence over a vector host
    adds ZERO out-of-seam reads and zero kernel builds."""
    from dragonboat_tpu_torch.profile import (
        HISTORY_STATS_KEYS,
        HistorySampler,
        read_history,
    )

    nh = vec_host
    sa = sync_audit().install(device="cpu")
    cw = compile_watch().install()
    ring = str(tmp_path / "hist" / "history.ring")
    os.makedirs(os.path.dirname(ring))
    sampler = None
    try:
        sess = nh.get_noop_session(1)
        for i in range(4):
            nh.sync_propose(sess, f"w{i}=v".encode(), timeout_s=10.0)
        pkg_mark = dict(sa.out_of_seam_in_package())
        compile_mark = cw.snapshot()
        sampler = HistorySampler(ring, {0: nh}, interval_s=0.02).start()
        try:
            for i in range(8):
                nh.sync_propose(sess, f"h{i}=v".encode(), timeout_s=10.0)
            time.sleep(0.1)  # several sampler ticks land mid-traffic
        finally:
            sampler.stop()
        new_pkg = _new_sites(sa, pkg_mark)
        assert not new_pkg, f"history sampling synced the device at {new_pkg}"
        d = diff_compiles(compile_mark, cw.snapshot())
        assert d["total"] == 0, f"history sampling built a kernel: {d}"
    finally:
        sa.uninstall()
    st = sampler.stats()
    assert list(st) == list(HISTORY_STATS_KEYS)
    assert st["samples_total"] >= 2 and st["errors_total"] == 0
    _meta, samples = read_history(ring)
    assert len(samples) == st["samples_total"]
    last = samples[-1]
    assert last["event"] == "history_sample" and last["schema"] == 1
    assert last["host"] == "perf1:1"
    lane = last["lanes"]["1"]
    assert lane["leader_id"] == 1 and lane["commit_gap"] >= 0
    assert lane["counters"]["commit_advances"] >= 8
    assert last["counters"]["elections_won"] >= 1
    assert last["census"]["hbm_bytes_total"] > 0
    assert last.get("errors", []) == []


@pytest.mark.perf
def test_bench_attribution_fold_schema():
    """The e2e report always carries phase_breakdown (ALL canonical phase
    keys, zero when the phase never ran), device_syncs and compile_events
    — even on the zero-host / bring-up-failed path."""
    from dragonboat_tpu_torch import e2e

    r = e2e._attribution_report({}, None, None)
    assert set(r["phase_breakdown"]) == set(VECTOR_PHASES)
    assert all(v == 0.0 for v in r["phase_breakdown"].values())
    assert r["device_syncs"] == {"in_seam": 0, "out_of_seam": 0, "sites": {}}
    assert r["compile_events"]["total"] == 0
    assert r["compile_events"]["per_function"] == {}


@pytest.mark.perf
def test_bench_census_fold_schema():
    """The census and counter fold, zero-filled on the zero-host path."""
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.ops.state import CTR_NAMES
    from dragonboat_tpu_torch.profile import CENSUS_KEYS

    r = e2e._census_report({})
    assert set(r) == set(CENSUS_KEYS) | {"counters"}
    assert r["hbm_bytes_total"] == 0
    assert r["hbm_log_bytes"] == 0
    assert r["log_fill_p50"] == 0.0
    assert r["log_fill_p99"] == 0.0
    assert r["hbm_waste_ratio"] == 0.0
    assert set(r["counters"]) == set(CTR_NAMES)
    assert all(v == 0 for v in r["counters"].values())


@pytest.mark.perf
def test_bench_history_fold_schema(tmp_path):
    """The history_* sampler keys, zero-filled when the sampler never
    started; a live sampler reports its real counts."""
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.profile import HISTORY_STATS_KEYS

    r = e2e._history_report(None)
    assert set(r) == {f"history_{k}" for k in HISTORY_STATS_KEYS}
    assert r["history_samples_total"] == 0
    assert r["history_errors_total"] == 0
    assert r["history_sample_cost_seconds_total"] == 0.0
    assert r["history_interval_seconds"] == 0.0
    sampler = e2e._start_history(str(tmp_path), {})
    assert sampler is not None
    try:
        sampler.sample_once()
    finally:
        sampler.stop(final_sample=False)
    live = e2e._history_report(sampler)
    assert set(live) == set(r)
    assert live["history_interval_seconds"] > 0.0


@pytest.mark.perf
def test_write_exposition_standalone():
    out = io.StringIO()
    write_exposition(out)  # whatever the process accumulated so far
    # never raises; emits nothing or conformant families only
    for ln in out.getvalue().splitlines():
        assert ln.startswith("#") or "dragonboat_tpu_" in ln
