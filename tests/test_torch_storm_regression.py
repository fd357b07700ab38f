"""Regression net for the load-sensitive `overload_no_urgent_shed`
longhaul verdict (seed 0x8693C4A3DB1A once failed on a clean tree on a
loaded 2-cpu box), on the port's vector engine on the CPU.

Root cause: the urgent ledger conflated POLICY sheds (the admission
plane refusing urgent work — the contract violation) with CAPACITY
effects (admitted urgent reads completing slowly on a loaded box). The
fix splits the ledger (`urgent_shed` vs `urgent_stalled`) and anchors
the wait budget to the round's measured on-box baseline
(serving/storm.py _probe_urgent_baseline) — a slow box reads as
latency, never as a shed.
"""
import time

import pytest
import torch

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.faults import FaultPlane
from dragonboat_tpu_torch.requests import ErrSystemBusy
from dragonboat_tpu_torch.serving.admission import ErrTenantThrottled
from dragonboat_tpu_torch.serving.storm import (
    StormReport,
    _offer_window,
    _wait_urgent,
    storm_burst,
)
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

pytestmark = pytest.mark.serving

# the failing round seed — kept as the named regression
# anchor (the longhaul round derives every storm window from it)
TRIAGE_SEED = 0x8693C4A3DB1A


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
        w.write(b"{}")

    def recover_from_snapshot(self, r, files, done):
        r.read()


class _ShedFront:
    """Front stub: every read is refused — once by POLICY (typed
    ErrOverloaded subclass), once by downstream CAPACITY (plain
    ErrSystemBusy). Bulk proposes complete instantly."""

    def __init__(self, read_exc):
        self._read_exc = read_exc

    def read(self, tenant, cluster_id, timeout_s):
        raise self._read_exc

    def propose(self, tenant, cluster_id, cmd, timeout_s):
        class _T:
            def wait(self):
                class _R:
                    completed = True

                return _R()

        return _T()


def _offer(front):
    rep = StormReport(seed=1)
    _offer_window(
        front, 1, (1,), {1: 10}, urgent_tenant=9, urgent_every=2,
        cmd_for=lambda i: b"k=v", rep=rep, op_base=0, timeout_s=1.0,
    )
    return rep


def test_policy_shed_vs_capacity_refusal_classification():
    rep = _offer(_ShedFront(ErrTenantThrottled(0.1)))
    assert rep.urgent_shed > 0 and rep.urgent_stalled == 0
    rep = _offer(_ShedFront(ErrSystemBusy()))
    assert rep.urgent_shed == 0 and rep.urgent_stalled > 0


def test_wait_urgent_counts_stalls_not_sheds():
    class _NeverDone:
        def wait(self, t):
            class _R:
                completed = False

            return _R()

    rep = StormReport(seed=1)
    rep.urgent_wait_s = 0.05
    _wait_urgent([_NeverDone(), _NeverDone()], rep)
    assert rep.urgent_stalled == 2 and rep.urgent_shed == 0


@pytest.fixture(autouse=True)
def one_thread():
    # the plain step is thousands of tiny ops: torch's intra-op pool only
    # adds overhead at these widths, and several engines share the process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the port's CPU step is eager torch ops: 50 ms ticks (the reference: 5)
RTT_MS = 50


def test_triage_seed_burst_no_false_urgent_shed(tmp_path):
    """The named seed, replayed twice through storm_burst on a live
    host: zero POLICY sheds both times, a capacity-aware wait budget
    anchored to the measured baseline, and a bit-identical window
    signature (same-seed replay)."""
    reg = _Registry()
    nh = NodeHost(
        NodeHostConfig(
            deployment_id=4, rtt_millisecond=RTT_MS, raft_address="st1:1",
            raft_rpc_factory=lambda l, reg=reg: loopback_factory(l, reg),
            engine=EngineConfig(
                kind="vector", max_groups=32, max_peers=4, log_window=64, device="cpu",
            ),
        )
    )
    try:
        nh.start_cluster(
            {1: "st1:1"}, False, lambda c, n: KV(),
            Config(cluster_id=1, node_id=1, election_rtt=20,
                   heartbeat_rtt=4),
        )
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            lid, ok = nh.get_leader_id(1)
            if ok:
                break
            time.sleep(0.02)
        outs = []
        for _ in range(2):
            fp = FaultPlane(TRIAGE_SEED)
            outs.append(
                storm_burst(
                    nh, 1, fp, burst_s=0.25, capacity_rate=400.0,
                    timeout_s=4.0,
                )
            )
        for out in outs:
            assert out["urgent_shed"] == 0, out
            # the budget anchors to the measured on-box baseline and can
            # only be MORE generous than the raw timeout
            assert out["urgent_wait_s"] >= 4.0
            assert out["urgent_baseline_s"] > 0.0
        assert outs[0]["signature"] == outs[1]["signature"]
        assert outs[0]["offered"] == outs[1]["offered"]
    finally:
        nh.stop()
