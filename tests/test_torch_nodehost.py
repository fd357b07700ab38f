"""The scenarios of tests/test_nodehost.py through the PyTorch port's
NodeHost on the CPU (EngineConfig(device="cpu"): the vector engine over the
plain PyTorch step): single-node propose/read, three replicas, many groups
on one host, session dedup, membership change, restart replay and leader
transfer. Each runs at K=1, at K=1 with the pipelined decode
(overlap_decode=True, which is off by default on the CPU) and at K=8 (the
super-step with the on-device router)."""
import time

import pytest
import torch

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.requests import ErrRejected
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory


@pytest.fixture(params=[(1, False), (1, True), (8, False)],
                ids=["k1", "k1-overlap", "k8"])
def mode(request):
    """(steps_per_sync, overlap_decode)."""
    return request.param


@pytest.fixture(autouse=True)
def one_thread():
    # the plain step is thousands of tiny ops: torch's intra-op thread pool
    # only adds overhead at these widths (and three engines share it)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a plain step on the CPU costs a few ms (a super-step ~50 ms) and the
# engines of one test share the GIL, so at the reference tests' 5 ms tick
# every step already runs at the heartbeat-RTT catch-up cap and elections
# churn; a 50 ms tick keeps followers' election timers clear of the
# heartbeat cadence in every mode
RTT_MS = 50


class KVSM(IStateMachine):
    """In-memory KV test SM (cf. internal/tests/kvtest.go, sans chaos)."""

    instances = []

    def __init__(self, cluster_id, node_id):
        self.cluster_id = cluster_id
        self.node_id = node_id
        self.data = {}
        self.update_count = 0
        KVSM.instances.append(self)

    def update(self, cmd: bytes) -> Result:
        k, v = cmd.decode().split("=", 1)
        self.data[k] = v
        self.update_count += 1
        return Result(value=self.update_count)

    def lookup(self, q):
        return self.data.get(q)

    def save_snapshot(self, w, files, done):
        import json

        w.write(json.dumps([self.data, self.update_count]).encode())

    def recover_from_snapshot(self, r, files, done):
        import json

        self.data, self.update_count = json.loads(r.read().decode())


def mk_nodehost(addr, registry, nodehost_dir="", mode=(1, False)):
    cfg = NodeHostConfig(
        deployment_id=1,
        rtt_millisecond=RTT_MS,
        raft_address=addr,
        nodehost_dir=nodehost_dir,
        raft_rpc_factory=lambda listen: loopback_factory(listen, registry),
        engine=EngineConfig(
            kind="vector", max_groups=32, max_peers=4, log_window=64,
            device="cpu", steps_per_sync=mode[0], overlap_decode=mode[1],
            # K>1 runs as it is deployed: the test's hosts share one core,
            # so co-hosted traffic goes through the on-device router
            share_scope=f"k8-{id(registry)}" if mode[0] > 1 else None,
        ),
    )
    return NodeHost(cfg)


def group_config(cluster_id, node_id, **kw):
    return Config(
        cluster_id=cluster_id,
        node_id=node_id,
        election_rtt=10,
        heartbeat_rtt=2,
        **kw,
    )


def wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(autouse=True)
def clear_instances():
    KVSM.instances = []
    yield
    KVSM.instances = []


def test_single_node_propose_and_read(mode):
    reg = _Registry()
    nh = mk_nodehost("a:1", reg, mode=mode)
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(100, 1))
        assert wait_for(lambda: nh.get_leader_id(100)[1])
        s = nh.get_noop_session(100)
        r = nh.sync_propose(s, b"k1=v1", timeout_s=20.0)
        assert r.value == 1
        assert nh.sync_read(100, "k1", timeout_s=20.0) == "v1"
        # a second propose
        r2 = nh.sync_propose(s, b"k2=v2")
        assert r2.value == 2
        assert nh.sync_read(100, "k2") == "v2"
    finally:
        nh.stop()


def test_three_replicas_replicate(mode):
    reg = _Registry()
    members = {1: "a:1", 2: "b:2", 3: "c:3"}
    nhs = [mk_nodehost(addr, reg, mode=mode) for addr in members.values()]
    try:
        for nid, nh in zip(members, nhs):
            nh.start_cluster(members, False, KVSM, group_config(5, nid))
        assert wait_for(
            lambda: any(nh.get_leader_id(5)[1] for nh in nhs), timeout=45
        )
        # find leader host
        def leader_nh():
            for nh in nhs:
                lid, ok = nh.get_leader_id(5)
                if ok:
                    nid = {v: k for k, v in members.items()}[nh.raft_address()]
                    if lid == nid:
                        return nh
            return None

        assert wait_for(lambda: leader_nh() is not None, timeout=45)
        lnh = leader_nh()
        s = lnh.get_noop_session(5)
        res = lnh.sync_propose(s, b"x=42", timeout_s=20.0)
        assert res.value == 1
        # all three replicas converge
        assert wait_for(
            lambda: sum(1 for sm in KVSM.instances if sm.data.get("x") == "42") == 3
        )
        # linearizable read from the leader host
        assert lnh.sync_read(5, "x") == "42"
    finally:
        for nh in nhs:
            nh.stop()


def test_many_groups_one_nodehost(mode):
    reg = _Registry()
    nh = mk_nodehost("a:1", reg, mode=mode)
    n_groups = 16
    try:
        for g in range(1, n_groups + 1):
            nh.start_cluster({1: "a:1"}, False, KVSM, group_config(g, 1))
        assert wait_for(
            lambda: all(nh.get_leader_id(g)[1] for g in range(1, n_groups + 1)),
            timeout=20,
        )
        for g in range(1, n_groups + 1):
            s = nh.get_noop_session(g)
            nh.sync_propose(s, b"g=%d" % g)
        for g in range(1, n_groups + 1):
            assert nh.sync_read(g, "g") == str(g)
    finally:
        nh.stop()


def test_session_dedup_e2e(mode):
    reg = _Registry()
    nh = mk_nodehost("a:1", reg, mode=mode)
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(7, 1))
        assert wait_for(lambda: nh.get_leader_id(7)[1])
        s = nh.sync_get_session(7)
        r1 = nh.sync_propose(s, b"a=1")
        # NOT calling proposal_completed: retry of same series must dedup
        rs = nh.propose(s, b"a=SHOULD-NOT-APPLY", 4.0)
        r2 = rs.wait(5.0)
        assert r2.completed
        assert r2.result == r1
        sm = KVSM.instances[-1]  # instances[0] is the start-time type probe
        assert sm.data["a"] == "1"
        s.proposal_completed()
        r3 = nh.sync_propose(s, b"b=2")
        assert sm.data["b"] == "2"
        s.proposal_completed()
        nh.sync_close_session(s)
        # proposing on closed session rejected
        s.series_id = 99
        with pytest.raises(ErrRejected):
            nh.sync_propose(s, b"c=3")
    finally:
        nh.stop()


def test_membership_change_e2e(mode):
    reg = _Registry()
    members = {1: "a:1", 2: "b:2", 3: "c:3"}
    nhs = {nid: mk_nodehost(addr, reg, mode=mode) for nid, addr in members.items()}
    try:
        for nid in (1, 2):
            nhs[nid].start_cluster(
                {1: "a:1", 2: "b:2"}, False, KVSM, group_config(9, nid)
            )
        assert wait_for(
            lambda: any(nhs[n].get_leader_id(9)[1] for n in (1, 2)), timeout=45
        )
        lid = next(
            nhs[n].get_leader_id(9)[0] for n in (1, 2) if nhs[n].get_leader_id(9)[1]
        )
        lnh = nhs[lid]
        lnh.sync_request_add_node(9, 3, "c:3", timeout_s=25.0)
        m = lnh.get_cluster_membership(9)
        assert m.addresses.get(3) == "c:3"
        # node 3 joins
        nhs[3].start_cluster({}, True, KVSM, group_config(9, 3))
        s = lnh.get_noop_session(9)
        lnh.sync_propose(s, b"after=join")
        assert wait_for(
            lambda: sum(
                1 for sm in KVSM.instances if sm.data.get("after") == "join"
            )
            == 3,
            timeout=45,
        )
        # remove node 3 again
        lnh.sync_request_delete_node(9, 3, timeout_s=25.0)
        m2 = lnh.get_cluster_membership(9)
        assert 3 not in m2.addresses
    finally:
        for nh in nhs.values():
            nh.stop()


def test_restart_replay(tmp_path, mode):
    reg = _Registry()
    d = str(tmp_path)
    nh = mk_nodehost("a:1", reg, nodehost_dir=d, mode=mode)
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(3, 1))
        assert wait_for(lambda: nh.get_leader_id(3)[1])
        s = nh.get_noop_session(3)
        for i in range(5):
            nh.sync_propose(s, b"k%d=%d" % (i, i))
    finally:
        nh.stop()
    # restart: log replay restores the SM
    reg2 = _Registry()
    nh2 = mk_nodehost("a:1", reg2, nodehost_dir=d, mode=mode)
    try:
        nh2.start_cluster({1: "a:1"}, False, KVSM, group_config(3, 1))
        assert wait_for(lambda: nh2.get_leader_id(3)[1], timeout=45)
        assert wait_for(
            lambda: nh2.stale_read(3, "k4") == "4", timeout=30
        )
    finally:
        nh2.stop()


def test_leader_transfer(mode):
    reg = _Registry()
    members = {1: "a:1", 2: "b:2", 3: "c:3"}
    nhs = {nid: mk_nodehost(addr, reg, mode=mode) for nid, addr in members.items()}
    try:
        for nid, nh in nhs.items():
            nh.start_cluster(members, False, KVSM, group_config(11, nid))
        def current_leader():
            for nid, nh in nhs.items():
                lid, ok = nh.get_leader_id(11)
                if ok and lid == nid:
                    return nid
            return None

        assert wait_for(lambda: current_leader() is not None, timeout=45)
        old = current_leader()
        target = next(n for n in (1, 2, 3) if n != old)
        nhs[old].request_leader_transfer(11, target)
        assert wait_for(lambda: current_leader() == target, timeout=45)
    finally:
        for nh in nhs.values():
            nh.stop()


def test_shared_core_refuses_another_device(monkeypatch):
    """Hosts of one share_scope share one core, whose state lives on one
    device: a host naming another device is refused, as a host with
    another engine shape is."""
    import dragonboat_tpu_torch.engine.vector as V

    reg = _Registry()
    cfg = lambda addr, device: NodeHostConfig(
        deployment_id=1, rtt_millisecond=RTT_MS, raft_address=addr,
        raft_rpc_factory=lambda listen: loopback_factory(listen, reg),
        engine=EngineConfig(kind="vector", max_groups=8, max_peers=4,
                            log_window=64, device=device,
                            share_scope=f"dev-{id(reg)}"))
    nh = NodeHost(cfg("a:1", "cpu"))
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(1, 1))
        # name the card without touching one: the refusal comes first
        monkeypatch.setattr(V, "_engine_device",
                            lambda name: torch.device(name.split(":")[0], 0)
                            if name != "cpu" else torch.device("cpu"))
        with pytest.raises(ValueError, match="device"):
            NodeHost(cfg("b:2", "cuda"))
        assert nh.sync_propose(nh.get_noop_session(1), b"k=v", timeout_s=20.0).value == 1
    finally:
        nh.stop()
