"""A stopped vector engine gives back every tensor it allocated.

Each case builds NodeHosts on the port's vector engine (`device="cpu"`),
starts a few groups, commits a proposal, then stops (or crashes) every
host. Before the stop it takes weak references to the engine core and to
every tensor the core reaches through its attributes: each shard's state
tree and residual inbox, its device input and output planes, and the host
staging buffers (pinned on the card). Right after the last host's stop,
with the cycle collector off, every one of those tensors must be dead:
on the card a stopped core's device memory is given back by reference
counting, not whenever a full collection happens to run (ROADMAP §3 fault
13: a stopped NodeHost's engine kept its device memory until then). After
`gc.collect()` the core itself is dead and no shared core is registered.

The cases, one parametrised test: a sole-tenant K=1 engine; a core shared
by three NodeHosts at K=8, stopped one by one (the core and its tensors
live until the last host stops); the crash path (`NodeHost.crash`,
`release(flush=False)`); an engine over 8 logical CPU shards."""
import gc
import time
import weakref

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.engine import vector as V
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

GROUPS = 3
RTT_MS = 50


class Counter(IStateMachine):
    def __init__(self, *a):
        self.n = 0

    def update(self, data):
        self.n += 1
        return Result(value=self.n)

    def lookup(self, q):
        return self.n

    def save_snapshot(self, w, fc, done):
        w.write(self.n.to_bytes(8, "little"))

    def recover_from_snapshot(self, r, fc, done):
        self.n = int.from_bytes(r.read(), "little")

    def close(self):
        pass


def engine_tensors(core):
    """name -> tensor for every tensor the core reaches through its
    attributes, its shards' and its staging objects' (lists, tuples,
    dicts, NamedTuples), and numpy views of tensor bytes under their
    tensor's name."""
    found = {}
    seen = set()

    def walk(obj, name, depth):
        if id(obj) in seen or depth > 6:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            found[name] = obj
        elif isinstance(obj, (list, tuple)):
            fields = getattr(obj, "_fields", None)
            for i, x in enumerate(obj):
                walk(x, f"{name}.{fields[i] if fields else i}", depth + 1)
        elif isinstance(obj, dict):
            for k, x in obj.items():
                walk(x, f"{name}[{k!r}]", depth + 1)
        elif isinstance(obj, (V._Shard, V._Planes)):
            for k, x in vars(obj).items():
                walk(x, f"{name}.{k}", depth + 1)

    for k, x in vars(core).items():
        walk(x, k, 0)
    walk = None  # the recursive closure is a cycle that would keep `found`
    return found


def hosts_for(case, tmp_path):
    reg = _Registry()
    n = 3 if case == "shared_k8" else 1
    addrs = {i: f"td{i}:1" for i in range(1, n + 1)}
    hosts = {}
    for i in addrs:
        hosts[i] = NodeHost(NodeHostConfig(
            deployment_id=17, rtt_millisecond=RTT_MS, raft_address=addrs[i],
            nodehost_dir=str(tmp_path / f"nh{i}"),
            raft_rpc_factory=lambda l: loopback_factory(l, reg),
            engine=EngineConfig(
                kind="vector", max_groups=16, max_peers=4, log_window=32, device="cpu",
                steps_per_sync=8 if case == "shared_k8" else 1,
                share_scope=f"teardown-{case}" if case == "shared_k8" else None,
                shard_over_mesh=case == "mesh8")))
    for i, nh in hosts.items():
        for c in range(1, GROUPS + 1):
            nh.start_cluster(addrs, False, lambda c, nid: Counter(),
                             Config(cluster_id=c, node_id=i, election_rtt=10, heartbeat_rtt=2))
    return hosts


def commit_one(hosts):
    deadline = time.time() + 60
    while time.time() < deadline:
        leaders = {c: hosts[1].get_leader_id(c) for c in range(1, GROUPS + 1)}
        if all(ok for _lid, ok in leaders.values()):
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"not every group elected: {leaders}")
    nh = hosts[leaders[1][0]]
    assert nh.sync_propose(nh.get_noop_session(1), b"x", timeout_s=20.0).value >= 1


@pytest.mark.parametrize("case", ["sole_k1", "shared_k8", "crash", "mesh8"])
def test_stop_frees_every_engine_tensor(case, tmp_path, monkeypatch):
    if case == "mesh8":
        monkeypatch.setattr(V, "mesh_devices", lambda device: (torch.device("cpu"),) * 8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.disable()
    try:
        hosts = hosts_for(case, tmp_path)
        commit_one(hosts)
        core = hosts[1].engine.core
        if case == "mesh8":
            assert len(core._shards) == 8
        refs = {k: weakref.ref(t) for k, t in engine_tensors(core).items()}
        core_ref = weakref.ref(core)
        del core
        assert [k for k in refs if ".state." in k] and [k for k in refs if "dev_in" in k]
        order = sorted(hosts)
        for i in order:
            (hosts[i].crash if case == "crash" else hosts[i].stop)()
            if i != order[-1]:
                # a shared core outlives every host but the last
                # (its CPU super-step returns fresh state trees each call)
                assert core_ref() is not None and core_ref() in V._shared_cores.values()
                assert core_ref()._shards[0].state is not None
        del hosts
        alive = sorted(k for k, r in refs.items() if r() is not None)
    finally:
        gc.enable()
        torch.set_num_threads(threads)
    assert not alive, f"{len(alive)} of {len(refs)} engine tensors alive after the stop: {alive[:12]}"
    gc.collect()
    assert core_ref() is None, "the stopped engine core is still reachable"
    assert not V._shared_cores


def test_engine_tensors_walk_finds_the_planes():
    """engine_tensors names a shard's planes and numpy staging alike."""
    class Core:
        pass

    core = Core()
    sh = V._Shard(torch.device("cpu"), 0, 4, None, True)
    sh.dev_in = V._Planes([("a", (4,), torch.int32)], "cpu")
    sh.state = V.Inbox(*[torch.zeros(1)] * len(V.Inbox._fields))
    core._shards = [sh]
    core._np = np.zeros(2)
    found = engine_tensors(core)
    assert "_shards.0.dev_in.bytes" in found and "_shards.0.state.mtype" in found
