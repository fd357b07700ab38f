"""The port's sharded engine (`EngineConfig.shard_over_mesh`) on the CPU,
over 8 logical shards named through `engine.vector.mesh_devices` (the
counterpart of the conftest's 8 virtual JAX devices):

- the twins of tests/test_vector_mesh.py: three replicas commit with the
  state spread over 8 shard trees; the K>1 shared core rounds its lanes
  up to a mesh multiple (stamped, ghost lanes never allocated), routes
  co-hosted traffic on the device (zero host Message objects), survives a
  live lane add and remove, with 0 out-of-seam syncs and 0 builds;
- one seeded script through the JAX package's sharded engine and the
  port's, with the same KV on every replica and the same lincheck,
  convergence and Log Matching verdicts;
- the plain per-destination gather against the all-destination stack and
  `lax.all_gather`."""
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import dragonboat_tpu_torch.engine.vector as V
from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.requests import RequestError
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

N_SHARDS = 8
CPU = torch.device("cpu")


@pytest.fixture
def logical_shards(monkeypatch):
    """Name 8 logical CPU shards for every engine built in the test."""
    monkeypatch.setattr(V, "mesh_devices", lambda device: (CPU,) * N_SHARDS)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield N_SHARDS
    torch.set_num_threads(n)


class KV(IStateMachine):
    def __init__(self, cluster_id, node_id):
        self.d = {}

    def update(self, data):
        k, v = data.decode().split("=", 1)
        self.d[k] = v
        return Result(value=len(self.d))

    def lookup(self, q):
        return self.d.get(q)

    def save_snapshot(self, w, fc, done):
        import json

        w.write(json.dumps(self.d).encode())

    def recover_from_snapshot(self, r, fc, done):
        import json

        self.d = json.loads(r.read().decode())

    def close(self):
        pass


def wait(pred, timeout=30):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _propose(hosts, c, payload):
    for attempt in range(6):
        lid, ok = hosts[1].get_leader_id(c)
        try:
            if not ok or lid not in hosts:
                raise RequestError("leaderless between waves")
            s = hosts[lid].get_noop_session(c)
            hosts[lid].sync_propose(s, payload, 30.0)
            return
        except RequestError:
            if attempt == 5:
                raise
            time.sleep(1.0)


def _elect(hosts, groups, timeout=150):
    pending = set(groups)
    deadline = time.monotonic() + timeout
    while pending and time.monotonic() < deadline:
        pending -= {c for c in pending if hosts[1].get_leader_id(c)[1]}
        if pending:
            time.sleep(0.1)
    assert not pending, f"{len(pending)} groups leaderless"


def _shards_hold_the_state(core, n):
    assert core._shards is not None and len(core._shards) == n
    Gl = core.kcfg.groups // n
    for i, sh in enumerate(core._shards):
        assert (sh.lo, sh.hi) == (i * Gl, (i + 1) * Gl)
        assert sh.state.term.shape[0] == Gl and sh.state.term.device == CPU
    # every shard's planes are tensors of their own
    ptrs = {sh.state.term.data_ptr() for sh in core._shards}
    assert len(ptrs) == n


def test_sharded_engine_three_replicas_commit(logical_shards):
    n_dev = logical_shards
    groups = 2 * n_dev  # at least two lanes per shard
    reg = _Registry()
    members = {1: "m:1", 2: "m:2", 3: "m:3"}
    hosts = {}
    for nid, addr in members.items():
        hosts[nid] = NodeHost(NodeHostConfig(
            deployment_id=11, rtt_millisecond=50, raft_address=addr,
            raft_rpc_factory=lambda l: loopback_factory(l, reg),
            engine=EngineConfig(
                kind="vector", max_groups=groups, max_peers=4,
                log_window=64, shard_over_mesh=True, device="cpu",
            ),
        ))
    try:
        # the engine state must actually live on the shards
        for nh in hosts.values():
            _shards_hold_the_state(nh.engine, n_dev)
            assert nh.engine.step_stats()["mesh_devices"] == n_dev
        for c in range(1, groups + 1):
            for nid in members:
                hosts[nid].start_cluster(
                    dict(members), False, KV,
                    Config(cluster_id=c, node_id=nid, election_rtt=20,
                           heartbeat_rtt=4),
                )
        _elect(hosts, range(1, groups + 1))
        # one write per group through its leader, quorum-committed across
        # lanes living on different shards
        for c in range(1, groups + 1):
            _propose(hosts, c, f"g{c}=v{c}".encode())
        # linearizable read-back on a follower host for a few groups
        for c in (1, groups // 2, groups):
            lid = hosts[1].get_leader_id(c)[0]
            fid = next(n for n in members if n != lid)
            assert wait(
                lambda c=c, fid=fid: hosts[fid].sync_read(
                    c, f"g{c}", timeout_s=10.0
                ) == f"v{c}",
                timeout=60,
            )
    finally:
        for nh in hosts.values():
            nh.stop()


@pytest.mark.perf
def test_sharded_multistep_engine_padding_and_device_routing(tmp_path, logical_shards):
    """shard_over_mesh composes with steps_per_sync>1 on a shared core:
    the lane round-up is stamped, ghost lanes are never allocated or
    reported, co-hosted cross-shard traffic rides the on-device router
    (zero host Message objects), and a live lane add/remove mid-run stays
    inside the blessed sync seam with zero kernel builds."""
    from dragonboat_tpu_torch.profile import (
        compile_watch, diff_compiles, diff_sync, sync_audit,
    )

    n_dev = logical_shards
    reg = _Registry()
    members = {1: "mk4:1", 2: "mk4:2", 3: "mk4:3"}
    groups = 3       # clusters live at bring-up
    max_groups = 12  # 3 hosts x (3 clusters + 1 live-add slot)
    hosts = {}
    for nid, addr in members.items():
        hosts[nid] = NodeHost(NodeHostConfig(
            deployment_id=11, rtt_millisecond=50, raft_address=addr,
            nodehost_dir=str(tmp_path / f"nh{nid}"),
            raft_rpc_factory=lambda l: loopback_factory(l, reg),
            engine=EngineConfig(
                kind="vector", max_groups=max_groups, max_peers=4,
                log_window=64, shard_over_mesh=True, steps_per_sync=4,
                share_scope=f"mesh-k4-{id(reg)}", device="cpu",
            ),
        ))
    audit = sync_audit()
    audit.install(device="cpu")
    # the audit is one per process: count only what this test's hosts read
    # from here on, not what earlier tests in the worker left in it
    audit_mark = audit.snapshot()
    try:
        core = hosts[1].engine.core
        assert core._multi == 4  # K>1 really composed with the mesh
        padded = -(-max_groups // n_dev) * n_dev
        assert core.kcfg.groups == padded
        assert core._groups_requested == max_groups
        assert len(core._free) == max_groups
        ss = core.step_stats()
        assert ss["mesh_devices"] == n_dev
        assert ss["padded_groups"] == padded - max_groups
        _shards_hold_the_state(core, n_dev)
        for c in range(1, groups + 1):
            for nid in members:
                hosts[nid].start_cluster(
                    dict(members), False, KV,
                    Config(cluster_id=c, node_id=nid, election_rtt=20,
                           heartbeat_rtt=4),
                )
        _elect(hosts, range(1, groups + 1))
        # warm the steady state, including one full lane add/remove cycle
        for c in range(1, groups + 1):
            _propose(hosts, c, f"warm{c}=w".encode())
        for nid in members:
            hosts[nid].start_cluster(
                dict(members), False, KV,
                Config(cluster_id=groups + 1, node_id=nid,
                       election_rtt=20, heartbeat_rtt=4),
            )
        assert wait(lambda: hosts[1].get_leader_id(groups + 1)[1], timeout=120)
        for nid in members:
            hosts[nid].stop_cluster(groups + 1)
        sync_mark = audit.snapshot()
        compile_mark = compile_watch().snapshot()
        stats_mark = core.step_stats()

        for i in range(10):
            _propose(hosts, 1, f"x{i}=v".encode())
        # forwarded linearizable read from a follower host: the routed
        # READ_INDEX / READ_INDEX_RESP round trip crosses shards too
        lid = hosts[1].get_leader_id(1)[0]
        fol = next(n for n in members if n != lid)
        assert wait(
            lambda: hosts[fol].sync_read(1, "x0", timeout_s=10.0) == "v",
            timeout=60,
        )
        # steady state: ZERO host Message objects for co-hosted traffic
        stats_mid = core.step_stats()
        for key in ("msgs_replicate", "msgs_broadcast", "msgs_resp"):
            assert stats_mid[key] == stats_mark[key], (key, stats_mid)
        assert stats_mid["msgs_routed_device"] > stats_mark["msgs_routed_device"]

        # live lane add: a new cluster joins all three hosts mid-run...
        c_new = groups + 2
        for nid in members:
            hosts[nid].start_cluster(
                dict(members), False, KV,
                Config(cluster_id=c_new, node_id=nid, election_rtt=20,
                       heartbeat_rtt=4),
            )
        assert wait(lambda: hosts[1].get_leader_id(c_new)[1], timeout=120)
        _propose(hosts, c_new, b"live=add")
        # ...and leaves again; the shards keep serving the old lanes
        for nid in members:
            hosts[nid].stop_cluster(c_new)
        _propose(hosts, 1, b"after=remove")

        stats = core.step_stats()
        assert stats["msgs_routed_device"] > stats_mid["msgs_routed_device"]
        d = diff_sync(sync_mark, audit.snapshot())
        assert d["in_seam"] > 0
        # off the seams only the rare membership reconcile of the live add
        # reads the device, by design (e2e.RARE_PATH_SYNCS; the reference's
        # audit does not see its np.asarray reads there)
        from dragonboat_tpu_torch.e2e import RARE_PATH_SYNCS

        bad = {s: k for s, k in diff_sync(audit_mark, audit.snapshot())["sites"].items()
               if s.startswith("dragonboat_tpu_torch/") and not s.endswith(RARE_PATH_SYNCS)}
        assert not bad, bad
        dc = diff_compiles(compile_mark, compile_watch().snapshot())
        assert not dc["per_function"], dc
        # lane_stats reports only REAL lanes: padding never leaks ghosts
        # and cluster c_new's lanes were freed on stop
        assert len(core.lane_stats()) <= 3 * groups
        assert all(lane.g < max_groups for lane in core._lanes.values())
    finally:
        audit.uninstall()
        for nh in hosts.values():
            nh.stop()


# ------------------------------------------------- one script, both packages

SCRIPT_GROUPS, SCRIPT_PROPOSALS, SCRIPT_KEYS = 4, 12, 3


def run_mesh_script(pkg, tmp_path):
    """3 hosts on one shared K=4 core sharded over 8 devices (the JAX
    package: the conftest's virtual devices; the port: 8 logical CPU
    shards), 4 groups, one client per group writing its keys with a
    linearizable read after every third write. Returns each replica's KV,
    the history and each group's Log Matching report."""
    C = importlib.import_module(pkg + ".config")
    NH = importlib.import_module(pkg + ".nodehost")
    SM = importlib.import_module(pkg + ".statemachine")
    LB = importlib.import_module(pkg + ".transport.loopback")
    L = importlib.import_module(pkg + ".lincheck")
    LC = importlib.import_module(pkg + ".tools.logdbcheck")
    replicas = []

    class Store(SM.IStateMachine):
        def __init__(self, cluster_id, node_id):
            self.cluster_id, self.node_id, self.data = cluster_id, node_id, {}
            replicas.append(self)

        def update(self, cmd):
            k, v = cmd.decode().split("=", 1)
            self.data[k] = v
            return SM.Result(value=len(self.data))

        def lookup(self, q):
            return self.data.get(q)

        def save_snapshot(self, w, files, done):
            pass

        def recover_from_snapshot(self, r, files, done):
            pass

    reg = LB._Registry()
    members = {n: f"ms:{n}" for n in (1, 2, 3)}
    kw = dict(kind="vector", max_groups=3 * SCRIPT_GROUPS, max_peers=4, log_window=64,
              shard_over_mesh=True, steps_per_sync=4, share_scope=f"ms-{pkg}-{id(reg)}")
    if pkg == "dragonboat_tpu_torch":
        kw["device"] = "cpu"
    hosts = {
        nid: NH.NodeHost(C.NodeHostConfig(
            deployment_id=3, rtt_millisecond=50, raft_address=addr,
            nodehost_dir=str(tmp_path / pkg / f"nh{nid}"),
            raft_rpc_factory=lambda listen: LB.loopback_factory(listen, reg),
            engine=C.EngineConfig(**kw)))
        for nid, addr in members.items()
    }
    rec = L.HistoryRecorder()
    try:
        assert hosts[1].engine.step_stats()["mesh_devices"] == 8
        for nid, nh in hosts.items():
            nh.start_clusters([
                (dict(members), False, Store,
                 C.Config(cluster_id=c, node_id=nid, election_rtt=20, heartbeat_rtt=4))
                for c in range(1, SCRIPT_GROUPS + 1)])

        def leader(c):
            for nid, nh in hosts.items():
                lid, ok = nh.get_leader_id(c)
                if ok and lid == nid:
                    return nh
            return None

        deadline = time.monotonic() + 120
        while any(leader(c) is None for c in range(1, SCRIPT_GROUPS + 1)):
            assert time.monotonic() < deadline, "groups never elected"
            time.sleep(0.05)
        errors = []

        def client(c):
            for j in range(SCRIPT_PROPOSALS):
                k, v = f"k{j % SCRIPT_KEYS}", str(j)
                for _attempt in range(40):
                    nh = leader(c) or hosts[1]
                    op = rec.invoke(c, ("put", f"g{c}{k}", v))
                    try:
                        nh.sync_propose(nh.get_noop_session(c), f"{k}={v}".encode(),
                                        timeout_s=10.0)
                    except Exception:
                        rec.unknown(op)
                        time.sleep(0.05)
                        continue
                    rec.complete(op, None)
                    break
                else:
                    errors.append((c, j))
                if j % 3 == 2:
                    nh = leader(c) or hosts[1]
                    op = rec.invoke(c, ("get", f"g{c}{k}"))
                    try:
                        rec.complete(op, nh.sync_read(c, k, timeout_s=10.0))
                    except Exception:
                        rec.fail(op)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(1, SCRIPT_GROUPS + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        want = {f"k{k}": str(max(j for j in range(SCRIPT_PROPOSALS) if j % SCRIPT_KEYS == k))
                for k in range(SCRIPT_KEYS)}
        deadline = time.monotonic() + 30
        while True:
            by_group = {}
            for sm in replicas:
                if sm.data:
                    by_group.setdefault(sm.cluster_id, {})[sm.node_id] = dict(sm.data)
            done = (len(by_group) == SCRIPT_GROUPS
                    and all(len(v) == 3 and all(d == want for d in v.values())
                            for v in by_group.values()))
            if done or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        stats = hosts[1].engine.step_stats()
        logs = {c: LC.check_logdb_consistency({nid: hosts[nid].logdb for nid in members}, c)
                for c in range(1, SCRIPT_GROUPS + 1)}
        return dict(kv=dict(sorted(by_group.items())), hist=rec.history(), want=want,
                    log_ok={c: r.ok for c, r in logs.items()},
                    violations={c: r.violations for c, r in logs.items()},
                    routed=stats["msgs_routed_device"], padded=stats["padded_groups"])
    finally:
        for nh in hosts.values():
            nh.stop()


def test_mesh_script_same_verdicts_in_both_packages(tmp_path, logical_shards):
    from dragonboat_tpu.lincheck import check_kv_history
    from dragonboat_tpu_torch.lincheck import check_kv_history as port_check

    assert jax.device_count() == 8  # the conftest's virtual devices
    ref, port = (run_mesh_script(pkg, tmp_path)
                 for pkg in ("dragonboat_tpu", "dragonboat_tpu_torch"))
    for r in (ref, port):
        # convergence: every group on all three replicas holds the script's KV
        assert sorted(r["kv"]) == list(range(1, SCRIPT_GROUPS + 1))
        for c, by_node in r["kv"].items():
            assert sorted(by_node) == [1, 2, 3], c
            assert all(d == r["want"] for d in by_node.values()), c
        # Log Matching below the common commit point, every group
        assert all(r["log_ok"].values()), r["violations"]
        assert r["routed"] > 0  # co-hosted traffic rode the device router
        assert r["padded"] == 4  # 12 lanes round up to 16 over 8 shards
    assert port["kv"] == ref["kv"]
    assert port["log_ok"] == ref["log_ok"]
    assert check_kv_history(ref["hist"]) and port_check(ref["hist"])
    assert check_kv_history(port["hist"]) and port_check(port["hist"])


# ------------------------------------------------------ the plain gather


@pytest.mark.parametrize("L", [1, 7, 448])
def test_per_destination_gather_matches_stack_and_all_gather(L):
    from jax.experimental.shard_map import shard_map

    n = N_SHARDS
    rng = np.random.default_rng(L)
    x = rng.integers(-2**31, 2**31, size=(n, L), dtype=np.int64).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("groups",))
    fn = shard_map(lambda a: jax.lax.all_gather(a, "groups", axis=0, tiled=False),
                   mesh=mesh, in_specs=PartitionSpec("groups"),
                   out_specs=PartitionSpec("groups"), check_rep=False)
    j = np.asarray(jax.jit(fn)(jnp.asarray(x))).reshape(n, n, 1, L)
    records = [torch.from_numpy(x[i].copy()) for i in range(n)]
    stacks = K.ring_gather_reference(records)
    for d in range(n):
        one = K.gather_for(records, d)
        assert one.dtype == torch.int32 and tuple(one.shape) == (n, L)
        assert torch.equal(one, stacks[d])
        assert one.numpy().tobytes() == j[d].tobytes(), d
    # the wrapper takes the plain version for records on the CPU
    got = K._gather_candidates(records)
    assert all(torch.equal(a, b) for a, b in zip(got, stacks))


def test_e2e_shard_over_mesh_stamps_the_mesh(logical_shards):
    """`e2e --shard-over-mesh` runs the ladder's engines sharded and stamps
    bench.py's `_mesh_report` keys with what the engine did: 3 x 2 lanes
    round up to 8 over the 8 logical shards."""
    from dragonboat_tpu_torch import e2e

    r = e2e.run_ladder_config(2, groups=2, duration=1.5, device="cpu", shard_over_mesh=True)
    assert e2e.gate_failures(r) == []
    assert (r["shard_over_mesh"], r["n_devices"], r["mesh_shape"], r["padded_groups"]) == (
        True, 8, [8], 2)
    # the unsharded run stamps the same keys with one device
    keys = e2e._mesh_report({}, False)
    assert keys == {"shard_over_mesh": False, "n_devices": 1, "mesh_shape": [1],
                    "padded_groups": 0}
