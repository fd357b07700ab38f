"""Load-aware placement + live migration (serving/placement.py).

The placement plane of the PyTorch port folds the saturation score,
the per-lane gauges and the per-tenant serving histograms into a load
model, plans which hot groups leave a saturated host, and executes live
migration = member swap over leadership transfer + the streamed
(resume-capable) snapshot install path — admission-aware, abortable
with the typed retry-hinted ErrMigrationAborted, fully off the engine
step loop.

The e2e here is the acceptance scenario: under seeded
hot-tenant load, a saturated group live-migrates to a cold host with
zero urgent-class sheds, a lincheck-clean client history, and dedup
holding across the move (no op applied twice, no admitted op lost).

Run alone with `-m serving`.
"""
import json
import threading
import time

import pytest
import torch

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.lincheck import HistoryRecorder, check_kv_history
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.requests import ErrMigrationAborted
from dragonboat_tpu_torch.serving import (
    MIGRATION_TENANT,
    MigrationTarget,
    PlacementConfig,
    SessionManager,
    host_target,
)
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

pytestmark = pytest.mark.serving

CLUSTER = 400
HOSTS = (1, 2, 3)
TARGET_HOST = 4


class CountKV(IStateMachine):
    """KV + per-key apply counts + a global apply sequence — the no-op-
    applied-twice / no-op-lost measuring instrument."""

    def __init__(self, cluster_id=0, node_id=0):
        self.d = {}
        self.counts = {}
        self.seq = 0

    def update(self, cmd: bytes) -> Result:
        k, v = cmd.decode().split("=", 1)
        self.seq += 1
        self.d[k] = v
        self.counts[k] = self.counts.get(k, 0) + 1
        return Result(value=self.seq)

    def lookup(self, q):
        if q == ("counts",):
            return dict(self.counts)
        if q == ("data",):
            return dict(self.d)
        return self.d.get(q)

    def get_hash(self):
        import zlib

        return zlib.crc32(
            json.dumps(sorted(self.d.items())).encode()
        )

    def save_snapshot(self, w, files, done):
        w.write(json.dumps([self.d, self.counts, self.seq]).encode())

    def recover_from_snapshot(self, r, files, done):
        self.d, self.counts, self.seq = json.loads(r.read().decode())


@pytest.fixture(autouse=True)
def one_thread():
    # the plain step is thousands of tiny ops: torch's intra-op pool only
    # adds overhead at these widths, and several engines share the process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the vector engine ticks every 50 ms, as the reference's twin does (the
# scalar engine keeps the reference's 2-5 ms); the election timeout stays
# 10 ticks
VECTOR_RTT_MS = 50

def mk_host(nid, registry, engine_kind="vector", rtt_ms=5):
    return NodeHost(
        NodeHostConfig(
            deployment_id=14,
            rtt_millisecond=VECTOR_RTT_MS if engine_kind == "vector" else rtt_ms,
            raft_address=f"p{nid}:1",
            raft_rpc_factory=lambda listen: loopback_factory(
                listen, registry
            ),
            engine=EngineConfig(
                kind=engine_kind, max_groups=32, max_peers=4, log_window=64, device="cpu",
            ),
        )
    )


def group_config(cluster_id, node_id, **kw):
    base = dict(
        cluster_id=cluster_id,
        node_id=node_id,
        election_rtt=10,
        heartbeat_rtt=2,
    )
    base.update(kw)
    return Config(**base)


def wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def leader_of(hosts, cluster=CLUSTER):
    for n, nh in hosts.items():
        if nh is None or not nh.has_node(cluster):
            continue
        try:
            lid, ok = nh.get_leader_id(cluster)
        except Exception:
            continue
        if ok:
            return lid
    return 0


def host_of_node(hosts, node_id):
    for n, nh in hosts.items():
        if nh is None or not nh.has_node(CLUSTER):
            continue
        try:
            if nh.local_node_id(CLUSTER) == node_id:
                return n
        except Exception:
            continue
    return None


# ---------------------------------------------------------------------------
# load model + planning
# ---------------------------------------------------------------------------


def test_load_model_folds_score_lanes_and_tenants():
    reg = _Registry()
    nh = mk_host(1, reg, "vector")
    try:
        nh.start_cluster(
            {1: "p1:1"}, False, CountKV, group_config(CLUSTER, 1)
        )
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        # real traffic so lanes show ingest and the tenant histogram fills
        assert front.sync_propose(5, CLUSTER, b"a=1", 20.0) is not None
        plane = nh.placement_plane(targets=[])
        m0 = plane.load_model()
        assert CLUSTER in m0["groups"]
        g = m0["groups"][CLUSTER]
        assert set(g) == {"ingest_rate", "commit_gap", "heat"}
        # the tenant's bulk p99 reached the fold
        assert 5 in m0["tenant_p99_s"]
        assert m0["worst_tenant_p99_s"] > 0
        # score rides the front's monitor (override drills included)
        front.monitor.set_override(0.77)
        assert plane.load_model()["score"] == pytest.approx(0.77)
        # a second fold's ingest is a DELTA, not the absolute index
        front.sync_propose(5, CLUSTER, b"a=2", 20.0)
        m1 = plane.load_model()
        assert m1["groups"][CLUSTER]["ingest_rate"] >= 0
    finally:
        nh.stop()


def test_plan_triggers_on_saturation_and_respects_headroom():
    reg = _Registry()
    nh = mk_host(1, reg, "vector")
    try:
        nh.start_cluster(
            {1: "p1:1"}, False, CountKV, group_config(CLUSTER, 1)
        )
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        cold = MigrationTarget(
            address="cold:1",
            start_replica=lambda c, n: None,
            applied_index=lambda c: 0,
            load=lambda: 0.0,
        )
        hot = MigrationTarget(
            address="hot:1",
            start_replica=lambda c, n: None,
            applied_index=lambda c: 0,
            load=lambda: 0.9,
        )
        plane = nh.placement_plane(targets=[hot, cold])
        # below the trigger: no plans
        front.monitor.set_override(0.1)
        assert plane.plan() == []
        # above it: ONE plan, routed to the COLD target, fresh node id
        front.monitor.set_override(0.8)
        plans = plane.plan()
        assert len(plans) == 1
        p = plans[0]
        assert p.cluster_id == CLUSTER
        assert p.target is cold  # the hot target has no headroom
        assert p.local_node_id == 1
        assert p.new_node_id == 2  # past the membership's max id
        assert "score=0.80" in p.reason
    finally:
        nh.stop()


def test_abort_is_typed_and_retry_hinted():
    reg = _Registry()
    nh = mk_host(1, reg, "scalar")
    try:
        nh.start_cluster(
            {1: "p1:1"}, False, CountKV, group_config(CLUSTER, 1)
        )
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        front.monitor.set_override(0.8)
        target = MigrationTarget(
            address="t:1",
            start_replica=lambda c, n: None,
            applied_index=lambda c: 0,
        )
        plane = nh.placement_plane(targets=[target])
        plane.abort()
        plans = plane.plan(force=True)
        assert plans
        with pytest.raises(ErrMigrationAborted) as ei:
            plane.execute(plans[0])
        assert ei.value.retry_after_s > 0
        assert "operator abort" in ei.value.reason
        c = plane.counters()
        assert c["migrations_started"] == 1
        assert c["migrations_aborted"] == 1
        assert c["migrations_completed"] == 0
        assert not nh.is_migrating(CLUSTER)  # tag cleaned up on abort
        # resume() re-arms the plane
        plane.resume()
        assert plane.plan(force=True)
    finally:
        nh.stop()


def test_admission_shed_aborts_migration_with_hint():
    """Migration traffic rides the BULK class of the reserved tenant:
    past the hard shed line it is refused like any bulk op, and the
    migration aborts with the shed's own retry hint — urgent traffic
    never had a competitor."""
    reg = _Registry()
    nh = mk_host(1, reg, "scalar")
    try:
        nh.start_cluster(
            {1: "p1:1"}, False, CountKV, group_config(CLUSTER, 1)
        )
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        front.monitor.set_override(0.95)  # past shed_bulk_at
        target = MigrationTarget(
            address="t:1",
            start_replica=lambda c, n: None,
            applied_index=lambda c: 0,
        )
        plane = nh.placement_plane(targets=[target])
        plans = plane.plan(force=True)
        assert plans
        with pytest.raises(ErrMigrationAborted) as ei:
            plane.execute(plans[0])
        assert "admission shed" in ei.value.reason
        assert ei.value.retry_after_s > 0
        # the shed landed on the migration tenant's bulk ledger
        c = front.admission.counters()[MIGRATION_TENANT]
        assert c["shed"]["bulk"] >= 1
        # urgent admission was never involved
        assert c["shed"]["urgent"] == 0
    finally:
        nh.stop()


# ---------------------------------------------------------------------------
# the acceptance e2e: live migration under seeded hot-tenant load
# ---------------------------------------------------------------------------


def test_live_migration_under_hot_tenant_load():
    """Under hot-tenant load against a (score-forced) saturated host,
    the plane live-migrates the group to the cold target host via
    add-member -> streamed snapshot catch-up -> leadership transfer ->
    member removal, with:

      * zero urgent-class sheds anywhere (the no-starvation verdict),
      * a linearizable client history across the move,
      * dedup holding: the session-lane op applies exactly once even
        when retried across the migration, and no admitted op is lost,
      * the install stream counted as a MIGRATION stream on the target
        (transport/chunks tagging).
    """
    reg = _Registry()
    hosts = {
        n: mk_host(n, reg, "vector") for n in HOSTS + (TARGET_HOST,)
    }
    members = {n: f"p{n}:1" for n in HOSTS}
    rec = HistoryRecorder()
    stop = threading.Event()
    seq = [0]
    seq_mu = threading.Lock()

    def sm_factory(c, n):
        return CountKV(c, n)

    def client_main(client_id):
        import random

        rng = random.Random(1000 + client_id)
        while not stop.is_set():
            lid = leader_of(hosts)
            hn = host_of_node(hosts, lid)
            if hn is None:
                time.sleep(0.05)
                continue
            front = hosts[hn].serving_front()
            key = f"k{rng.randrange(3)}"
            if rng.random() < 0.7:
                with seq_mu:
                    seq[0] += 1
                    val = f"v{seq[0]}"
                op = rec.invoke(client_id, ("put", key, val))
                try:
                    front.sync_propose(
                        9, CLUSTER, f"{key}={val}".encode(), 5.0
                    )
                    rec.complete(op, None)
                except Exception:
                    rec.unknown(op)
            else:
                # urgent linearizable reads ride THROUGH the migration:
                # the history's lost-write detector AND the traffic the
                # zero-urgent-shed verdict protects
                op = rec.invoke(client_id, ("get", key))
                try:
                    v = front.sync_read(9, CLUSTER, key, 5.0)
                    rec.complete(op, v)
                except Exception:
                    rec.fail(op)  # reads have no side effect
            time.sleep(rng.random() * 0.01)

    try:
        for n in HOSTS:
            hosts[n].start_cluster(
                members, False, sm_factory,
                group_config(
                    CLUSTER, n, snapshot_entries=20, compaction_overhead=5
                ),
            )
        assert wait_for(lambda: leader_of(hosts) != 0)
        lid = leader_of(hosts)
        src = host_of_node(hosts, lid)
        src_nh = hosts[src]
        front = src_nh.serving_front()
        # --- session lane: register + one unacknowledged apply (the
        # dedup-across-the-move probe)
        mgr = SessionManager(front)
        assert mgr.register(7, CLUSTER, count=1, timeout_s=30.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            t = front.propose_session(7, CLUSTER, sess, b"dedup=1", 30.0)
            r = t.wait()
            assert r.completed
            first_val = r.result.value
            # --- hot-tenant load + compaction past the joiner's index
            clients = [
                threading.Thread(target=client_main, args=(i,), daemon=True)
                for i in range(2)
            ]
            for c in clients:
                c.start()
            # let the log grow past snapshot_entries, then compact
            deadline = time.monotonic() + 30
            while (
                src_nh.get_applied_index(CLUSTER) < 30
                and time.monotonic() < deadline
            ):
                time.sleep(0.1)
            try:
                src_nh.sync_request_snapshot(CLUSTER, timeout_s=20.0)
            except Exception:
                pass  # periodic snapshot may already cover it
            # --- placement: source is "saturated", target is cold
            front.monitor.set_override(0.8)
            target = host_target(
                hosts[TARGET_HOST], sm_factory,
                lambda c, n: group_config(c, n),
            )
            plane = src_nh.placement_plane(
                targets=[target],
                config=PlacementConfig(
                    rebalance_at=0.6,
                    catchup_timeout_s=90.0,
                    transfer_timeout_s=60.0,
                ),
            )
            done = plane.rebalance_once()
            assert len(done) == 1, "migration did not complete"
            stop.set()
            for c in clients:
                c.join(timeout=5)
            # --- the swap really happened (membership is applied state:
            # the freshly-joined member's SM view converges, not flips)
            assert not src_nh.has_node(CLUSTER)
            assert hosts[TARGET_HOST].has_node(CLUSTER)

            def swapped():
                # the LEADER's applied membership is the authoritative
                # post-swap view (the fresh joiner's SM may still be
                # replaying the config-change entries)
                cur = leader_of(hosts)
                hn = host_of_node(hosts, cur)
                if hn is None:
                    return False
                try:
                    m = hosts[hn].get_cluster_membership(CLUSTER)
                except Exception:
                    return False
                return (
                    done[0].new_node_id in m.addresses
                    and lid not in m.addresses
                )

            assert wait_for(swapped, timeout=30), "membership never swapped"
            c = plane.counters()
            assert c["migrations_completed"] == 1
            assert c["migrations_aborted"] == 0
            # the install stream was tagged migration on the target
            assert (
                hosts[TARGET_HOST]._chunks.stats()["migration_streams"] >= 1
            ), hosts[TARGET_HOST]._chunks.stats()
            # migration tags are cleaned up
            assert not src_nh.is_migrating(CLUSTER)
            assert not hosts[TARGET_HOST].is_migrating(CLUSTER)
            # --- zero urgent sheds anywhere
            for nh in hosts.values():
                f = getattr(nh, "_serving", None)
                if f is None:
                    continue
                for tid, counters in f.admission.counters().items():
                    assert counters["shed"]["urgent"] == 0, (
                        tid, counters,
                    )
            # --- dedup holds ACROSS the move: retry the unacknowledged
            # series through the migrated topology
            new_lid = leader_of(hosts)
            new_hn = host_of_node(hosts, new_lid)
            mgr2 = SessionManager(hosts[new_hn].serving_front())
            mgr2.adopt(7, CLUSTER, sess)
            t2 = hosts[new_hn].serving_front().propose_session(
                7, CLUSTER, sess, b"dedup=1", 30.0
            )
            r2 = t2.wait()
            assert r2.completed
            assert r2.result.value == first_val, "retry re-applied"
        # --- convergence + no-op-applied-twice / no-op-lost
        live = [
            nh for nh in hosts.values() if nh.has_node(CLUSTER)
        ]
        assert len(live) == 3
        # one final write forces commit-index convergence across the
        # post-swap membership (the longhaul _verify idiom)
        final_deadline = time.monotonic() + 30
        while time.monotonic() < final_deadline:
            cur = leader_of(hosts)
            hn = host_of_node(hosts, cur)
            if hn is None:
                time.sleep(0.2)
                continue
            try:
                hosts[hn].sync_propose(
                    hosts[hn].get_noop_session(CLUSTER), b"final=done", 5.0
                )
                break
            except Exception:
                time.sleep(0.2)
        assert wait_for(
            lambda: len(
                {nh.get_applied_index(CLUSTER) for nh in live}
            ) == 1,
            timeout=60,
        ), "applied index never converged after the move"
        counts = live[0].stale_read(CLUSTER, ("counts",))
        assert counts.get("dedup") == 1, counts
        # every COMPLETED put applied (no admitted op lost) and nothing
        # applied more often than the client asked (the only slack is
        # ops whose outcome the client never learned)
        history = rec.history()
        puts = [
            o for o in history
            if isinstance(o.input, tuple) and o.input[0] == "put"
        ]
        n_completed = sum(1 for o in puts if o.completed)
        n_unknown = len(puts) - n_completed
        total_applied = sum(
            v for k, v in counts.items() if k.startswith("k")
        )
        assert n_completed <= total_applied <= n_completed + n_unknown, (
            n_completed, total_applied, n_unknown,
        )
        # mixed put/get history stays linearizable ACROSS the move
        assert check_kv_history(history, max_states=5_000_000), (
            "client history not linearizable across the migration"
        )
    finally:
        stop.set()
        for nh in hosts.values():
            try:
                nh.stop()
            except Exception:
                pass


@pytest.mark.parametrize("deposed", [False, True])
def test_forwarded_removal_in_a_deposing_step_matches_jax(deposed):
    """How a live migration loses its member removal when the group
    re-elects, held equal in both packages' plain steps: a forwarded
    config change reaches the leader's lane in the same step as a
    heartbeat of a higher term. The leader steps down first, so the entry
    is not appended (prop_base 0) and not reported as stripped
    (dropped_cc stays False); the proposer sits on another host, so
    nothing answers it and its request times out. Without the heartbeat
    the entry is appended."""
    import jax.numpy as jnp
    import numpy as np

    from dragonboat_tpu.ops import state as J
    from dragonboat_tpu.ops.kernel import make_step_fn
    from dragonboat_tpu_torch.ops import kernel as K
    from dragonboat_tpu_torch.ops import state as T
    from dragonboat_tpu_torch.ops.convert import state_from_numpy
    from dragonboat_tpu_torch.ops.loopback import LoopbackCluster

    shape = dict(groups=4, peers=4, log_window=32, inbox_depth=4,
                 max_entries_per_msg=8, readindex_depth=4)
    cfg = T.KernelConfig(**shape)
    c = LoopbackCluster(n_replicas=3, n_groups=4, cfg=cfg, election=10, heartbeat=2,
                        check_quorum=True, device="cpu")
    for _ in range(120):
        c.run(1)
        roles = np.stack([st.role.numpy() for st in c.states])
        if ((roles == T.ROLE.LEADER).sum(0) == 1).all():
            break
    h = int((roles[:, 0] == T.ROLE.LEADER).argmax())
    st = {f: getattr(c.states[h], f).numpy().copy() for f in T.RaftTensors._fields}
    ib = {f: getattr(T.make_empty_inbox(cfg, device="cpu"), f).numpy().copy()
          for f in T.Inbox._fields}
    me = int(st["self_slot"][0])
    if deposed:
        ib["mtype"][0, 0] = T.MSG.HEARTBEAT
        ib["from_slot"][0, 0] = (me + 1) % 3
        ib["term"][0, 0] = st["term"][0] + 1
    # the forwarded removal, as the engine packs it: a lone one-entry
    # PROPOSE from the leader's own slot with the entry's cc bit set
    ib["mtype"][0, 1] = T.MSG.PROPOSE
    ib["from_slot"][0, 1] = me
    ib["n_entries"][0, 1] = 1
    ib["entry_cc"][0, 1, 0] = True
    ticks = np.zeros(4, np.int32)
    ts, to = K.step_batch(state_from_numpy(st, device="cpu"),
                          state_from_numpy(ib, device="cpu"), torch.from_numpy(ticks), cfg)
    js, jo = make_step_fn(J.KernelConfig(**shape), donate=False)(
        J.RaftTensors(**{k: jnp.asarray(v) for k, v in st.items()}),
        J.Inbox(**{k: jnp.asarray(v) for k, v in ib.items()}), jnp.asarray(ticks))
    for jt, tt in ((js, ts), (jo, to)):
        for f in jt._fields:
            assert np.array_equal(np.asarray(getattr(jt, f)), getattr(tt, f).numpy()), f
    assert not bool(to.dropped_cc[0])
    if deposed:
        assert int(ts.role[0]) == T.ROLE.FOLLOWER
        assert int(to.prop_base[0, 1]) == 0
    else:
        assert int(ts.role[0]) == T.ROLE.LEADER
        assert int(to.prop_base[0, 1]) == int(st["last_index"][0]) + 1
