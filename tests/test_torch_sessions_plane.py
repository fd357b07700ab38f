"""The vector-scale session plane (serving/sessions.py) — tier-1 gate.

The PyTorch port's at-most-once sessions multiplexed per tenant over
ServingFront. The contract under test:

  * batched registration/retirement: one wave registers N sessions with
    one urgent admission and one completion pass;
  * end-to-end dedup through the front's session lane: a retried
    proposal that already applied returns the RSM's CACHED result (same
    value, no second apply) — differential-tested across a leader
    change, a crash/restart, and a snapshot-install rejoin (the session
    image rides the replicated snapshot);
  * retry safety: SessionManager.propose re-asks indeterminate outcomes
    under the SAME series id (retry.call_with_retries session
    propagation), and the checked-out session pool sheds typed
    retryable errors when exhausted.

Run alone with `-m serving`.
"""
import json
import time

import pytest
import torch

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.serving import (
    ErrSessionExhausted,
    SessionManager,
)
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

pytestmark = pytest.mark.serving

CLUSTER = 300


class SeqKV(IStateMachine):
    """KV whose every apply gets a globally unique sequence number and
    whose per-op apply counts are queryable: the dedup differential's
    measuring instrument. A deduped retry returns the ORIGINAL seq; a
    double apply would mint a fresh, higher one and bump the count."""

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
        if q == ("count",):
            return dict(self.counts)
        if isinstance(q, tuple) and q[0] == "count":
            return self.counts.get(q[1], 0)
        return self.d.get(q)

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


# the port's CPU step is eager torch ops (a few ms a step, several engines
# in one process): its vector engine ticks every 50 ms here where the
# reference's ticks every 2-5 ms, as in the port's other engine tests; the
# scalar engine keeps the reference's tick
VECTOR_RTT_MS = 50

def mk_host(addr, registry, engine_kind="scalar", rtt_ms=5, **cfg_kw):
    return NodeHost(
        NodeHostConfig(
            deployment_id=14,
            rtt_millisecond=VECTOR_RTT_MS if engine_kind == "vector" else rtt_ms,
            raft_address=addr,
            raft_rpc_factory=lambda listen: loopback_factory(
                listen, registry
            ),
            engine=EngineConfig(
                kind=engine_kind, max_groups=32, max_peers=4, log_window=64, device="cpu",
            ),
            **cfg_kw,
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


def mk_trio(registry, engine_kind, **cfg_kw):
    members = {n: f"s{n}:1" for n in (1, 2, 3)}
    hosts = {
        n: mk_host(f"s{n}:1", registry, engine_kind) for n in (1, 2, 3)
    }
    for n, nh in hosts.items():
        nh.start_cluster(
            members, False, SeqKV, group_config(CLUSTER, n, **cfg_kw)
        )
    return hosts


def leader_of(hosts, cluster=CLUSTER):
    for n, nh in hosts.items():
        lid, ok = nh.get_leader_id(cluster)
        if ok:
            return lid
    return 0


def apply_count(nh, key, cluster=CLUSTER):
    return nh.stale_read(cluster, ("count", key))


def transfer_until(hosts, target, timeout=45.0):
    """Drive leadership onto `target`, re-issuing the (best-effort)
    transfer request until it sticks — the raft TimeoutNow only fires
    once the target's match catches the leader, and an unlucky election
    can land elsewhere first (dragonboat callers observe and retry)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        views = {n: h.get_leader_id(CLUSTER) for n, h in hosts.items()}
        if all(v == (target, True) for v in views.values()):
            return True
        lid = leader_of(hosts)
        if lid and lid != target:
            try:
                hosts[lid].request_leader_transfer(CLUSTER, target)
            except Exception:
                pass  # a pending transfer is still in flight
        time.sleep(0.3)
    return False


@pytest.fixture(params=["scalar", "vector"])
def engine_kind(request):
    return request.param


# ---------------------------------------------------------------------------
# lifecycle: batched register / retire
# ---------------------------------------------------------------------------


def test_batched_register_and_retire(engine_kind):
    reg = _Registry()
    nh = mk_host("a:1", reg, engine_kind)
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        mgr = SessionManager(nh.serving_front())
        n = mgr.register(7, CLUSTER, count=8, timeout_s=20.0)
        assert n == 8
        assert mgr.pool_sizes()[(7, CLUSTER)] == 8
        # the whole wave was ONE urgent admission of 8
        c = nh.serving_front().admission.counters()[7]
        assert c["admitted"]["urgent"] == 8
        st = mgr.stats()
        assert st["registered"] == 8 and st["register_failed"] == 0
        # retirement drains the pool in one wave too
        assert mgr.retire(7, CLUSTER, timeout_s=20.0) == 8
        assert mgr.pool_sizes()[(7, CLUSTER)] == 0
        assert mgr.stats()["retired"] == 8
    finally:
        nh.stop()


def test_propose_at_most_once_happy_path(engine_kind):
    reg = _Registry()
    nh = mk_host("a:1", reg, engine_kind)
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        mgr = SessionManager(nh.serving_front())
        assert mgr.register(7, CLUSTER, count=2, timeout_s=20.0) == 2
        r1 = mgr.propose(7, CLUSTER, b"k=1", 20.0)
        r2 = mgr.propose(7, CLUSTER, b"k=2", 20.0)
        assert r2.value == r1.value + 1  # sequential applies
        assert apply_count(nh, "k") == 2
        assert mgr.stats()["proposals"] == 2
    finally:
        nh.stop()


def test_checkout_exhaustion_is_typed_and_retryable():
    reg = _Registry()
    nh = mk_host("a:1", reg, "scalar")
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        mgr = SessionManager(nh.serving_front())
        assert mgr.register(7, CLUSTER, count=1, timeout_s=20.0) == 1
        with mgr.checkout(7, CLUSTER):
            with pytest.raises(ErrSessionExhausted) as ei:
                with mgr.checkout(7, CLUSTER):
                    pass
            assert ei.value.retry_after_s > 0  # machine-readable hint
        # returned to the pool on exit
        with mgr.checkout(7, CLUSTER):
            pass
    finally:
        nh.stop()


# ---------------------------------------------------------------------------
# the dedup differential: retry-after-apply returns the cached result
# ---------------------------------------------------------------------------


def _propose_no_ack(front, tenant, session, cmd, timeout=20.0):
    """One session-lane proposal WITHOUT acknowledging the session —
    the client-side state after a completed apply whose response was
    lost (the deadline-retry shape retry.py produces)."""
    t = front.propose_session(tenant, CLUSTER, session, cmd, timeout)
    r = t.wait()
    assert r is not None and r.completed, r
    return r.result


def test_dedup_plain_retry_after_apply(engine_kind):
    """The base case: same series re-proposed after a completed apply
    returns the CACHED result — same seq value, apply count stays 1."""
    reg = _Registry()
    nh = mk_host("a:1", reg, engine_kind)
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        mgr = SessionManager(front)
        assert mgr.register(7, CLUSTER, count=1, timeout_s=20.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            first = _propose_no_ack(front, 7, sess, b"x=1")
            again = _propose_no_ack(front, 7, sess, b"x=1")
            assert again.value == first.value  # the cached result
            assert apply_count(nh, "x") == 1  # no second apply
            sess.proposal_completed()
            # the next series applies fresh
            nxt = _propose_no_ack(front, 7, sess, b"x=2")
            assert nxt.value == first.value + 1
            sess.proposal_completed()
        assert apply_count(nh, "x") == 2
    finally:
        nh.stop()


def test_dedup_across_leader_change(engine_kind):
    """Differential: apply through the old leader, lose the ack, retry
    through the NEW leader's front — the replicated session cache
    answers with the original result on every replica."""
    reg = _Registry()
    hosts = mk_trio(reg, engine_kind)
    try:
        assert wait_for(lambda: leader_of(hosts) != 0)
        lid = leader_of(hosts)
        mgr = SessionManager(hosts[lid].serving_front())
        assert mgr.register(7, CLUSTER, count=1, timeout_s=30.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            first = _propose_no_ack(
                hosts[lid].serving_front(), 7, sess, b"m=1", timeout=30.0
            )
            # move leadership to another member
            target = next(n for n in hosts if n != lid)
            hosts[lid].request_leader_transfer(CLUSTER, target)
            assert wait_for(
                lambda: leader_of(hosts) not in (0, lid), timeout=30
            ), "leadership never moved"
            new_lid = leader_of(hosts)
            # adopt the same session on the new leader's host (failover:
            # the dedup state is replicated, not host-local)
            mgr2 = SessionManager(hosts[new_lid].serving_front())
            mgr2.adopt(7, CLUSTER, sess)
            again = _propose_no_ack(
                hosts[new_lid].serving_front(), 7, sess, b"m=1", timeout=30.0
            )
            assert again.value == first.value
        # converged: every replica applied m exactly once
        assert wait_for(
            lambda: all(
                apply_count(h, "m") == 1 for h in hosts.values()
            ),
            timeout=30,
        ), {n: apply_count(h, "m") for n, h in hosts.items()}
    finally:
        for nh in hosts.values():
            nh.stop()


def test_dedup_across_crash_restart(tmp_path):
    """Differential: the session cache survives a node crash — WAL
    recovery replays the register + the applied proposal, so the retry
    after restart still dedups."""
    reg = _Registry()
    nh = mk_host(
        "a:1", reg, "vector", nodehost_dir=str(tmp_path / "nh")
    )
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        mgr = SessionManager(front)
        assert mgr.register(7, CLUSTER, count=1, timeout_s=30.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            first = _propose_no_ack(front, 7, sess, b"c=1", timeout=30.0)
            nh.crash_cluster(CLUSTER)
            nh.restart_cluster(CLUSTER)
            assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1], timeout=60)
            again = _propose_no_ack(front, 7, sess, b"c=1", timeout=30.0)
            assert again.value == first.value
            assert apply_count(nh, "c") == 1
    finally:
        nh.stop()


def test_dedup_across_snapshot_install_rejoin(engine_kind, tmp_path):
    """Differential: a rejoiner whose log was compacted past receives
    the session image INSIDE the streamed snapshot install, then — made
    leader — answers the retry from that installed cache. The deepest
    way dedup can survive a move, and exactly the path a live migration
    (serving/placement.py) rides."""
    reg = _Registry()
    hosts = mk_trio(
        reg, engine_kind, snapshot_entries=20, compaction_overhead=5
    )
    try:
        assert wait_for(lambda: leader_of(hosts) != 0)
        lid = leader_of(hosts)
        front = hosts[lid].serving_front()
        mgr = SessionManager(front)
        assert mgr.register(7, CLUSTER, count=1, timeout_s=30.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            first = _propose_no_ack(front, 7, sess, b"s=1", timeout=30.0)
            victim = next(n for n in hosts if n != lid)
            hosts[victim].crash_cluster(CLUSTER)
            # drive traffic past the snapshot threshold and force
            # compaction past the victim's index
            s = hosts[lid].get_noop_session(CLUSTER)
            for i in range(40):
                hosts[lid].sync_propose(s, f"fill=v{i}".encode(), 20.0)
            try:
                hosts[lid].sync_request_snapshot(CLUSTER, timeout_s=20.0)
            except Exception:
                pass  # a periodic snapshot may already cover it
            hosts[victim].restart_cluster(CLUSTER)
            assert wait_for(
                lambda: hosts[victim].get_applied_index(CLUSTER)
                >= hosts[lid].get_applied_index(CLUSTER) - 2,
                timeout=60,
            ), "rejoiner never caught up"
            # one fresh commit so the rejoiner acks the true last index
            # (the leader's match for a snapshot-installed peer refreshes
            # on the next REPLICATE_RESP, which gates TimeoutNow)
            for _ in range(10):
                cur = leader_of(hosts)
                try:
                    hosts[cur].sync_propose(
                        hosts[cur].get_noop_session(CLUSTER),
                        b"poke=1", 10.0,
                    )
                    break
                except Exception:
                    time.sleep(0.3)
            # make the rejoiner the leader: the retry must be answered
            # from ITS installed session image
            assert transfer_until(hosts, victim), (
                "transfer to rejoiner never completed"
            )
            mgr2 = SessionManager(hosts[victim].serving_front())
            mgr2.adopt(7, CLUSTER, sess)
            again = _propose_no_ack(
                hosts[victim].serving_front(), 7, sess, b"s=1", timeout=30.0
            )
            assert again.value == first.value
        # the rejoiner got s's effect via the snapshot, never a 2nd apply
        assert apply_count(hosts[victim], "s") <= 1
        assert wait_for(
            lambda: all(
                apply_count(h, "s") <= 1 for h in hosts.values()
            ),
            timeout=30,
        )
    finally:
        for nh in hosts.values():
            nh.stop()


# ---------------------------------------------------------------------------
# SessionManager.propose retry loop (indeterminate -> same-series re-ask)
# ---------------------------------------------------------------------------


def test_propose_completes_an_already_applied_series():
    """The deadline-retry-after-apply shape end to end: a previous
    attempt applied series k but the ack was lost (session back in the
    pool unacknowledged); the next propose() submits the SAME series and
    must complete with the FIRST apply's cached result, then advance the
    session normally."""
    reg = _Registry()
    nh = mk_host("a:1", reg, "scalar")
    try:
        nh.start_cluster({1: "a:1"}, False, SeqKV, group_config(CLUSTER, 1))
        assert wait_for(lambda: nh.get_leader_id(CLUSTER)[1])
        front = nh.serving_front()
        mgr = SessionManager(front)
        assert mgr.register(7, CLUSTER, count=1, timeout_s=20.0) == 1
        with mgr.checkout(7, CLUSTER) as sess:
            first = _propose_no_ack(front, 7, sess, b"r=1")
            # checkout exits WITHOUT proposal_completed: the lost-ack state
        res = mgr.propose(7, CLUSTER, b"r=1", 30.0)
        assert res.value == first.value  # the cached result, not a re-apply
        assert apply_count(nh, "r") == 1
        # the session advanced: the next op is a fresh series
        nxt = mgr.propose(7, CLUSTER, b"r=2", 30.0)
        assert nxt.value == first.value + 1
    finally:
        nh.stop()


class _ScriptedFront:
    """Minimal ServingFront stand-in: propose_session pops scripted
    ticket outcomes, recording (session, series_id) per attempt — the
    deterministic harness for the same-series retry loop."""

    class _Cfg:
        pump_interval_s = 0.0001

    class _Ticket:
        def __init__(self, result):
            self._r = result

        def wait(self, timeout=None):
            return self._r

    def __init__(self, outcomes):
        from dragonboat_tpu_torch.serving.admission import AdmissionController

        self.config = self._Cfg()
        self.admission = AdmissionController()
        self._nh = None
        self.outcomes = list(outcomes)
        self.attempts = []

    def propose_session(self, tenant_id, cluster_id, session, cmd, budget):
        self.attempts.append((session, session.series_id))
        return self._Ticket(self.outcomes.pop(0))


def test_indeterminate_final_failure_poisons_the_session():
    """If the whole deadline is spent with the outcome still UNKNOWN,
    the session must NOT return to the pool: the series may be applied
    server-side, and a future (different) op reusing it would collect
    THIS op's cached result — the one silent mis-attribution this API
    could make. The poisoned session is discarded and counted."""
    from dragonboat_tpu_torch.client import Session
    from dragonboat_tpu_torch.requests import (
        ErrTimeout,
        REQUEST_TIMEOUT,
        RequestResult,
    )

    front = _ScriptedFront(
        [RequestResult(code=REQUEST_TIMEOUT)] * 2000
    )
    mgr = SessionManager(front)
    sess = Session.new_session(CLUSTER)
    sess.prepare_for_propose()
    mgr.adopt(7, CLUSTER, sess)
    with pytest.raises(ErrTimeout):
        mgr.propose(7, CLUSTER, b"k=v", 0.05)
    assert mgr.pool_sizes().get((7, CLUSTER), 0) == 0, (
        "an indeterminate session went back to the pool"
    )
    assert mgr.stats()["discarded"] == 1
    # a shed BEFORE submission leaves the session clean and reusable
    class _SheddingFront(_ScriptedFront):
        def propose_session(self, *a, **kw):
            from dragonboat_tpu_torch.serving.admission import ErrBackpressure

            raise ErrBackpressure(retry_after_s=10.0)

    front2 = _SheddingFront([])
    mgr2 = SessionManager(front2)
    sess2 = Session.new_session(CLUSTER)
    sess2.prepare_for_propose()
    mgr2.adopt(7, CLUSTER, sess2)
    with pytest.raises(ErrTimeout):
        mgr2.propose(7, CLUSTER, b"k=v", 0.05)
    assert mgr2.pool_sizes()[(7, CLUSTER)] == 1  # never submitted: clean
    assert mgr2.stats()["discarded"] == 0


def test_propose_retry_loop_reuses_same_series():
    """Unit differential for the retry loop itself: attempt 1 times out
    (indeterminate), attempt 2 completes — both attempts MUST carry the
    same session object and the same series id (the no-accidental-new-
    series rule of retry.call_with_retries' session propagation)."""
    from dragonboat_tpu_torch.client import Session
    from dragonboat_tpu_torch.requests import (
        REQUEST_COMPLETED,
        REQUEST_TIMEOUT,
        RequestResult,
    )
    from dragonboat_tpu_torch.statemachine import Result

    front = _ScriptedFront(
        [
            RequestResult(code=REQUEST_TIMEOUT),
            RequestResult(code=REQUEST_COMPLETED, result=Result(value=42)),
        ]
    )
    mgr = SessionManager(front)
    sess = Session.new_session(CLUSTER)
    sess.prepare_for_propose()
    mgr.adopt(7, CLUSTER, sess)
    res = mgr.propose(7, CLUSTER, b"k=v", 10.0)
    assert res.value == 42
    assert len(front.attempts) == 2
    (s1, series1), (s2, series2) = front.attempts
    assert s1 is sess and s2 is sess
    assert series1 == series2, "retry minted a new series (double-apply)"
    assert mgr.stats()["safe_retries"] == 1
    # acknowledged exactly once, after the completed attempt
    assert sess.responded_to == series1
    assert sess.series_id == series1 + 1
