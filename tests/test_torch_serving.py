"""The overload robustness plane (dragonboat_tpu_torch.serving) — tier-1 gate.

The PyTorch port's copy, held to the reference's contract end to end:

  * admission control: per-tenant token buckets, urgent-ahead-of-bulk,
    saturation-tightened rates, typed ErrOverloaded sheds with
    machine-readable retry-after hints;
  * backpressure: the WAL barrier / engine inbox / request-pool signals
    folded into one cached saturation score;
  * the deadline-honoring client retry helper (jittered exponential,
    server hint as floor, retries never outlive the caller's timeout);
  * quiesce wake-on-admit (engine/quiesce.py contract) on the scalar
    engine, plus the vector-lane mirror probe;
  * the pool-exhaustion ErrSystemBusy raise sites in requests.py (both
    single-slot sites, incl. slot reuse after a timeout sweep);
  * the seeded overload_storm graceful-degradation verdict: under 2x
    sustained overload, zero urgent-class sheds, bounded urgent p99,
    fail-fast hinted bulk sheds, admitted throughput within 20% of the
    unloaded baseline, and bit-identical same-seed replay.

Run alone with `-m serving`.
"""
import io
import random
import threading
import time

import numpy as np
import pytest
import torch

import dragonboat_tpu.events as ref_events
import dragonboat_tpu.serving.admission as ref_admission
import dragonboat_tpu.serving.placement as ref_placement
import dragonboat_tpu_torch.events as port_events
import dragonboat_tpu_torch.serving.admission as port_admission
import dragonboat_tpu_torch.serving.placement as port_placement

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.client import Session
from dragonboat_tpu_torch.events import MetricsRegistry
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.requests import (
    ErrRejected,
    ErrSystemBusy,
    ErrTimeout,
    LogicalClock,
    PendingConfigChange,
    PendingLeaderTransfer,
    REQUEST_COMPLETED,
    RequestResult,
    RequestState,
)
from dragonboat_tpu_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    ErrBackpressure,
    ErrOverloaded,
    ErrTenantThrottled,
    KLASS_BULK,
    KLASS_URGENT,
    SaturationMonitor,
    SaturationThresholds,
    ServingFront,
    TenantSpec,
    TokenBucket,
    call_with_retries,
    run_overload_storm,
)
from dragonboat_tpu_torch.serving.front import FrontConfig
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.storage.kv import (
    _barrier_stats,
    barrier_stats,
    reset_barrier_stats,
)
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

pytestmark = pytest.mark.serving


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def now(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# token bucket + admission decisions
# ---------------------------------------------------------------------------


def test_token_bucket_refill_and_hint():
    clk = FakeClock()
    b = TokenBucket(rate=10.0, burst=5.0, clock=clk.now)
    for _ in range(5):
        assert b.take(1.0) == 0.0
    # empty: the hint is the refill time for the refused cost, and the
    # failed take consumes nothing
    wait = b.take(2.0)
    assert wait == pytest.approx(0.2)
    assert b.balance() == pytest.approx(0.0)
    clk.sleep(wait)
    assert b.take(2.0) == 0.0
    # refill caps at burst
    clk.sleep(100.0)
    b.take(0.0)
    assert b.balance() == pytest.approx(5.0)


def test_token_bucket_zero_rate_blocks_without_crashing():
    """rate=0 is the natural way to fully block a tenant: takes beyond
    the initial burst throttle with an infinite hint (never refills)
    instead of dividing by zero, and the retry helper converts that hint
    into an immediate ErrTimeout rather than an unbounded sleep."""
    clk = FakeClock()
    b = TokenBucket(rate=0.0, burst=1.0, clock=clk.now)
    assert b.take(1.0) == 0.0  # the initial burst is still spendable
    assert b.take(1.0) == float("inf")
    clk.sleep(1e6)
    assert b.take(1.0) == float("inf")  # really never refills
    ac = AdmissionController(
        AdmissionConfig(tenants={7: TenantSpec(rate=0.0, burst=0.0)})
    )
    with pytest.raises(ErrTenantThrottled) as ei:
        ac.admit(7, KLASS_BULK)
    assert ei.value.retry_after_s == float("inf")
    with pytest.raises(ErrTimeout):
        call_with_retries(
            lambda _rem: ac.admit(7, KLASS_BULK),
            deadline_s=5.0,
            clock=clk.now,
            sleep=clk.sleep,
        )


def test_token_bucket_saturation_scale_slows_refill():
    clk = FakeClock()
    b = TokenBucket(rate=10.0, burst=1.0, clock=clk.now)
    assert b.take(1.0) == 0.0
    # at scale 0.1 the effective rate is 1/s: one token needs 1s not .1s
    assert b.take(1.0, scale=0.1) == pytest.approx(1.0)


def test_admission_urgent_never_shed_even_saturated():
    ac = AdmissionController(
        AdmissionConfig(default=TenantSpec(rate=1.0, burst=1.0)),
        saturation=lambda: 1.0,
    )
    for _ in range(100):
        ac.admit(7, KLASS_URGENT)
    c = ac.counters()[7]
    assert c["admitted"][KLASS_URGENT] == 100
    assert c["shed"][KLASS_URGENT] == 0


def test_admission_bulk_sheds_at_saturation_with_hint():
    ac = AdmissionController(
        AdmissionConfig(default=TenantSpec(rate=1e9, burst=1e9)),
        saturation=lambda: 0.95,
    )
    with pytest.raises(ErrBackpressure) as ei:
        ac.admit(3, KLASS_BULK)
    assert ei.value.retry_after_s > 0.0
    assert isinstance(ei.value, ErrSystemBusy)  # uniform client contract
    assert ac.counters()[3]["shed"][KLASS_BULK] == 1


def test_admission_bucket_empty_sheds_with_refill_hint():
    clk = FakeClock()
    ac = AdmissionController(
        AdmissionConfig(default=TenantSpec(rate=10.0, burst=1.0)),
        saturation=lambda: 0.0,
        clock=clk.now,
    )
    ac.admit(4, KLASS_BULK)
    with pytest.raises(ErrTenantThrottled) as ei:
        ac.admit(4, KLASS_BULK)
    assert ei.value.retry_after_s == pytest.approx(0.1)
    c = ac.counters()[4]
    assert c["admitted"][KLASS_BULK] == 1 and c["shed"][KLASS_BULK] == 1


def test_admission_rate_scale_curve():
    ac = AdmissionController(
        AdmissionConfig(tighten_from=0.5, shed_bulk_at=0.9, min_rate_scale=0.1)
    )
    assert ac.rate_scale(0.0) == 1.0
    assert ac.rate_scale(0.5) == 1.0
    assert ac.rate_scale(0.7) == pytest.approx(0.55)
    assert ac.rate_scale(0.9) == pytest.approx(0.1)
    assert ac.rate_scale(1.0) == pytest.approx(0.1)


def test_admission_downstream_shed_keeps_ledger_honest():
    ac = AdmissionController(
        AdmissionConfig(default=TenantSpec(rate=1e9, burst=1e9))
    )
    ac.admit(5, KLASS_BULK)
    ac.note_downstream_shed(5, KLASS_BULK)
    c = ac.counters()[5]
    assert c["admitted"][KLASS_BULK] == 0 and c["shed"][KLASS_BULK] == 1


# ---------------------------------------------------------------------------
# backpressure folding
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self):
        self.stats = {"inbox_occupancy": 0.0, "staged_backlog": 0}

    def pressure_stats(self):
        return dict(self.stats)


class _FakePressureHost:
    def __init__(self):
        self.engine = _FakeEngine()
        self.fill = 0.0

    def ingress_fill(self):
        return self.fill


def test_scalar_pressure_staged_backlog_counts_queued():
    """ExecEngine.pressure_stats() must report the
    REAL accepted-but-not-yet-stepped backlog (EntryQueue + ReadIndex
    queue pending counts), not a hardcoded 0 — vector-engine parity for
    the serving front's saturation fold."""
    from types import SimpleNamespace

    from dragonboat_tpu_torch.engine.execengine import ExecEngine
    from dragonboat_tpu_torch.engine.queue import EntryQueue, ReadIndexQueue
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.types import Entry

    eng = ExecEngine(ShardedLogDB())
    try:
        p = eng.pressure_stats()
        assert p == {"inbox_occupancy": 0.0, "staged_backlog": 0}
        node = SimpleNamespace(
            incoming_proposals=EntryQueue(size=8),
            incoming_reads=ReadIndexQueue(size=8),
        )
        for i in range(3):
            assert node.incoming_proposals.add(Entry(cmd=b"x"))
        assert node.incoming_reads.add(object())
        with eng._nodes_mu:
            eng._nodes[1] = node
        p = eng.pressure_stats()
        assert p["staged_backlog"] == 4
        assert p["inbox_occupancy"] == pytest.approx(3 / 8)
        # the step worker draining the queues drains the backlog
        node.incoming_proposals.get()
        node.incoming_reads.get()
        assert eng.pressure_stats()["staged_backlog"] == 0
    finally:
        with eng._nodes_mu:
            eng._nodes.clear()
        eng.stop()


@pytest.fixture
def clean_barrier_stats():
    reset_barrier_stats()
    yield
    reset_barrier_stats()


def test_saturation_monitor_folds_max_of_signals(clean_barrier_stats):
    clk = FakeClock()
    nh = _FakePressureHost()
    mon = SaturationMonitor(
        nh,
        SaturationThresholds(
            fsync_ewma_full_s=0.1, fsync_inflight_full=4,
            staged_backlog_full=100,
        ),
        interval_s=0.0,
        clock=clk.now,
    )
    assert mon.score() == 0.0
    nh.engine.stats["staged_backlog"] = 50
    clk.sleep(1.0)
    assert mon.score() == pytest.approx(0.5)
    # the WAL barrier is the bottleneck: the score is the MAX, not a mean
    _barrier_stats.enter()
    _barrier_stats.exit(10.0)  # ewma saturates past 0.1s full-scale
    clk.sleep(1.0)
    assert mon.score() == 1.0
    sig = mon.last_signals()
    assert sig["fsync_latency"] == 1.0
    assert sig["engine_staged"] == pytest.approx(0.5)
    # request-pool fill drives the score too
    reset_barrier_stats()
    nh.engine.stats["staged_backlog"] = 0
    nh.fill = 0.8
    clk.sleep(1.0)
    assert mon.score() == pytest.approx(0.8)


def test_saturation_monitor_caches_by_interval(clean_barrier_stats):
    clk = FakeClock()
    nh = _FakePressureHost()
    mon = SaturationMonitor(nh, interval_s=1.0, clock=clk.now)
    assert mon.score() == 0.0
    nh.fill = 1.0
    assert mon.score() == 0.0  # cached sample
    clk.sleep(1.5)
    assert mon.score() == 1.0


def test_saturation_override_pins_score():
    mon = SaturationMonitor(None)
    mon.set_override(0.77)
    assert mon.score() == 0.77
    mon.set_override(None)
    assert mon.score() <= 1.0


def test_wal_barrier_stats_track_real_fsyncs(tmp_path, clean_barrier_stats):
    from dragonboat_tpu_torch.storage.kv import WalKV, WriteBatch, sync_all

    kv = WalKV(str(tmp_path / "wal"))
    try:
        wb = WriteBatch()
        wb.put(b"k", b"v")
        kv.commit_write_batch(wb)
        sync_all([kv])
        bs = barrier_stats()
        assert bs["barriers"] >= 1
        assert bs["ewma_s"] > 0.0
        assert bs["inflight"] == 0
        assert bs["last_wave_s"] > 0.0
    finally:
        kv.close()


# ---------------------------------------------------------------------------
# deadline-aware retry helper
# ---------------------------------------------------------------------------


def test_retry_retries_busy_until_success_honoring_hint():
    clk = FakeClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        clk.sleep(dt)

    calls = []

    def fn(remaining):
        calls.append(remaining)
        if len(calls) < 3:
            raise ErrTenantThrottled(retry_after_s=0.05)
        return "ok"

    assert (
        call_with_retries(
            fn, 10.0, base_s=0.01, rng=random.Random(7),
            clock=clk.now, sleep=sleep,
        )
        == "ok"
    )
    assert len(sleeps) == 2
    assert all(s >= 0.05 for s in sleeps)  # server hint is the floor
    # fn receives the SHRINKING remaining budget
    assert calls[0] == pytest.approx(10.0)
    assert calls[1] < calls[0] and calls[2] < calls[1]


def test_retry_propagates_session_same_series():
    """call_with_retries(session=...) hands the SAME
    session object to every attempt and the series id never advances
    between retries — a retried proposal dedups against the original
    apply instead of double-applying under an accidental new series."""
    clk = FakeClock()
    sess = Session.new_session(5)
    sess.prepare_for_propose()
    series0 = sess.series_id
    attempts = []

    def fn(remaining, session):
        attempts.append((session, session.series_id))
        if len(attempts) < 3:
            raise ErrTenantThrottled(retry_after_s=0.01)
        return "applied"

    assert (
        call_with_retries(
            fn, 10.0, rng=random.Random(3),
            clock=clk.now, sleep=clk.sleep, session=sess,
        )
        == "applied"
    )
    assert len(attempts) == 3
    assert all(s is sess for s, _ in attempts)
    assert {sid for _, sid in attempts} == {series0}, (
        "a retry minted a new series"
    )


def test_retry_refuses_advanced_series_on_retryable_failure():
    """If an attempt ADVANCED the session (it completed) and still
    raised a retryable error, retrying would re-propose under a fresh
    series — the one double-apply shape the session parameter exists to
    prevent — so the helper refuses loudly instead of sleeping."""
    clk = FakeClock()
    sess = Session.new_session(5)
    sess.prepare_for_propose()

    def fn(remaining, session):
        session.proposal_completed()  # buggy caller: acked mid-attempt
        raise ErrTenantThrottled(retry_after_s=0.01)

    with pytest.raises(RuntimeError, match="series advanced"):
        call_with_retries(
            fn, 10.0, rng=random.Random(3),
            clock=clk.now, sleep=clk.sleep, session=sess,
        )


def test_retry_never_outlives_deadline():
    clk = FakeClock()
    sleeps = []

    def fn(remaining):
        raise ErrBackpressure(retry_after_s=5.0)

    with pytest.raises(ErrTimeout):
        call_with_retries(
            fn, 1.0, rng=random.Random(1), clock=clk.now,
            sleep=lambda dt: sleeps.append(dt),
        )
    # the hint says the server won't take it before the caller stops
    # caring: give up NOW, without burning the backoff sleep
    assert sleeps == []
    assert clk.t == pytest.approx(100.0)


def test_retry_zero_budget_and_non_busy_errors():
    with pytest.raises(ErrTimeout):
        call_with_retries(lambda r: "x", 0.0)

    def rejected(remaining):
        raise ErrRejected()

    with pytest.raises(ErrRejected):  # only the busy family retries
        call_with_retries(rejected, 10.0)


def test_retry_backoff_is_jittered_exponential():
    clk = FakeClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        clk.sleep(dt)

    attempts = [0]

    def fn(remaining):
        attempts[0] += 1
        if attempts[0] <= 6:
            raise ErrOverloaded()  # no hint: pure jittered backoff
        return None

    call_with_retries(
        fn, 100.0, base_s=0.01, factor=2.0, max_backoff_s=0.1,
        rng=random.Random(3), clock=clk.now, sleep=sleep,
    )
    # each delay is uniform(0, min(base*2^k, cap)): bounded by the cap
    caps = [min(0.01 * (2.0 ** k), 0.1) for k in range(6)]
    assert all(0.0 <= s <= c for s, c in zip(sleeps, caps))


# ---------------------------------------------------------------------------
# requests.py pool-exhaustion raise sites
# ---------------------------------------------------------------------------


def test_single_slot_pool_busy_and_timeout_reuse():
    clock = LogicalClock()
    pool = PendingConfigChange(clock)
    rs, _cc, key = pool.request(None, timeout_ticks=2)
    # the raise site: a second request while one is pending
    with pytest.raises(ErrSystemBusy):
        pool.request(None, timeout_ticks=2)
    # a slot freed by TIMEOUT is reusable
    clock.tick += 3
    pool.gc()
    assert rs.wait(1.0).timeout
    rs2, _cc2, key2 = pool.request(None, timeout_ticks=2)
    assert key2 != key
    pool.apply(key2, rejected=False)
    assert rs2.wait(1.0).completed


def test_leader_transfer_slot_busy_and_reuse():
    p = PendingLeaderTransfer()
    p.request(2)
    with pytest.raises(ErrSystemBusy):  # the second raise site
        p.request(3)
    assert p.get() == 2  # consumed by the step loop
    p.request(3)  # freed slot is reusable
    assert p.get() == 3


# ---------------------------------------------------------------------------
# serving front over a fake host (deterministic shed paths)
# ---------------------------------------------------------------------------


class _FakeHost:
    """The minimum NodeHost surface ServingFront touches, with manual
    completion control."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        self.batches = []  # (cluster_id, cmds, rss)
        self.busy = False
        self.woken = []

    def get_noop_session(self, cluster_id):
        return Session.noop_session(cluster_id)

    def propose_batch(self, session, cmds, timeout_s):
        if self.busy:
            raise ErrSystemBusy()
        rss = [RequestState() for _ in cmds]
        self.batches.append((session.cluster_id, list(cmds), rss))
        return rss

    def read_index(self, cluster_id, timeout_s):
        rs = RequestState()
        rs.notify(RequestResult(code=REQUEST_COMPLETED))
        return rs

    def notify_group_admission(self, cluster_id):
        self.woken.append(cluster_id)
        return True


def _mk_front(host=None, **admission_kw):
    host = host or _FakeHost()
    mon = SaturationMonitor(None)
    front = ServingFront(
        host,
        admission=AdmissionConfig(**admission_kw) if admission_kw else None,
        monitor=mon,
    )
    return host, front


def test_front_completes_admitted_bulk_and_counts_wakes():
    host, front = _mk_front()
    try:
        t = front.propose(1, 100, b"k=v", 5.0)
        deadline = time.monotonic() + 5
        while not host.batches and time.monotonic() < deadline:
            time.sleep(0.005)
        assert host.batches, "pump never submitted"
        cid, cmds, rss = host.batches[0]
        assert (cid, cmds) == (100, [b"k=v"])
        rss[0].notify(RequestResult(code=REQUEST_COMPLETED))
        assert t.wait(5.0).completed
        c = front.admission.counters()[1]
        assert c["admitted"][KLASS_BULK] == 1
        # the fake host reports the group as quiesced: wake counted
        assert host.woken == [100] and c["wakes"] == 1
    finally:
        front.stop()


def test_front_downstream_busy_fails_fast_with_hint():
    host, front = _mk_front()
    host.busy = True
    try:
        t = front.propose(1, 100, b"k=v", 30.0)
        t0 = time.monotonic()
        with pytest.raises(ErrBackpressure) as ei:
            t.wait(10.0)
        # the CONTRACT: a shed op fails fast, it does not wait out the
        # client's 30s timeout behind a saturated engine
        assert time.monotonic() - t0 < 5.0
        assert ei.value.retry_after_s > 0.0
        c = front.admission.counters()[1]
        assert c["shed"][KLASS_BULK] == 1 and c["admitted"][KLASS_BULK] == 0
    finally:
        front.stop()


def test_front_saturation_sheds_bulk_admits_urgent():
    host, front = _mk_front()
    front.monitor.set_override(0.95)
    try:
        with pytest.raises(ErrBackpressure) as ei:
            front.propose(2, 100, b"k=v", 5.0)
        assert ei.value.retry_after_s > 0.0
        rs = front.read(2, 100, 5.0)  # urgent still flows
        assert rs.wait(1.0).completed
        c = front.admission.counters()[2]
        assert c["shed"][KLASS_BULK] == 1
        assert c["admitted"][KLASS_URGENT] == 1
        assert c["shed"][KLASS_URGENT] == 0
    finally:
        front.stop()


def test_front_queue_bound_sheds_instead_of_growing():
    host = _FakeHost()
    front = ServingFront(
        host, front=FrontConfig(max_queued_per_tenant=0)
    )
    try:
        with pytest.raises(ErrBackpressure):
            front.propose(3, 100, b"k=v", 5.0)
        assert front.admission.counters()[3]["shed"][KLASS_BULK] == 1
    finally:
        front.stop()


def test_front_stop_drains_queued_tickets():
    from dragonboat_tpu_torch.requests import ErrClusterClosed
    from dragonboat_tpu_torch.serving.front import _QueuedOp
    from dragonboat_tpu_torch.serving import Ticket

    host = _FakeHost()
    # a long pump interval parks injected ops until stop() runs
    front = ServingFront(host, front=FrontConfig(pump_interval_s=5.0))
    now = time.monotonic()
    tk = Ticket(now + 30.0, now)
    with front._mu:
        front._queues.setdefault(1, []).append(_QueuedOp(100, b"k=v", tk))
    front.stop()
    with pytest.raises(ErrClusterClosed):  # drained, never hangs
        tk.wait(5.0)


def test_front_gauge_export_labels():
    host, front = _mk_front()
    try:
        with pytest.raises(ErrTimeout):
            front.sync_propose(9, 100, b"k=v", 0.05)
        front.export_gauges(host.metrics)
        w = io.StringIO()
        host.metrics.write(w)
        text = w.getvalue()
        assert 'serving_admitted_total{klass="bulk",tenant="9"} 1' in text
        assert 'serving_shed_total{klass="urgent",tenant="9"} 0' in text
        assert "serving_saturation" in text
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# live-host integration (scalar + vector engines)
# ---------------------------------------------------------------------------


class KVSM(IStateMachine):
    def __init__(self, cluster_id, node_id):
        self.data = {}
        self.n = 0

    def update(self, cmd: bytes) -> Result:
        k, v = cmd.decode().split("=", 1)
        self.data[k] = v
        self.n += 1
        return Result(value=self.n)

    def lookup(self, q):
        return self.data.get(q)

    def save_snapshot(self, w, files, done):
        import json

        w.write(json.dumps([self.data, self.n]).encode())

    def recover_from_snapshot(self, r, files, done):
        import json

        self.data, self.n = json.loads(r.read().decode())


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

def mk_host(addr, registry, engine_kind="scalar", rtt_ms=5):
    return NodeHost(
        NodeHostConfig(
            deployment_id=1,
            rtt_millisecond=VECTOR_RTT_MS if engine_kind == "vector" else rtt_ms,
            raft_address=addr,
            raft_rpc_factory=lambda listen: loopback_factory(listen, registry),
            engine=EngineConfig(
                kind=engine_kind, max_groups=32, max_peers=4, log_window=64, device="cpu",
            ),
        )
    )


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


@pytest.fixture(params=["scalar", "vector"])
def engine_kind(request):
    return request.param


def test_front_end_to_end_on_live_host(engine_kind):
    reg = _Registry()
    nh = mk_host("a:1", reg, engine_kind)
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(100, 1))
        assert wait_for(lambda: nh.get_leader_id(100)[1], timeout=60)
        front = nh.serving_front()
        assert nh.serving_front() is front  # one per host
        assert front.sync_propose(7, 100, b"k1=v1", 20.0).value == 1
        assert front.sync_read(7, 100, "k1", 20.0) == "v1"
        # the engine-side pressure probe exists and is sane
        p = nh.engine.pressure_stats()
        assert 0.0 <= p["inbox_occupancy"] <= 1.0
        assert p["staged_backlog"] >= 0
        assert 0.0 <= nh.ingress_fill() <= 1.0
        # per-tenant ledger reaches the health exposition
        nh._export_health_gauges()
        w = io.StringIO()
        nh.write_health_metrics(w)
        assert 'serving_admitted_total{klass="bulk",tenant="7"} 1' in (
            w.getvalue()
        )
    finally:
        nh.stop()


def test_quiesce_wake_on_admit_scalar():
    """An idle quiesced group resumes ticking on the
    FIRST admitted proposal and re-quiesces after the burst."""
    reg = _Registry()
    nh = mk_host("a:1", reg, "scalar", rtt_ms=2)
    try:
        nh.start_cluster(
            {1: "a:1"}, False, KVSM, group_config(100, 1, quiesce=True)
        )
        assert wait_for(lambda: nh.get_leader_id(100)[1])
        node = nh._get_node(100)
        assert wait_for(lambda: node.quiesce_mgr.quiesced(), timeout=30), (
            "group never quiesced while idle"
        )
        front = nh.serving_front()
        t = front.propose(3, 100, b"a=1", 20.0)
        # the admit itself woke the group (before the op reached the
        # step loop) and the wake was counted to the tenant
        assert not node.quiesce_mgr.quiesced()
        assert front.admission.counters()[3]["wakes"] == 1
        assert t.wait().completed
        # after the burst the group re-enters quiesce on its own
        assert wait_for(lambda: node.quiesce_mgr.quiesced(), timeout=30), (
            "group never re-quiesced after the burst"
        )
        # a second admit wakes again: the counter keeps meaning wakes
        assert front.sync_propose(3, 100, b"b=2", 20.0).value == 2
        assert front.admission.counters()[3]["wakes"] == 2
    finally:
        nh.stop()


def test_vector_wake_counted_once_per_transition():
    """The vector mirror probe must match the scalar semantics: a burst
    of admits against one quiesced lane is ONE quiesced->active
    transition, so only the first admit reports a wake — the mirror
    stays stale until the next decode, and the latch re-arms once the
    lane is actually awake."""
    reg = _Registry()
    nh = mk_host("a:1", reg, "vector", rtt_ms=2)
    try:
        nh.start_cluster(
            {1: "a:1"}, False, KVSM, group_config(100, 1, quiesce=True)
        )
        assert wait_for(lambda: nh.get_leader_id(100)[1], timeout=60)
        node = nh._get_node(100)
        lane = node._vec_lane
        quiesced = lambda: bool(nh.engine._m_quiesced[lane.g])
        assert wait_for(quiesced, timeout=60), "lane never quiesced"
        assert node.notify_admission() is True
        assert node.notify_admission() is False  # mirror still stale
        # real traffic wakes the lane; an active lane reports no wake
        # and re-arms the latch for the next transition
        front = nh.serving_front()
        assert front.sync_propose(3, 100, b"a=1", 20.0).value == 1
        assert wait_for(lambda: not quiesced()), "lane never woke"
        assert node.notify_admission() is False
        assert wait_for(quiesced, timeout=60), "lane never re-quiesced"
        assert node.notify_admission() is True
    finally:
        nh.stop()


def test_storm_count_survives_downstream_sheds():
    """An admitted ticket shed deeper in the stack re-raises its typed
    error from wait(); the storm verdict must fold that into the shed
    ledger (hint checked) instead of crashing — regression for the
    tier-1 gate dying under exactly the overload it measures."""
    from dragonboat_tpu_torch.serving.front import Ticket
    from dragonboat_tpu_torch.serving.storm import StormReport, _count_completed

    now = time.monotonic()
    ok = Ticket(now + 5.0, now)
    ok._complete(RequestResult(code=REQUEST_COMPLETED))
    hinted = Ticket(now + 5.0, now)
    hinted._fail(ErrBackpressure(retry_after_s=0.1))
    unhinted = Ticket(now + 5.0, now)
    unhinted._fail(ErrBackpressure(retry_after_s=0.0))
    rep = StormReport(seed=1)
    assert _count_completed([ok, hinted], rep) == 1
    assert rep.shed == 1 and rep.retry_hints_ok
    assert _count_completed([unhinted], rep) == 0
    assert rep.shed == 2 and not rep.retry_hints_ok


def test_quiesce_manager_wake_on_admit_unit():
    from dragonboat_tpu_torch.engine.quiesce import QuiesceManager

    qm = QuiesceManager(enabled=True, election_tick=2)
    assert qm.wake_on_admit() is False  # active group: no wake counted
    for _ in range(qm.threshold + 1):
        qm.tick()
    assert qm.quiesced()
    assert qm.wake_on_admit() is True
    assert not qm.quiesced()
    # disabled managers never report wakes
    qd = QuiesceManager(enabled=False, election_tick=2)
    for _ in range(100):
        qd.tick()
    assert qd.wake_on_admit() is False


# ---------------------------------------------------------------------------
# the graceful-degradation verdict (acceptance criteria)
# ---------------------------------------------------------------------------


def test_overload_storm_graceful_degradation_verdict():
    """Under seeded 2x overload: zero urgent sheds, bounded urgent p99,
    fail-fast hinted bulk sheds, admitted throughput >= 0.8x baseline —
    and the same seed replays the window schedule bit-identically."""
    reg = _Registry()
    nh = mk_host("a:1", reg, "scalar")
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(100, 1))
        assert wait_for(lambda: nh.get_leader_id(100)[1])
        # capacity well under the engine's unloaded rate, so the verdict
        # threshold rides the policy cap with margin on a slow box
        rep = run_overload_storm(
            nh, 100, seed=0xD1A60, storm_s=0.8, baseline_ops=300,
            capacity_rate=800.0,
        )
        assert rep.verdicts["zero_urgent_shed"], rep.verdicts
        assert rep.verdicts["urgent_p99_bounded"], rep.urgent_p99_s
        assert rep.verdicts["bulk_shed_under_overload"], rep.shed
        assert rep.verdicts["shed_fails_fast"], rep.shed_max_latency_s
        assert rep.verdicts["throughput_within_20pct"], (
            rep.baseline_tput, rep.storm_tput,
        )
        assert rep.ok
        assert rep.shed > 0 and rep.offered > rep.admitted
        # same-seed replay: identical window schedule AND signature
        rep2 = run_overload_storm(
            nh, 100, seed=0xD1A60, storm_s=0.8, baseline_ops=300,
            capacity_rate=800.0,
        )
        assert rep2.windows == rep.windows
        assert rep2.signature == rep.signature
        # a different seed draws a different storm
        rep3 = run_overload_storm(
            nh, 100, seed=0xBEEF, storm_s=0.8, baseline_ops=300,
            capacity_rate=800.0,
        )
        assert rep3.signature != rep.signature
    finally:
        nh.stop()


def test_storm_schedule_is_seed_deterministic_without_a_host():
    from dragonboat_tpu_torch.faults import FaultPlane

    def draw(seed):
        fp = FaultPlane(seed)
        return [
            (p, round(m, 6), round(w, 6), wts)
            for p, m, w, wts in fp.overload_storm_schedule(
                "storm", (1, 2, 3), 2.0
            )
        ]

    a, b, c = draw(11), draw(11), draw(12)
    assert a == b
    assert a != c
    for profile, mult, window, weights in a:
        assert profile in ("burst", "sustained")
        if profile == "burst":
            assert 2.0 <= mult <= 4.0
        else:
            assert 1.5 <= mult <= 2.5
        assert set(weights) == {1, 2, 3}
    assert sum(w for _, _, w, _ in a) >= 2.0


# ---------------------------------------------------------------------------
# bench JSON fold schema
# ---------------------------------------------------------------------------


def test_bench_serving_report_schema_stable():
    """The port's serving fold (e2e._serving_report) carries bench.py's
    keys, and reads a live front as bench.py's fold does."""
    import bench

    from dragonboat_tpu_torch.e2e import _serving_report

    keys = {
        "serving_admitted_total",
        "serving_shed_total",
        "serving_wakes_total",
        "serving_urgent_p99_s",
        "serving_bulk_p50_s",
        "serving_bulk_p99_s",
        # per-tenant latency + the session/migration ledger
        # joined the ALWAYS-present fold (zero/empty when no front,
        # placement plane or migration stream existed)
        "serving_tenant_latency",
        "migrations_started",
        "migrations_completed",
        "migrations_aborted",
        "migration_streams",
    }
    assert keys == set(bench._serving_report({}))  # zero hosts
    assert _serving_report({}) == bench._serving_report({})
    host, front = _mk_front()
    try:
        with pytest.raises(ErrTimeout):
            front.sync_propose(1, 100, b"k=v", 0.05)
        host._serving = front
        r = _serving_report({1: host})
        assert r["serving_admitted_total"] == 1
        assert r["migrations_started"] == 0
        assert r["serving_tenant_latency"] == {}
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# queue fill probes (the request-pool backpressure source)
# ---------------------------------------------------------------------------


def test_queue_fill_probes():
    from dragonboat_tpu_torch.engine.queue import EntryQueue, ReadIndexQueue
    from dragonboat_tpu_torch.types import Entry

    q = EntryQueue(4)
    assert q.fill() == 0.0
    q.add(Entry(cmd=b"x"))
    assert q.fill() == pytest.approx(0.25)
    for _ in range(5):
        q.add(Entry(cmd=b"x"))
    assert q.fill() == 1.0  # clamped even past capacity refusals

    rq = ReadIndexQueue(2)
    assert rq.fill() == 0.0
    rq.add(RequestState())
    assert rq.fill() == pytest.approx(0.5)


def test_vector_inbox_occupancy_signal_is_live():
    """Regression: the pack-time inbox-row count must be captured BEFORE
    _flush_staged_rows clears the staging columns (a post-flush read is
    always zero and silently kills the engine_inbox saturation signal).
    Under sustained load the vector engine must report occupancy > 0."""
    reg = _Registry()
    nh = mk_host("a:1", reg, "vector")
    try:
        nh.start_cluster({1: "a:1"}, False, KVSM, group_config(100, 1))
        assert wait_for(lambda: nh.get_leader_id(100)[1], timeout=60)
        s = nh.get_noop_session(100)
        stop = threading.Event()

        def load():
            i = 0
            while not stop.is_set():
                try:
                    nh.propose_batch(
                        s, [b"k%d=v" % (i + j) for j in range(16)], 5.0
                    )
                except Exception:
                    pass
                i += 16

        th = threading.Thread(target=load, daemon=True)
        th.start()
        try:
            seen = 0.0
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and seen == 0.0:
                seen = max(
                    seen, nh.engine.pressure_stats()["inbox_occupancy"]
                )
                time.sleep(0.0005)
        finally:
            stop.set()
            th.join(timeout=5)
        assert seen > 0.0, "inbox occupancy never observed under load"
    finally:
        nh.stop()


# ---------------------------------------------------------------------------
# the two packages, exactly equal
# ---------------------------------------------------------------------------

SEEDS = [int(x) for x in np.random.default_rng(20261018).integers(1, 2**31, size=3)]


def _trace(seed, n=800):
    """A seeded admission trace: (clock step, tenant, class, ops, score)."""
    rng = np.random.default_rng(seed)
    return [(float(rng.exponential(0.004)), int(rng.integers(1, 5)),
             "urgent" if rng.random() < 0.1 else "bulk", int(rng.integers(1, 4)),
             float(rng.choice([0.0, 0.3, 0.6, 0.8, 0.95])) if rng.random() < 0.3 else 0.0)
            for _ in range(n)]


def _admission_run(A, trace):
    clk = FakeClock()
    score = [0.0]
    ctl = A.AdmissionController(
        A.AdmissionConfig(default=A.TenantSpec(rate=200.0, burst=20.0),
                          tenants={2: A.TenantSpec(rate=50.0, burst=5.0, weight=2.0)}),
        saturation=lambda: score[0], clock=clk.now)
    bucket = A.TokenBucket(100.0, 10.0, clk.now)
    out = []
    for dt, tid, klass, n, sc in trace:
        clk.sleep(dt)
        score[0] = sc
        try:
            ctl.admit(tid, klass, n)
            v = "admitted"
        except A.ErrOverloaded as e:
            v = (type(e).__name__, e.retry_after_s, str(e))
        out.append((v, bucket.take(n, ctl.rate_scale(sc))))
    return out, ctl.counters()


@pytest.mark.parametrize("seed", SEEDS)
def test_admission_decisions_equal_across_packages(seed):
    """AdmissionController and TokenBucket on an injected clock make the
    same admit/shed decisions, with the same hints, over a seeded trace."""
    trace = _trace(seed)
    ref = _admission_run(ref_admission, trace)
    assert _admission_run(port_admission, trace) == ref
    verdicts = {v if isinstance(v, str) else v[0] for v, _ in ref[0]}
    assert {"admitted", "ErrTenantThrottled", "ErrBackpressure"} <= verdicts


class _PlanHost:
    """The NodeHost surface PlacementPlane.plan reads, from seeded lanes."""

    def __init__(self, E, lanes, p99s):
        self.lanes = lanes
        self.engine = self
        self.metrics = E.MetricsRegistry()
        for tid, xs in p99s.items():
            for x in xs:
                self.metrics.observe("serving_latency_seconds", (tid, KLASS_BULK), x)

    def lane_stats(self):
        return {c: dict(s) for c, s in self.lanes.items()}

    def has_node(self, cid):
        return cid % 7 != 0

    def get_cluster_membership(self, cid):
        class M:
            addresses = {1: "a", 2: "b", 3: "c"}
            observers = {4: "o"} if cid % 3 == 0 else {}
            witnesses = {}
            removed = {5: True} if cid % 4 == 0 else {}
        return M

    def local_node_id(self, cid):
        return 1 + cid % 3


def _plans(P, E, seed):
    rng = np.random.default_rng(seed)
    lanes = {c: {"last_index": int(rng.integers(0, 1000)),
                 "commit_gap": int(rng.integers(0, 64))} for c in range(1, 25)}
    p99s = {t: [float(x) for x in rng.exponential(0.2, size=20)] for t in (1, 2, 3)}
    host = _PlanHost(E, lanes, p99s)
    score = [0.0]

    class _Front:
        class monitor:
            score = staticmethod(lambda: score[0])

    loads = [float(x) for x in rng.uniform(0, 1, size=3)]
    targets = [P.MigrationTarget(address=f"t{i}:1", start_replica=lambda c, n: None,
                                 applied_index=lambda c: 0, load=(lambda v=v: v))
               for i, v in enumerate(loads)]
    out = []
    for sc, cfg in ((0.3, {}), (0.7, {}), (0.95, {"max_concurrent": 3}),
                    (0.4, {"p99_rebalance_s": 0.3, "max_concurrent": 2}),
                    (0.2, {"max_concurrent": 4})):
        score[0] = sc
        plane = P.PlacementPlane(host, targets, config=P.PlacementConfig(**cfg), front=_Front)
        for force in (False, True):
            # the heat is the commit gap: the first fold of a plane sees
            # no ingest, so the plan is a function of the seeded lanes
            out.append([(p.cluster_id, p.local_node_id, p.new_node_id, p.target.address,
                         p.reason, p.heat) for p in plane.plan(force=force)])
            plane._last_lanes = {}
        for c in lanes:
            lanes[c]["commit_gap"] = int(rng.integers(0, 64))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_placement_plans_equal_across_packages(seed):
    """PlacementPlane.plan over a seeded load model (lanes, tenant
    latency histograms, target loads, a lambda score) plans the same
    moves in both packages."""
    ref = _plans(ref_placement, ref_events, seed)
    assert _plans(port_placement, port_events, seed) == ref
    assert any(ref) and not all(ref)
