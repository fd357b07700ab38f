"""ServingFront: many tenants multiplexed onto the batched propose path.

The fan-in architecture (cf. PAPERS.md Podracer: batched request fan-in
feeding an accelerator step loop): client threads submit per-tenant
work; admitted bulk proposals land in per-tenant queues; ONE pump
thread drains them with weighted-fair (deficit round robin) dequeue and
feeds `NodeHost.propose_batch` — so a thousand concurrent clients cost
the engine one registry lock and one wake per pump round, not a
thousand. Urgent control-plane ops (ReadIndex, membership, session
ops, leader transfer) bypass the queue entirely: they are admitted
ahead of every queued bulk proposal by construction.

Every shed happens synchronously with a typed ErrOverloaded subclass
carrying a retry-after hint — a shed bulk proposal NEVER hangs; and a
proposal refused deeper in the stack (pool full, engine rate-limited)
completes its ticket with the same fail-fast error instead of waiting
out the client's timeout.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..requests import (
    REQUEST_TIMEOUT,
    ErrClusterClosed,
    ErrRejected,
    ErrSystemBusy,
    ErrTimeout,
    RequestError,
    RequestResult,
    RequestState,
)
from ..trace import flight_recorder
from .admission import (
    AdmissionConfig,
    AdmissionController,
    ErrBackpressure,
    KLASS_BULK,
    KLASS_URGENT,
    KLASSES,
)
from .backpressure import SaturationMonitor


class Ticket:
    """Completion handle for one admitted bulk proposal: bound to the
    underlying RequestState once the pump submits it; wait() honors the
    op's own deadline and re-raises fail-fast overload errors."""

    __slots__ = ("deadline", "t0", "_event", "_result", "_error")

    def __init__(self, deadline: float, t0: float) -> None:
        self.deadline = deadline
        self.t0 = t0
        self._event = threading.Event()
        self._result: Optional[RequestResult] = None
        self._error: Optional[Exception] = None

    def _complete(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: Exception) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until completion (or the op's deadline); raises the
        typed overload error when the op was shed downstream."""
        if timeout is None:
            timeout = max(self.deadline - time.monotonic(), 0.0)
        if not self._event.wait(timeout):
            return RequestResult(code=REQUEST_TIMEOUT)
        if self._error is not None:
            raise self._error
        return self._result


class _QueuedOp:
    __slots__ = ("cluster_id", "cmd", "ticket", "session")

    def __init__(
        self, cluster_id: int, cmd: bytes, ticket: Ticket, session=None
    ) -> None:
        self.cluster_id = cluster_id
        self.cmd = cmd
        self.ticket = ticket
        # None = noop-session bulk op (batchable); a client.Session means
        # this op carries at-most-once dedup state and must be submitted
        # individually with ITS session (registered sessions are strictly
        # sequential — see Node.propose_batch)
        self.session = session


@dataclass
class FrontConfig:
    """Pump knobs: `quantum` bulk ops per weight-1.0 tenant per round
    (weighted-fair share), `max_queued_per_tenant` the bound past which
    submissions shed (queues must never grow without bound — that is
    the failure mode this plane exists to prevent), and the idle pump
    poll period."""

    quantum: int = 64
    max_queued_per_tenant: int = 1024
    pump_interval_s: float = 0.002


class ServingFront:
    """One NodeHost's overload-robust ingress. Create via
    `NodeHost.serving_front()` (which also wires gauge export)."""

    def __init__(
        self,
        nh,
        admission: Optional[AdmissionConfig] = None,
        front: Optional[FrontConfig] = None,
        monitor: Optional[SaturationMonitor] = None,
    ) -> None:
        self._nh = nh
        self.config = front or FrontConfig()
        self.monitor = monitor or SaturationMonitor(nh)
        self.admission = AdmissionController(
            admission, saturation=self.monitor.score
        )
        self._mu = threading.Lock()
        # tenant_id -> FIFO of admitted-but-not-yet-submitted bulk ops
        self._queues: Dict[int, List[_QueuedOp]] = {}
        self._work = threading.Event()
        self._stopped = threading.Event()
        self._pump = threading.Thread(
            target=self._pump_main, name="serving-pump", daemon=True
        )
        self._pump.start()

    # ------------------------------------------------------------ lifecycle
    def stop(self) -> None:
        self._stopped.set()
        self._work.set()
        self._pump.join(timeout=5)
        with self._mu:
            drained = [
                op for q in self._queues.values() for op in q
            ]
            self._queues.clear()
        for op in drained:
            op.ticket._fail(ErrClusterClosed())

    # ------------------------------------------------------------ internals
    def _metrics(self):
        return getattr(self._nh, "metrics", None)

    def _observe_latency(self, tenant_id: int, klass: str, t0: float) -> None:
        m = self._metrics()
        if m is not None:
            m.observe(
                "serving_latency_seconds",
                (tenant_id, klass),
                max(time.monotonic() - t0, 0.0),
            )

    def _wake_if_quiesced(self, tenant_id: int, cluster_id: int) -> None:
        """Quiesce-aware admission: the FIRST admit against an idle
        quiesced group wakes it (the engine resumes real ticks without
        waiting for the op to reach the step loop) and is counted — the
        serving plane's half of engine/quiesce.py's contract."""
        wake = getattr(self._nh, "notify_group_admission", None)
        if wake is not None and wake(cluster_id):
            self.admission.note_wake(tenant_id)
            flight_recorder().record(
                "serving_wake", cluster=cluster_id, tenant=tenant_id,
            )

    # ------------------------------------------------------------ bulk path
    def propose(
        self,
        tenant_id: int,
        cluster_id: int,
        cmd: bytes,
        timeout_s: float,
        session=None,
    ) -> Ticket:
        """Admit one bulk proposal for tenant_id and queue it for the
        weighted-fair pump. Sheds synchronously (typed ErrOverloaded)
        when the tenant's bucket is empty, the host is saturated, or the
        tenant's queue bound is hit. An optional client.Session makes
        the op SESSION-MANAGED (see propose_session)."""
        self.admission.admit(tenant_id, KLASS_BULK)
        self._wake_if_quiesced(tenant_id, cluster_id)
        now = time.monotonic()
        ticket = Ticket(now + timeout_s, now)
        op = _QueuedOp(cluster_id, cmd, ticket, session=session)
        with self._mu:
            # checked under the queue lock: stop() drains the queues
            # under the same lock AFTER setting _stopped, so an op either
            # lands before the drain (and is failed by it) or sees the
            # flag here — never a stranded ticket that hangs to timeout
            if self._stopped.is_set():
                raise ErrClusterClosed()
            q = self._queues.setdefault(tenant_id, [])
            if len(q) >= self.config.max_queued_per_tenant:
                over = True
            else:
                q.append(op)
                over = False
        if over:
            self.admission.note_downstream_shed(tenant_id, KLASS_BULK)
            raise ErrBackpressure(
                retry_after_s=self.config.pump_interval_s * 4,
                reason=f"tenant {tenant_id} queue full",
            )
        self._work.set()
        return ticket

    def propose_session(
        self,
        tenant_id: int,
        cluster_id: int,
        session,
        cmd: bytes,
        timeout_s: float,
    ) -> Ticket:
        """Admit one SESSION-MANAGED bulk proposal: same admission, same
        weighted-fair pump and the same typed sheds as propose(), but the
        op rides its client.Session so the RSM's (client_id, series_id,
        responded_to) dedup applies end-to-end — a deadline-retried
        proposal that already applied completes with the CACHED result
        instead of double-applying. The caller owns the session's
        sequencing: one in-flight proposal per session, and
        proposal_completed() only after a completed result (see
        serving/sessions.py, which manages both)."""
        return self.propose(
            tenant_id, cluster_id, cmd, timeout_s, session=session
        )

    def sync_propose(
        self, tenant_id: int, cluster_id: int, cmd: bytes, timeout_s: float
    ):
        """Blocking convenience: admitted -> Result, shed -> typed
        ErrOverloaded, timeout -> ErrTimeout."""
        ticket = self.propose(tenant_id, cluster_id, cmd, timeout_s)
        r = ticket.wait()
        if r.completed:
            return r.result
        if r.timeout:
            raise ErrTimeout()
        if r.rejected:
            raise ErrRejected()
        raise ErrClusterClosed()

    # ---------------------------------------------------------- urgent path
    def read(
        self, tenant_id: int, cluster_id: int, timeout_s: float
    ) -> RequestState:
        """Urgent: linearizable read index. Admitted ahead of every
        queued bulk proposal (submitted directly, never queued)."""
        self.admission.admit(tenant_id, KLASS_URGENT)
        self._wake_if_quiesced(tenant_id, cluster_id)
        try:
            rs = self._nh.read_index(cluster_id, timeout_s)
        except ErrSystemBusy:
            self.admission.note_downstream_shed(tenant_id, KLASS_URGENT)
            raise
        t0 = time.monotonic()
        rs.on_complete(
            lambda _rs, t=tenant_id: self._observe_latency(
                t, KLASS_URGENT, t0
            )
        )
        return rs

    def sync_read(
        self, tenant_id: int, cluster_id: int, query, timeout_s: float
    ):
        rs = self.read(tenant_id, cluster_id, timeout_s)
        r = rs.wait(timeout_s + 1.0)
        self._nh._unwrap(r)
        return self._nh.read_local_node(cluster_id, query)

    def request_config_change(
        self, tenant_id: int, fn, *args, **kwargs
    ):
        """Urgent: membership ops. `fn` is the NodeHost request method
        (request_add_node / request_delete_node / ...)."""
        self.admission.admit(tenant_id, KLASS_URGENT)
        try:
            return fn(*args, **kwargs)
        except ErrSystemBusy:
            self.admission.note_downstream_shed(tenant_id, KLASS_URGENT)
            raise

    def session_op(self, tenant_id: int, fn, *args, **kwargs):
        """Urgent: session register/unregister (NodeHost.sync_get_session
        / sync_close_session)."""
        self.admission.admit(tenant_id, KLASS_URGENT)
        try:
            return fn(*args, **kwargs)
        except ErrSystemBusy:
            self.admission.note_downstream_shed(tenant_id, KLASS_URGENT)
            raise

    # ------------------------------------------------------------ pump loop
    def _pump_main(self) -> None:
        while not self._stopped.is_set():
            self._work.wait(self.config.pump_interval_s)
            self._work.clear()
            if self._stopped.is_set():
                return
            try:
                while self._pump_round():
                    pass
            except Exception:
                import traceback

                traceback.print_exc()

    def _pump_round(self) -> bool:
        """One weighted-fair round: every tenant with queued work gets up
        to quantum*weight ops submitted, grouped per cluster into ONE
        propose_batch each. Returns True when work remains queued."""
        with self._mu:
            tenants = [tid for tid, q in self._queues.items() if q]
        if not tenants:
            return False
        base = self.config.quantum
        for tid in sorted(tenants):
            weight = self.admission.tenant(tid).spec.weight
            take = max(1, int(base * weight))
            with self._mu:
                q = self._queues.get(tid)
                if not q:
                    continue
                ops, rest = q[:take], q[take:]
                self._queues[tid] = rest
            self._submit(tid, ops)
        with self._mu:
            return any(q for q in self._queues.values())

    def _submit(self, tenant_id: int, ops: List[_QueuedOp]) -> None:
        now = time.monotonic()
        by_cluster: Dict[int, List[_QueuedOp]] = {}
        for op in ops:
            if op.ticket.deadline <= now:
                op.ticket._complete(RequestResult(code=REQUEST_TIMEOUT))
                continue
            if op.session is not None:
                # session-managed: one propose with the op's OWN session
                # (dedup ids must ride the entry; batching is noop-only)
                self._submit_session_op(tenant_id, op, now)
                continue
            by_cluster.setdefault(op.cluster_id, []).append(op)
        for cid, group in by_cluster.items():
            timeout_s = max(
                max(op.ticket.deadline for op in group) - now, 0.001
            )
            session = self._nh.get_noop_session(cid)
            try:
                rss = self._nh.propose_batch(
                    session, [op.cmd for op in group], timeout_s
                )
            except ErrSystemBusy as e:
                # downstream shed (pool full / engine rate-limited):
                # fail FAST with the retry hint — never park the client
                # behind a saturated engine until its timeout
                self.admission.note_downstream_shed(
                    tenant_id, KLASS_BULK, len(group)
                )
                hint = getattr(e, "retry_after_s", 0.0) or (
                    self.config.pump_interval_s * 8
                )
                err = ErrBackpressure(
                    retry_after_s=hint, reason="engine busy"
                )
                for op in group:
                    op.ticket._fail(err)
                continue
            except RequestError as e:
                for op in group:
                    op.ticket._fail(e)
                continue
            for op, rs in zip(group, rss):
                rs.on_complete(
                    lambda r, t=op.ticket, tid=tenant_id: self._finish(
                        tid, t, r.result
                    )
                )

    def _submit_session_op(
        self, tenant_id: int, op: _QueuedOp, now: float
    ) -> None:
        timeout_s = max(op.ticket.deadline - now, 0.001)
        try:
            rs = self._nh.propose(op.session, op.cmd, timeout_s)
        except ErrSystemBusy as e:
            self.admission.note_downstream_shed(tenant_id, KLASS_BULK)
            hint = getattr(e, "retry_after_s", 0.0) or (
                self.config.pump_interval_s * 8
            )
            op.ticket._fail(
                ErrBackpressure(retry_after_s=hint, reason="engine busy")
            )
            return
        except RequestError as e:
            op.ticket._fail(e)
            return
        rs.on_complete(
            lambda r, t=op.ticket, tid=tenant_id: self._finish(
                tid, t, r.result
            )
        )

    def _finish(self, tenant_id: int, ticket: Ticket, res) -> None:
        """Completion fan-in for one submitted proposal. An engine-side
        DROP (incoming-queue overflow — Node.propose_batch completes the
        overflow tail as REQUEST_DROPPED rather than raising) is an
        overload shed, not a cluster death: surface it as the typed
        retryable error with a hint and keep the shed ledger honest."""
        if res is not None and res.dropped:
            self.admission.note_downstream_shed(tenant_id, KLASS_BULK)
            ticket._fail(
                ErrBackpressure(
                    retry_after_s=self.config.pump_interval_s * 8,
                    reason="engine inbox overflow",
                )
            )
            return
        ticket._complete(res)
        self._observe_latency(tenant_id, KLASS_BULK, ticket.t0)

    # ----------------------------------------------------------- introspect
    def queue_depths(self) -> Dict[int, int]:
        with self._mu:
            return {tid: len(q) for tid, q in self._queues.items()}

    def export_gauges(self, metrics) -> None:
        """Fold the per-tenant ledger into the host MetricsRegistry
        (called ~1/s from NodeHost._export_health_gauges; the latency
        histograms are fed live by the completion callbacks)."""
        for name in (
            "serving_admitted_total",
            "serving_shed_total",
            "serving_latency_seconds",
            "serving_queue_depth",
            "serving_wakes_total",
            "serving_saturation",
        ):
            metrics.declare_label_names(name, ("tenant", "klass"))
        for tid, c in self.admission.counters().items():
            for klass in KLASSES:
                metrics.set_gauge(
                    "serving_admitted_total", (tid, klass),
                    float(c["admitted"][klass]),
                )
                metrics.set_gauge(
                    "serving_shed_total", (tid, klass),
                    float(c["shed"][klass]),
                )
            metrics.set_gauge(
                "serving_wakes_total", (tid, "all"), float(c["wakes"])
            )
        for tid, depth in self.queue_depths().items():
            # only bulk ops queue (urgent bypasses by construction)
            metrics.set_gauge(
                "serving_queue_depth", (tid, KLASS_BULK), float(depth)
            )
        # host-level score: one series, labelled consistently with the
        # rest of the serving plane
        metrics.set_gauge(
            "serving_saturation", ("all", "all"), self.monitor.score()
        )


__all__ = ["FrontConfig", "ServingFront", "Ticket"]
