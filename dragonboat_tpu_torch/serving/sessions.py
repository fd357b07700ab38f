"""Vector-scale client sessions multiplexed per tenant over ServingFront.

The reference dragonboat gives every client ONE `client.Session` and a
strictly sequential at-most-once lane (client/session.go:23-167); at
millions of users that shape is a per-client sync round-trip per op.
This module is the serving-scale session layer the ROADMAP names: a
per-host SessionManager that

  * REGISTERS sessions in batched waves — one urgent admission and one
    completion wait for a whole wave of register proposals, instead of
    one sync round-trip per session (the register/unregister entries
    themselves are the existing replicated session ops, so nothing new
    rides the log);
  * POOLS registered sessions per (tenant, cluster) and checks them out
    one in-flight proposal at a time (a registered session's dedup
    bookkeeping is strictly sequential — series ids advance one by one);
  * PROPOSES through the front's session lane (ServingFront
    .propose_session): same admission, same weighted-fair pump, same
    typed sheds as plain bulk traffic, but the entry carries
    (client_id, series_id, responded_to) so the RSM's dedup applies
    end-to-end;
  * RETRIES indeterminate outcomes safely: a client-side timeout or an
    engine drop re-proposes under the SAME series id
    (retry.call_with_retries' session propagation), so an attempt that
    already applied completes with the RSM's CACHED result instead of
    double-applying — and the session state is replicated (snapshots
    included), so the guarantee holds across leader changes,
    crash/restarts and snapshot-install rejoins (differential-tested in
    tests/test_sessions_plane.py).

A session registered through one host keeps its dedup state on every
replica; `adopt()` hands such a session to another host's manager for
failover without re-registering.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

from ..client import Session
from ..requests import (
    ErrClusterClosed,
    ErrRejected,
    ErrSystemBusy,
)
from .admission import ErrOverloaded, KLASS_URGENT
from .retry import call_with_retries


class ErrSessionExhausted(ErrOverloaded):
    """Every registered session of the (tenant, cluster) pool is mid-
    proposal: the at-most-once lane is at capacity. Retryable — a
    session frees the moment its in-flight proposal completes; register
    a bigger pool to raise the lane's concurrency."""

    code = "all sessions in flight, retry later"


class ErrProposalIndeterminate(ErrSystemBusy):
    """An at-most-once proposal's outcome is unknown (client-side
    timeout / engine drop before completion). Under a REGISTERED session
    this is safe to retry with the same series id — the RSM returns the
    cached result if the first attempt applied — which is exactly what
    SessionManager.propose does; it is raised (and retried) internally
    and only surfaces when the whole deadline is spent."""

    code = "proposal outcome unknown, safe to retry under this session"

    def __init__(self, retry_after_s: float = 0.0):
        super().__init__()
        self.retry_after_s = float(retry_after_s)


class SessionManager:
    """At-most-once session multiplexing for one host's ServingFront.

    Thread-safe; the pool lock is a LEAF (never held across a propose or
    a front call — see analysis/targets.py)."""

    def __init__(self, front, register_timeout_s: float = 10.0) -> None:
        self._front = front
        self._nh = front._nh
        self._register_timeout_s = register_timeout_s
        self._mu = threading.Lock()
        # (tenant_id, cluster_id) -> idle registered sessions
        self._pools: Dict[Tuple[int, int], List[Session]] = {}
        # id()s of checked-out sessions poisoned by an INDETERMINATE
        # final failure: the series may or may not have applied, so a
        # NEXT op reusing it would collect the OLD op's cached result —
        # the one way this API could silently mis-attribute a write.
        # Poisoned sessions never return to the pool (the replicated
        # LRU ages their server side out); callers re-register.
        self._dead: set = set()
        self._counters = {
            "registered": 0,
            "register_failed": 0,
            "retired": 0,
            "proposals": 0,
            "safe_retries": 0,  # same-series re-proposals (the dedup lane)
            "discarded": 0,  # sessions poisoned by indeterminate failure
        }

    # ------------------------------------------------------------ lifecycle
    def register(
        self,
        tenant_id: int,
        cluster_id: int,
        count: int = 1,
        timeout_s: Optional[float] = None,
    ) -> int:
        """Register `count` fresh sessions in ONE batched wave: a single
        urgent admission covers the wave, every register proposal is in
        flight concurrently, and one pass collects the completions.
        Returns how many registered (failures are counted back into the
        admission ledger as downstream sheds). The registered sessions
        land in the (tenant, cluster) pool ready for checkout."""
        timeout_s = timeout_s or self._register_timeout_s
        self._front.admission.admit(tenant_id, KLASS_URGENT, n=count)
        sessions: List[Session] = []
        states = []
        for _ in range(count):
            s = Session.new_session(cluster_id)
            s.prepare_for_register()
            sessions.append(s)
            states.append(self._nh.propose(s, b"", timeout_s))
        ok: List[Session] = []
        for s, rs in zip(sessions, states):
            r = rs.wait(timeout_s + 1.0)
            if r.completed and r.result.value == s.client_id:
                s.prepare_for_propose()
                ok.append(s)
        failed = count - len(ok)
        if failed:
            self._front.admission.note_downstream_shed(
                tenant_id, KLASS_URGENT, failed
            )
        with self._mu:
            self._pools.setdefault((tenant_id, cluster_id), []).extend(ok)
            self._counters["registered"] += len(ok)
            self._counters["register_failed"] += failed
        return len(ok)

    def retire(
        self,
        tenant_id: int,
        cluster_id: int,
        count: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ) -> int:
        """Unregister up to `count` idle sessions (all of the pool when
        None) in one batched wave — the retirement half of the vector-
        scale lifecycle. Sessions whose unregister did not complete are
        DROPPED from the pool anyway: their series is parked on the
        reserved unregister id, and the replicated LRU evicts the server
        side eventually (lrusession semantics)."""
        timeout_s = timeout_s or self._register_timeout_s
        with self._mu:
            pool = self._pools.get((tenant_id, cluster_id), [])
            take = len(pool) if count is None else min(count, len(pool))
            victims, rest = pool[:take], pool[take:]
            self._pools[(tenant_id, cluster_id)] = rest
        if not victims:
            return 0
        self._front.admission.admit(tenant_id, KLASS_URGENT, n=len(victims))
        states = []
        for s in victims:
            s.prepare_for_unregister()
            states.append(self._nh.propose(s, b"", timeout_s))
        done = 0
        for s, rs in zip(victims, states):
            r = rs.wait(timeout_s + 1.0)
            if r.completed and r.result.value == s.client_id:
                done += 1
        with self._mu:
            self._counters["retired"] += done
        return done

    def adopt(self, tenant_id: int, cluster_id: int, session: Session) -> None:
        """Hand an ALREADY-REGISTERED session to this manager (failover:
        the dedup state is replicated, so a session registered through a
        crashed or deposed host keeps working through any live one)."""
        if session.cluster_id != cluster_id:
            raise ErrRejected()
        with self._mu:
            self._pools.setdefault((tenant_id, cluster_id), []).append(
                session
            )

    # ------------------------------------------------------------- checkout
    @contextlib.contextmanager
    def checkout(self, tenant_id: int, cluster_id: int):
        """Exclusive use of one pooled session (registered sessions are
        strictly sequential). Raises typed retryable ErrSessionExhausted
        when every session is mid-proposal."""
        with self._mu:
            pool = self._pools.get((tenant_id, cluster_id))
            if not pool:
                hint = self._front.config.pump_interval_s * 4
                raise ErrSessionExhausted(
                    retry_after_s=hint,
                    reason=f"tenant {tenant_id} cluster {cluster_id}: "
                    f"no idle session",
                )
            s = pool.pop()
        try:
            yield s
        finally:
            with self._mu:
                if id(s) in self._dead:
                    self._dead.discard(id(s))
                    self._counters["discarded"] += 1
                else:
                    self._pools.setdefault(
                        (tenant_id, cluster_id), []
                    ).append(s)

    # -------------------------------------------------------------- propose
    def propose(
        self,
        tenant_id: int,
        cluster_id: int,
        cmd: bytes,
        timeout_s: float,
        attempt_timeout_s: Optional[float] = None,
    ):
        """At-most-once propose: checkout a session, submit through the
        front's session lane, and retry indeterminate outcomes under the
        SAME series id until the deadline — an attempt that already
        applied completes with the RSM's cached result, so the op runs
        at most once no matter how many times the client had to ask.
        Returns the statemachine Result; acknowledges the session
        (proposal_completed) only after a completed result."""
        with self.checkout(tenant_id, cluster_id) as sess:
            submitted = [False]

            def attempt(remaining: float, session: Session):
                budget = remaining
                if attempt_timeout_s is not None:
                    budget = min(remaining, attempt_timeout_s)
                ticket = self._front.propose_session(
                    tenant_id, cluster_id, session, cmd, budget
                )
                submitted[0] = True
                r = ticket.wait()
                if r.completed:
                    return r.result
                if r.rejected:
                    # the replicated LRU evicted this session: dedup
                    # cover is gone, surface it (re-register to resume)
                    raise ErrRejected()
                if r.terminated:
                    raise ErrClusterClosed()
                # timeout / dropped: outcome unknown — SAFE to re-ask
                # under the same series (that is the whole point)
                with self._mu:
                    self._counters["safe_retries"] += 1
                raise ErrProposalIndeterminate(
                    retry_after_s=self._front.config.pump_interval_s
                )

            try:
                result = call_with_retries(attempt, timeout_s, session=sess)
            except Exception:
                if submitted[0]:
                    # the op's outcome is UNKNOWN and the budget is
                    # spent: this series may be applied server-side. A
                    # future op reusing it would collect THIS op's
                    # cached result — poison the session instead (it
                    # never returns to the pool; see checkout)
                    with self._mu:
                        self._dead.add(id(sess))
                raise
            sess.proposal_completed()
            with self._mu:
                self._counters["proposals"] += 1
            return result

    # ------------------------------------------------------------ introspect
    def pool_sizes(self) -> Dict[Tuple[int, int], int]:
        with self._mu:
            return {k: len(v) for k, v in self._pools.items()}

    def stats(self) -> dict:
        """Counter snapshot (always the same keys — bench/longhaul fold
        these into their JSON schemas)."""
        with self._mu:
            out = dict(self._counters)
        out["pooled"] = sum(self.pool_sizes().values())
        return out


__all__ = [
    "ErrProposalIndeterminate",
    "ErrSessionExhausted",
    "SessionManager",
]
