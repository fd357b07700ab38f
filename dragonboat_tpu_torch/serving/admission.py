"""Admission control: per-tenant token buckets + class-aware shedding.

The reference dragonboat's only overload defense is ErrSystemBusy when a
request pool is literally full (requests.go:267-329); everything before
that point queues unboundedly. This module is the missing front half of
the ROADMAP's multi-tenant serving item: every tenant owns a token
bucket, urgent control-plane work (ReadIndex, membership, session ops)
is admitted ahead of bulk proposals, and a saturation score folded from
real backpressure signals (see backpressure.py) tightens bulk admission
BEFORE queues grow — shed bulk first, never urgent.

Shed requests fail fast with a typed subclass of ErrSystemBusy carrying
a `retry_after_s` hint, so a well-behaved client (see retry.py) backs
off for exactly as long as the bucket/saturation math says instead of
hammering a saturated host.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..requests import ErrSystemBusy

# admission classes. Urgent = the control plane (ReadIndex, membership,
# session ops, leader transfer): low-volume, latency-sensitive, and the
# traffic that keeps the system STEERABLE under load — it is never shed
# by the saturation score, only by a literally full pool. Bulk = user
# proposals: high-volume and elastic, shed first.
KLASS_URGENT = "urgent"
KLASS_BULK = "bulk"
KLASSES = (KLASS_URGENT, KLASS_BULK)


class ErrOverloaded(ErrSystemBusy):
    """Base of the typed overload errors: ErrSystemBusy semantics (shed,
    fail fast, safe to retry) plus a machine-readable retry-after hint."""

    code = "overloaded, retry later"

    def __init__(self, retry_after_s: float = 0.0, reason: str = "") -> None:
        super().__init__(reason or self.code)
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.reason = reason


class ErrTenantThrottled(ErrOverloaded):
    """The tenant's own token bucket is empty: the hint is the refill
    time for the refused cost at the CURRENT (saturation-scaled) rate."""

    code = "tenant rate limit exceeded, retry later"


class ErrBackpressure(ErrOverloaded):
    """The host itself is saturated (WAL barrier / engine inbox / request
    pools): bulk sheds outright regardless of bucket balance."""

    code = "host saturated, retry later"


class TokenBucket:
    """Classic token bucket with an injectable clock (deterministic
    tests) and saturation scaling: `take(n, scale)` refills at
    rate*scale, so one knob tightens every tenant proportionally."""

    __slots__ = ("rate", "burst", "tokens", "_t", "_mu", "_clock")

    def __init__(
        self, rate: float, burst: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._t = clock()
        self._mu = threading.Lock()

    def take(self, n: float = 1.0, scale: float = 1.0) -> float:
        """Try to take n tokens; returns 0.0 on success, else the
        seconds until n tokens exist at the current effective rate (the
        retry-after hint). The failed take consumes nothing."""
        eff = self.rate * max(scale, 1e-9)
        if eff <= 0.0:
            # a zero-rate bucket (the natural way to block a tenant
            # outright) never refills: the honest hint is "never", which
            # the retry helper turns into an immediate ErrTimeout rather
            # than a sleep that outlives any deadline
            with self._mu:
                if self.tokens >= n:
                    self.tokens -= n
                    return 0.0
            return float("inf")
        with self._mu:
            # clock read INSIDE the lock: a preempted thread with a stale
            # `now` would move _t backwards and credit the same elapsed
            # interval as refill twice (systematic over-admission under
            # exactly the concurrent load this bucket exists to cap)
            now = self._clock()
            elapsed = max(now - self._t, 0.0)
            self._t = now
            self.tokens = min(self.burst, self.tokens + elapsed * eff)
            if self.tokens >= n:
                self.tokens -= n
                return 0.0
            return (n - self.tokens) / eff

    def balance(self) -> float:
        with self._mu:
            return self.tokens


@dataclass
class TenantSpec:
    """Per-tenant admission knobs. `rate` caps BULK proposals per second
    (urgent ops ride free — they are what keeps the tenant able to read
    and manage its groups while throttled); `weight` scales the fair-
    dequeue quantum (front.py)."""

    rate: float = 2000.0
    burst: float = 400.0
    weight: float = 1.0


@dataclass
class AdmissionConfig:
    """Controller-wide knobs: the default TenantSpec for unknown tenants,
    explicit per-tenant overrides, and the saturation response curve —
    full rate below `tighten_from`, linearly tightened down to
    `min_rate_scale` approaching `shed_bulk_at`, outright bulk shed at or
    above it. Urgent admission ignores the score entirely."""

    default: TenantSpec = field(default_factory=TenantSpec)
    tenants: Dict[int, TenantSpec] = field(default_factory=dict)
    tighten_from: float = 0.5
    shed_bulk_at: float = 0.9
    min_rate_scale: float = 0.1
    # retry-after floor for saturation sheds: the score has no natural
    # time unit, so the hint is "come back after roughly one admission
    # window" scaled by how deep into shed territory the host is
    backpressure_retry_s: float = 0.05


class _Tenant:
    __slots__ = ("tenant_id", "spec", "bucket",
                 "admitted", "shed", "wakes")

    def __init__(self, tenant_id: int, spec: TenantSpec, clock) -> None:
        self.tenant_id = tenant_id
        self.spec = spec
        self.bucket = TokenBucket(spec.rate, spec.burst, clock)
        # counters by class name; plain dict increments under the
        # controller lock
        self.admitted = {KLASS_URGENT: 0, KLASS_BULK: 0}
        self.shed = {KLASS_URGENT: 0, KLASS_BULK: 0}
        self.wakes = 0  # quiesced groups woken by this tenant's admits


class AdmissionController:
    """Admit/shed decisions for one serving front.

    `admit(tenant_id, klass, n)` either returns (admitted) or raises a
    typed ErrOverloaded subclass with a retry-after hint. The saturation
    score is supplied by a callable (backpressure.SaturationMonitor's
    `score`, or a lambda in tests) so the decision logic stays clockable
    and deterministic."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        saturation: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or AdmissionConfig()
        self._saturation = saturation or (lambda: 0.0)
        self._clock = clock
        self._mu = threading.Lock()
        self._tenants: Dict[int, _Tenant] = {}

    # ------------------------------------------------------------- tenants
    def tenant(self, tenant_id: int) -> _Tenant:
        with self._mu:
            t = self._tenants.get(tenant_id)
            if t is None:
                spec = self.config.tenants.get(
                    tenant_id, self.config.default
                )
                t = self._tenants[tenant_id] = _Tenant(
                    tenant_id, spec, self._clock
                )
            return t

    def set_tenant_spec(self, tenant_id: int, spec: TenantSpec) -> None:
        """Install/replace one tenant's knobs (storm profiles retune
        rates mid-run); the bucket is rebuilt, counters survive."""
        with self._mu:
            self.config.tenants[tenant_id] = spec
            t = self._tenants.get(tenant_id)
            if t is not None:
                t.spec = spec
                t.bucket = TokenBucket(spec.rate, spec.burst, self._clock)

    def tenants(self):
        with self._mu:
            return list(self._tenants.values())

    # ----------------------------------------------------------- decisions
    def rate_scale(self, score: float) -> float:
        """Saturation response curve: 1.0 below tighten_from, linear down
        to min_rate_scale at shed_bulk_at."""
        cfg = self.config
        if score <= cfg.tighten_from:
            return 1.0
        span = max(cfg.shed_bulk_at - cfg.tighten_from, 1e-9)
        frac = min((score - cfg.tighten_from) / span, 1.0)
        return 1.0 - frac * (1.0 - cfg.min_rate_scale)

    def admit(self, tenant_id: int, klass: str, n: float = 1.0) -> None:
        """Admit n ops of `klass` for tenant_id or raise. Urgent ops are
        always admitted here — their only refusal is the pool-full
        ErrSystemBusy deeper in the stack, which the caller surfaces
        as-is (and which counts as shed for accounting via
        note_downstream_shed)."""
        t = self.tenant(tenant_id)
        if klass == KLASS_URGENT:
            with self._mu:
                t.admitted[KLASS_URGENT] += int(n)
            return
        score = self._saturation()
        cfg = self.config
        if score >= cfg.shed_bulk_at:
            with self._mu:
                t.shed[KLASS_BULK] += int(n)
            depth = min((score - cfg.shed_bulk_at) / max(
                1.0 - cfg.shed_bulk_at, 1e-9), 1.0)
            raise ErrBackpressure(
                retry_after_s=cfg.backpressure_retry_s * (1.0 + 4.0 * depth),
                reason=f"saturation {score:.2f} >= {cfg.shed_bulk_at:.2f}",
            )
        wait = t.bucket.take(n, self.rate_scale(score))
        if wait > 0.0:
            with self._mu:
                t.shed[KLASS_BULK] += int(n)
            raise ErrTenantThrottled(
                retry_after_s=wait,
                reason=f"tenant {tenant_id} bucket empty",
            )
        with self._mu:
            t.admitted[KLASS_BULK] += int(n)

    def note_downstream_shed(
        self, tenant_id: int, klass: str, n: int = 1
    ) -> None:
        """An op admitted here was refused deeper in the stack (pool
        full / engine rate-limited): keep the shed ledger honest."""
        t = self.tenant(tenant_id)
        with self._mu:
            t.shed[klass] += n
            t.admitted[klass] = max(t.admitted[klass] - n, 0)

    def note_wake(self, tenant_id: int) -> None:
        t = self.tenant(tenant_id)
        with self._mu:
            t.wakes += 1

    # ------------------------------------------------------------ introspect
    def counters(self) -> Dict[int, dict]:
        """tenant_id -> {admitted: {klass: n}, shed: {klass: n}, wakes}."""
        out: Dict[int, dict] = {}
        with self._mu:
            for tid, t in self._tenants.items():
                out[tid] = {
                    "admitted": dict(t.admitted),
                    "shed": dict(t.shed),
                    "wakes": t.wakes,
                }
        return out


__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "ErrBackpressure",
    "ErrOverloaded",
    "ErrTenantThrottled",
    "KLASS_BULK",
    "KLASSES",
    "KLASS_URGENT",
    "TenantSpec",
    "TokenBucket",
]
