"""End-to-end backpressure: one saturation score from real signals.

Admission that only looks at its own queues is blind to the actual
bottlenecks. The monitor folds the three places this system genuinely
saturates into one score in [0, 1]:

  * the WAL durability barrier — storage/kv.py's barrier stats: the
    EWMA of fsync/sync_all wall latency and the number of concurrently
    in-flight barriers (the "fsync queue depth");
  * the engine ingest plane — VectorEngine.pressure_stats(): inbox-row
    occupancy and the staged-row backlog carried between steps, both
    maintained by the step loop from data it already touches (zero
    device syncs); the scalar ExecEngine reports its queue fills;
  * the request pools — Node ingress stats via NodeHost.ingress_fill():
    the incoming-proposal/read queue fill fractions that, once full,
    are exactly the ErrSystemBusy raise sites in requests.py.

The score is the MAX of the normalized signals (bottleneck semantics: a
saturated WAL is saturated no matter how empty the inbox is), cached
for `interval_s` so per-request admission costs a float compare, not a
stats sweep.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..storage import kv as _kv


@dataclass
class SaturationThresholds:
    """What "full" means per signal: the value at which that signal alone
    drives the score to 1.0."""

    # WAL barrier EWMA latency considered saturated (50ms: an engine step
    # paying this per save wave has lost an order of magnitude of
    # throughput headroom)
    fsync_ewma_full_s: float = 0.05
    # concurrently in-flight durability barriers considered saturated
    fsync_inflight_full: int = 8
    # staged rows carried between engine steps considered saturated
    # (leftover staged work means the inbox could not drain the offered
    # load for several consecutive steps)
    staged_backlog_full: int = 512


class SaturationMonitor:
    """Folds the backpressure sources of one NodeHost into a cached
    score; `score()` is what AdmissionController consults per request.

    Every source is optional (getattr-probed), so the monitor works on
    scalar engines, memory-only logdbs, and in tests that fake a single
    signal."""

    def __init__(
        self,
        nh=None,
        thresholds: Optional[SaturationThresholds] = None,
        interval_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._nh = nh
        self.thresholds = thresholds or SaturationThresholds()
        self.interval_s = interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._cached = 0.0
        self._cached_at = -1e9
        self._last_signals: Dict[str, float] = {}
        # test/storm override: force a score (None = live signals)
        self._override: Optional[float] = None

    # ------------------------------------------------------------- control
    def set_override(self, score: Optional[float]) -> None:
        """Pin the score (storm drills + deterministic tests); None
        returns to live signals."""
        self._override = score

    # ------------------------------------------------------------- signals
    def signals(self) -> Dict[str, float]:
        """One normalized sample per source, each in [0, 1]."""
        th = self.thresholds
        out: Dict[str, float] = {}
        # prefer the monitored host's OWN logdb barrier gauge: in a
        # multi-host process (tools.longhaul runs 3-4), one host's fsync
        # stall must not shed a healthy co-hosted front's traffic. The
        # process-global gauge is the hostless/test fallback.
        bs = None
        host_bs = getattr(
            getattr(self._nh, "logdb", None), "barrier_stats", None
        )
        if host_bs is not None:
            bs = host_bs()
        if bs is None:
            bs = _kv.barrier_stats()
        out["fsync_latency"] = min(
            bs["ewma_s"] / max(th.fsync_ewma_full_s, 1e-9), 1.0
        )
        out["fsync_inflight"] = min(
            bs["inflight"] / max(th.fsync_inflight_full, 1), 1.0
        )
        nh = self._nh
        if nh is not None:
            pressure = getattr(
                getattr(nh, "engine", None), "pressure_stats", None
            )
            if pressure is not None:
                p = pressure()
                out["engine_inbox"] = min(
                    max(p.get("inbox_occupancy", 0.0), 0.0), 1.0
                )
                out["engine_staged"] = min(
                    p.get("staged_backlog", 0)
                    / max(th.staged_backlog_full, 1),
                    1.0,
                )
            fill = getattr(nh, "ingress_fill", None)
            if fill is not None:
                out["request_pool"] = min(max(fill(), 0.0), 1.0)
        return out

    def score(self) -> float:
        """The folded score, recomputed at most every interval_s."""
        if self._override is not None:
            return self._override
        now = self._clock()
        with self._mu:
            if now - self._cached_at < self.interval_s:
                return self._cached
            # mark before sampling so concurrent callers don't stampede
            self._cached_at = now
        sig = self.signals()
        score = max(sig.values()) if sig else 0.0
        with self._mu:
            self._cached = score
            self._last_signals = sig
        return score

    def last_signals(self) -> Dict[str, float]:
        with self._mu:
            return dict(self._last_signals)


__all__ = ["SaturationMonitor", "SaturationThresholds"]
