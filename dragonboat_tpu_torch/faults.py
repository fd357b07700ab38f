"""FaultPlane: deterministic, seeded fault injection as a first-class
subsystem.

The reference dragonboat validates itself with monkey tests (docs/
test.md:11-33): kill, partition, drop and corrupt while client traffic
runs, then assert linearizability + replica convergence. Here that
methodology is a library citizen instead of ad-hoc lambdas monkeypatched
into tests: ONE seed derives every fault decision, so any chaos failure
replays from the CI log by re-running with the printed seed.

Determinism model
-----------------
Every injection site (a named stream: "wire:h1", "fsync:h2/shard-3",
"faultloop", ...) owns an independent PRNG seeded from (plane seed, site
name). Decisions are drawn in per-site arrival order, so a site that is
only touched from one thread (per-target transport workers, the engine
loop, the orchestration loop) produces a bit-identical verdict sequence
on replay. Each decision is appended to a bounded schedule log;
`schedule_signature()` hashes it so tests can assert two same-seeded runs
produced identical schedules.

Seams composed (all pre-existing, none test-private):

  * transport wire path — `Transport.set_pre_send_batch_hook`: the hook
    mutates the batch in place (per-message drop/duplicate/reorder) and
    sleeps for delay faults on the per-target worker thread;
  * co-hosted delivery — `VectorEngine.set_local_drop_hook` for traffic
    that short-circuits the wire inside a shared core;
  * partitions — `NodeHost.set_partitioned` driven from the seeded
    orchestration stream (`partition_schedule`);
  * storage — `wrap_kv` / `kv_factory` wrap `IKVStore.sync`/commit with
    fsync-stall and fsync-error injection; `tear_wal_tail` simulates the
    torn-tail crash write.
"""
from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .storage.kv import IKVStore, WriteBatch, _BarrierStats
from .trace import flight_recorder
from .types import Message, MessageBatch, MessageType


@dataclass
class FaultSpec:
    """Per-message / per-sync fault probabilities. All default to off."""

    drop: float = 0.0  # P(message dropped)
    duplicate: float = 0.0  # P(message duplicated in-batch)
    reorder: float = 0.0  # P(message held back and re-injected later)
    reorder_hold: int = 2  # batches a reordered message is held for
    delay: float = 0.0  # P(batch delayed on the worker thread)
    delay_s: Tuple[float, float] = (0.001, 0.02)
    fsync_stall: float = 0.0  # P(sync stalls)
    fsync_stall_s: Tuple[float, float] = (0.002, 0.02)
    fsync_error: float = 0.0  # P(sync raises IOError)
    append_error: float = 0.0  # P(one WAL record append raises IOError)
    # P(a crash_restart window also tears the victim's WAL tail before
    # the restart) — the mid-write power-cut on top of the process death
    tear_tail: float = 0.0
    # restrict wire faults to these types (None = all); lets a schedule
    # target e.g. replication only while heartbeats flow
    only_types: Optional[frozenset] = None

    def wire_active(self) -> bool:
        return bool(self.drop or self.duplicate or self.reorder or self.delay)


class _Stream:
    """One deterministic decision stream: seeded RNG + decision counter."""

    __slots__ = ("rng", "n", "mu")

    def __init__(self, plane_seed: int, site: str) -> None:
        digest = hashlib.sha256(
            f"{plane_seed}:{site}".encode()
        ).digest()
        self.rng = random.Random(int.from_bytes(digest[:8], "big"))
        self.n = 0
        self.mu = threading.Lock()


class FaultPlane:
    """Deterministic fault scheduler; see module docstring.

    `install(nh, site)` arms the wire seams of one NodeHost;
    `partition_schedule` drives partitions from the seeded orchestration
    stream; `wrap_kv`/`kv_factory` cover storage. The spec can be swapped
    live (`set_spec`) to open/close fault windows mid-run."""

    def __init__(
        self,
        seed: int,
        spec: Optional[FaultSpec] = None,
        record_schedule: bool = True,
        max_log: int = 200_000,
    ) -> None:
        self.seed = seed
        self.spec = spec or FaultSpec()
        self._streams: Dict[str, _Stream] = {}
        self._streams_mu = threading.Lock()
        self._log: List[tuple] = []
        self._log_mu = threading.Lock()
        self._record = record_schedule
        self._max_log = max_log
        self._installed: List[tuple] = []  # (kind, target) for uninstall
        # reorder holding pens: site -> list of (release_at_batch, Message)
        self._held: Dict[str, list] = {}
        self._batch_no: Dict[str, int] = {}

    # ------------------------------------------------------------- streams
    def _stream(self, site: str) -> _Stream:
        s = self._streams.get(site)
        if s is None:
            with self._streams_mu:
                s = self._streams.setdefault(site, _Stream(self.seed, site))
        return s

    def decide(self, site: str, kind: str, p: float) -> bool:
        """Draw one fault decision on `site`'s stream; logged for replay
        verification."""
        if p <= 0.0:
            return False
        s = self._stream(site)
        with s.mu:
            n = s.n
            s.n += 1
            verdict = s.rng.random() < p
        self._log_decision(site, kind, n, verdict)
        if verdict:
            # only FIRED faults hit the flight recorder: the timeline
            # answers "what was injected when", not "what was rolled"
            flight_recorder().record(
                "fault_injected", site=site, kind=kind, n=n,
                seed=self.seed,
            )
        return verdict

    def uniform(self, site: str, kind: str, lo: float, hi: float) -> float:
        s = self._stream(site)
        with s.mu:
            n = s.n
            s.n += 1
            v = lo + (hi - lo) * s.rng.random()
        self._log_decision(site, kind, n, round(v, 9))
        return v

    def choice(self, site: str, kind: str, options):
        """Seeded choice for orchestration loops (fault kind, victim)."""
        s = self._stream(site)
        with s.mu:
            n = s.n
            s.n += 1
            v = options[int(s.rng.random() * len(options)) % len(options)]
        self._log_decision(site, kind, n, v)
        return v

    def _log_decision(self, site, kind, n, verdict) -> None:
        if not self._record:
            return
        with self._log_mu:
            if len(self._log) < self._max_log:
                self._log.append((site, kind, n, verdict))

    def schedule_log(self) -> List[tuple]:
        with self._log_mu:
            return list(self._log)

    def schedule_signature(self, sites=None) -> str:
        """Stable digest of the schedule, ORDER-INSENSITIVE across sites
        (thread interleaving between sites is not deterministic; the
        per-site sequence is). `sites` restricts the digest to those
        site streams — orchestration loops use this to print a signature
        that is bit-identical across same-seeded replays even while
        per-message wire draws (whose COUNT depends on traffic timing)
        ride the same plane."""
        with self._log_mu:
            lines = sorted(
                repr(e) for e in self._log
                if sites is None or e[0] in sites
            )
        h = hashlib.sha256()
        for ln in lines:
            h.update(ln.encode())
            h.update(b"\n")
        return h.hexdigest()

    def set_spec(self, spec: FaultSpec) -> None:
        """Swap the live fault probabilities (open/close a fault window).
        Streams and their positions are preserved, so a window change does
        not desynchronize replay."""
        self.spec = spec

    # -------------------------------------------------------- wire faults
    def batch_hook(self, site: str) -> Callable[[MessageBatch], bool]:
        """Pre-send hook for `Transport.set_pre_send_batch_hook`: applies
        per-message drop/duplicate/reorder by mutating batch.requests and
        per-batch delay by sleeping on the (per-target) worker thread.
        Returns False when the whole batch should drop."""

        def hook(batch: MessageBatch) -> bool:
            # one Transport runs one worker thread PER TARGET address, and
            # all of them share this hook: sub-key the stream and the
            # reorder pen by the (stable) worker thread name so each
            # stream stays single-threaded — the determinism contract —
            # and the pen is never mutated concurrently
            site_t = f"{site}#{threading.current_thread().name}"
            spec = self.spec
            held = self._held.setdefault(site_t, [])
            active = spec.wire_active()
            if not active and not held:
                return True
            bno = self._batch_no.get(site_t, 0) + 1
            self._batch_no[site_t] = bno
            out: List[Message] = []
            # release previously held (reordered) messages first: they
            # jump the queue relative to their original position. The pen
            # drains even after the fault window closes — a held message
            # must never be silently leaked.
            if held:
                due = [m for rel, m in held if rel <= bno or not active]
                held[:] = [] if not active else [
                    (rel, m) for rel, m in held if rel > bno
                ]
                out.extend(due)
            if not active:
                out.extend(batch.requests)
                batch.requests[:] = out
                return True
            for m in batch.requests:
                targeted = spec.only_types is None or m.type in spec.only_types
                if targeted and self.decide(site_t, "drop", spec.drop):
                    continue
                if targeted and self.decide(site_t, "reorder", spec.reorder):
                    held.append((bno + spec.reorder_hold, m))
                    continue
                out.append(m)
                if targeted and self.decide(site_t, "dup", spec.duplicate):
                    out.append(m)
            batch.requests[:] = out
            if spec.delay and self.decide(site_t, "delay", spec.delay):
                time.sleep(
                    self.uniform(site_t, "delay_s", *spec.delay_s)
                )
            return bool(batch.requests)

        return hook

    def message_hook(self, site: str) -> Callable[[Message], bool]:
        """Drop predicate for co-hosted delivery
        (`VectorEngine.set_local_drop_hook`): True = drop. Duplicate/
        reorder/delay do not apply on the in-core path — it models a
        shared-memory exchange, not a lossy wire."""

        def hook(m: Message) -> bool:
            spec = self.spec
            if not spec.drop:
                return False
            if spec.only_types is not None and m.type not in spec.only_types:
                return False
            return self.decide(site, "local_drop", spec.drop)

        return hook

    def install(self, nh, site: str) -> None:
        """Arm one NodeHost's wire seams: the transport pre-send hook and,
        when its engine is a (possibly shared) vector core, the co-hosted
        delivery drop hook."""
        nh.transport.set_pre_send_batch_hook(self.batch_hook(f"wire:{site}"))
        core = getattr(nh.engine, "core", None) or nh.engine
        set_local = getattr(core, "set_local_drop_hook", None)
        if set_local is not None:
            set_local(self.message_hook(f"local:{site}"))
            self._installed.append(("local", core))
        self._installed.append(("wire", nh.transport))

    def uninstall(self, nh) -> None:
        """Disarm one NodeHost's wire seams (the windowed-fault path: arm
        the victim, sleep the window, disarm)."""
        nh.transport.set_pre_send_batch_hook(None)
        core = getattr(nh.engine, "core", None) or nh.engine
        set_local = getattr(core, "set_local_drop_hook", None)
        if set_local is not None:
            set_local(None)
        self._installed = [
            (k, t)
            for k, t in self._installed
            if t is not nh.transport and t is not core
        ]

    def uninstall_all(self) -> None:
        for kind, target in self._installed:
            try:
                if kind == "wire":
                    target.set_pre_send_batch_hook(None)
                else:
                    target.set_local_drop_hook(None)
            except Exception:
                pass
        self._installed.clear()

    # -------------------------------------------------------- partitions
    def partition_schedule(
        self,
        site: str,
        victims,
        total_s: float,
        min_window_s: float = 0.3,
        max_window_s: float = 0.8,
    ):
        """Yield a seeded sequence of (victim, heal_after_s, idle_s)
        partition windows covering ~total_s seconds. The caller applies
        them (`nh.set_partitioned(True)`, sleep, heal, sleep) so restarts
        and other orchestration can interleave."""
        budget = total_s
        victims = list(victims)
        while budget > 0:
            victim = self.choice(site, "victim", victims)
            window = self.uniform(site, "window", min_window_s, max_window_s)
            idle = self.uniform(site, "idle", 0.1, 0.4)
            flight_recorder().record(
                "partition_window", site=site, victim=victim,
                window_s=round(window, 4), seed=self.seed,
            )
            yield victim, window, idle
            budget -= window + idle

    # -------------------------------------------------- crash / restart
    def crash_restart_schedule(
        self,
        site: str,
        victims,
        total_s: float,
        min_down_s: float = 0.1,
        max_down_s: float = 0.5,
        tear_tail: Optional[float] = None,
    ):
        """Yield a seeded sequence of (victim, down_s, idle_s, tear)
        crash/restart windows covering ~total_s seconds — restart as a
        first-class FaultPlane verdict (the reference's drummer/monkey
        kill schedule, docs/test.md). The caller executes each window:
        crash the victim (NodeHost.crash() for process-death semantics,
        or crash_cluster() for one node of a multi-group host), wait the
        seeded down_s restart delay — during which the surviving quorum
        must keep serving (the graceful-degradation guarantee the
        fairness watchdog asserts) — then restart (a fresh NodeHost on
        the durable dir / restart_cluster) and idle idle_s. tear=True
        directs the caller to run tear_wal_tails() on the victim's
        closed WAL dir before the restart. All decisions ride this
        site's single stream, so a same-seeded rerun replays the crash
        schedule bit-identically (schedule_signature)."""
        budget = total_s
        victims = list(victims)
        p_tear = self.spec.tear_tail if tear_tail is None else tear_tail
        while budget > 0:
            victim = self.choice(site, "crash_victim", victims)
            down = self.uniform(site, "down_s", min_down_s, max_down_s)
            idle = self.uniform(site, "crash_idle", 0.1, 0.4)
            tear = self.decide(site, "tear_tail", p_tear)
            flight_recorder().record(
                "crash_restart_window", site=site, victim=victim,
                down_s=round(down, 4), tear=tear, seed=self.seed,
            )
            yield victim, down, idle, tear
            budget -= down + idle

    # ----------------------------------------------------- overload storms
    def overload_storm_schedule(
        self,
        site: str,
        tenants,
        total_s: float,
        min_window_s: float = 0.2,
        max_window_s: float = 0.6,
    ):
        """Yield a seeded sequence of (profile, mult, window_s, weights)
        overload windows covering ~total_s seconds — the serving front's
        storm scenario (see serving/storm.py). `profile` is "burst"
        (short, 2-4x offered load) or "sustained" (longer, 1.5-2.5x);
        `mult` multiplies each tenant's admitted capacity into its
        OFFERED load; `weights` skews the tenant mix per window (seeded
        per tenant in sorted order, so the draw sequence — and the
        schedule signature — replays bit-identically for the same
        seed). The caller drives traffic per window; op counts derived
        from (mult, window_s) keep the replayed op sequence identical
        without wall-clock coupling."""
        budget = total_s
        tenants = sorted(tenants)
        while budget > 0:
            profile = self.choice(
                site, "storm_profile", ["burst", "sustained"]
            )
            if profile == "burst":
                mult = self.uniform(site, "storm_mult", 2.0, 4.0)
                window = self.uniform(
                    site, "storm_window", min_window_s,
                    (min_window_s + max_window_s) / 2,
                )
            else:
                mult = self.uniform(site, "storm_mult", 1.5, 2.5)
                window = self.uniform(
                    site, "storm_window",
                    (min_window_s + max_window_s) / 2, max_window_s,
                )
            weights = {
                t: round(self.uniform(site, "storm_weight", 0.5, 2.0), 6)
                for t in tenants
            }
            flight_recorder().record(
                "overload_storm_window", site=site, profile=profile,
                mult=round(mult, 4), window_s=round(window, 4),
                seed=self.seed,
            )
            yield profile, mult, window, weights
            budget -= window

    def tear_wal_tails(self, logdb_dir: str, site: str) -> int:
        """Tear the tail of every shard WAL under a CLOSED ShardedLogDB
        root (shard-<i>/wal.log) — the disk half of a crash_restart
        window with tear=True. Each shard tears on its own seeded
        stream. Returns total bytes removed; recovery must roll every
        shard back to its last sealed record group."""
        total = 0
        if not logdb_dir or not os.path.isdir(logdb_dir):
            return 0
        for name in sorted(os.listdir(logdb_dir)):
            d = os.path.join(logdb_dir, name)
            if name.startswith("shard-") and os.path.isdir(d):
                total += self.tear_wal_tail(d, f"{site}/{name}")
        return total

    # ----------------------------------------------------- storage faults
    def wrap_kv(self, kv: IKVStore, site: str) -> "FaultyKV":
        return FaultyKV(kv, self, site)

    def kv_factory(
        self, site: str, base_factory: Callable[[str], IKVStore]
    ) -> Callable[[str], IKVStore]:
        """Factory adapter for ShardedLogDB(kv_factory=...): every shard's
        store is wrapped with fsync fault injection on its own stream."""

        def make(dirname: str) -> IKVStore:
            shard = os.path.basename(dirname) if dirname else "mem"
            return self.wrap_kv(base_factory(dirname), f"{site}/{shard}")

        return make

    def maybe_append_fault(self, site: str) -> None:
        """Injection point FaultyKV arms on the store's per-record append
        seam (`WalKV.set_append_fault`): raises mid-record-group, BEFORE
        the commit seal, so the store's rollback path — not recovery
        luck — must guarantee no half-sealed group survives a reopen."""
        spec = self.spec
        if spec.append_error and self.decide(
            site, "append_error", spec.append_error
        ):
            raise IOError(
                f"FaultPlane(seed={self.seed}): injected append error"
            )

    def maybe_fsync_fault(self, site: str) -> None:
        """The injection point FaultyKV runs before a durability barrier."""
        spec = self.spec
        if spec.fsync_stall and self.decide(site, "fsync_stall", spec.fsync_stall):
            time.sleep(self.uniform(site, "fsync_stall_s", *spec.fsync_stall_s))
        if spec.fsync_error and self.decide(site, "fsync_error", spec.fsync_error):
            raise IOError(f"FaultPlane(seed={self.seed}): injected fsync error")

    def tear_wal_tail(self, wal_dir: str, site: str) -> int:
        """Simulate a torn tail write: chop a seeded number of bytes off
        the WAL's end (the store must be closed). Returns bytes removed;
        recovery must roll back to the last sealed record group."""
        path = os.path.join(wal_dir, "wal.log")
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size == 0:
            return 0
        cut = 1 + int(self.uniform(site, "tear", 0, min(size - 1, 64)))
        with open(path, "ab") as f:
            f.truncate(size - cut)
        return cut


class FaultyKV(IKVStore):
    """Delegating IKVStore wrapper that injects fsync stalls/errors at the
    durability barriers (commit_write_batch's implicit barrier and the
    group-commit sync())."""

    def __init__(self, inner: IKVStore, plane: FaultPlane, site: str) -> None:
        self.inner = inner
        self.plane = plane
        self.site = site
        self._fsync_observer = None
        # the wrapper's OWN barrier ledger: ShardedLogDB.barrier_stats()
        # aggregates per-store `bstats`, and with the wrapper in front
        # the inner store's ledger is unreachable — worse, the inner
        # ledger times only the REAL fsync, so an injected stall would
        # vanish from the per-host WAL pressure signal (and from
        # tools.doctor's wal_fsync_stall evidence) exactly when it
        # matters most
        self.bstats = _BarrierStats()
        # arm the per-record append seam when the store exposes one
        # (WalKV): the fault fires INSIDE a record group, before the
        # commit seal, which is the torn-batch case fsync faults can't
        # reach
        set_af = getattr(inner, "set_append_fault", None)
        if set_af is not None:
            set_af(lambda: plane.maybe_append_fault(site))

    def name(self) -> str:
        return f"faulty-{self.inner.name()}"

    def close(self) -> None:
        self.inner.close()

    def close_crashed(self) -> None:
        cc = getattr(self.inner, "close_crashed", None)
        (cc if cc is not None else self.inner.close)()

    def get_value(self, key):
        return self.inner.get_value(key)

    def iterate_value(self, fk, lk, inc_last, op) -> None:
        self.inner.iterate_value(fk, lk, inc_last, op)

    def _timed_barrier(self, fn) -> None:
        """Run one durability barrier (injected fault + the real thing)
        under the fsync observer's clock: the histogram must see the
        EFFECTIVE barrier latency including injected stalls, or a chaos
        run's fsync_latency p99 would never line up with its
        fault_injected{kind="fsync_stall"} timeline."""
        obs = self._fsync_observer
        t0 = time.monotonic()
        self.bstats.enter()
        try:
            self.plane.maybe_fsync_fault(self.site)
            fn()
        finally:
            self.bstats.exit(time.monotonic() - t0)
        if obs is not None:
            obs(time.monotonic() - t0)

    def commit_write_batch(self, wb: WriteBatch) -> None:
        self._timed_barrier(lambda: self.inner.commit_write_batch(wb))

    def commit_write_batch_deferred(self, wb: WriteBatch) -> bool:
        return self.inner.commit_write_batch_deferred(wb)

    def sync(self) -> None:
        self._timed_barrier(self.inner.sync)

    def set_fsync_observer(self, cb) -> None:
        # observation stays at the WRAPPER (not forwarded to the inner
        # store) so injected stalls are part of the measured barrier
        self._fsync_observer = cb

    def bulk_remove_entries(self, fk, lk) -> None:
        self.inner.bulk_remove_entries(fk, lk)

    def compact_entries(self, fk, lk) -> None:
        self.inner.compact_entries(fk, lk)

    def full_compaction(self) -> None:
        self.inner.full_compaction()


class ClockPlane:
    """Seeded clock-fault injection for the tick plane.

    Raft here has no wall clock: every timeout is counted in ticks, and
    ticks are minted by each NodeHost's tick worker off a monotonic
    clock. A machine whose clock skews, drifts or step-jumps therefore
    shows up as a tick stream that runs fast, slow, or lurches — exactly
    the failure a leader lease must survive. ClockPlane models that by
    owning an injectable per-host clock (`clock_fn(host)`) that NodeHost
    substitutes for `time.monotonic` in its tick worker.

    Per host the faulted clock is a piecewise-linear transform of real
    monotonic time: ``fault(t) = f0 + (t - r0) * rate``. Mutations
    re-anchor (r0, f0) at the current faulted reading first, so:

      * `set_skew` / `step_jump` — add an instant offset (negative jumps
        make the clock read BACKWARD, the anomaly the tick worker must
        detect rather than replay as a tick burst);
      * `set_drift` — change the rate (0.5 = half speed, 2.0 = double);
      * `clear` — pin rate back to 1.0 while keeping the accumulated
        offset (continuity: healing a drift must not itself be a jump).

    The transform is draw-free, so the *clock* needs no replay contract;
    the seeded part is `chaos_schedule`, whose decisions ride the owning
    FaultPlane's streams and land in its schedule log — the same
    bit-identical `schedule_signature()` replay contract as
    `crash_restart_schedule`."""

    def __init__(self, plane: FaultPlane) -> None:
        self.plane = plane
        self._mu = threading.Lock()
        # host -> [anchor_real r0, anchor_fault f0, rate]
        self._hosts: Dict[str, list] = {}

    # ------------------------------------------------------------ reading
    def now(self, host) -> float:
        real = time.monotonic()
        with self._mu:
            st = self._hosts.get(host)
            if st is None:
                return real
            r0, f0, rate = st
        return f0 + (real - r0) * rate

    def clock_fn(self, host) -> Callable[[], float]:
        """The injectable clock a NodeHost mounts in its tick worker
        (`NodeHost.set_tick_clock`). Hosts without injected faults read
        real monotonic time, so mounting the plane everywhere is free."""
        return lambda: self.now(host)

    # ---------------------------------------------------------- mutations
    def _reanchor_locked(self, host) -> list:
        """Pin (r0, f0) at the current faulted reading so the mutation
        about to follow is continuous. Caller holds self._mu."""
        real = time.monotonic()
        st = self._hosts.get(host)
        if st is None:
            st = [real, real, 1.0]
            self._hosts[host] = st
        else:
            r0, f0, rate = st
            st[0] = real
            st[1] = f0 + (real - r0) * rate
        return st

    def set_skew(self, host, offset_s: float) -> None:
        """Step the host's clock by offset_s (instant, signed)."""
        with self._mu:
            self._reanchor_locked(host)[1] += float(offset_s)

    def step_jump(self, host, offset_s: float) -> None:
        """A large instant step — same mechanics as `set_skew`, named
        separately so fault schedules and flight-recorder timelines can
        distinguish sub-tick skew from multi-tick lurches."""
        self.set_skew(host, offset_s)

    def set_drift(self, host, rate: float) -> None:
        """Run the host's clock at `rate` × real time from now on."""
        with self._mu:
            self._reanchor_locked(host)[2] = max(float(rate), 0.0)

    def clear(self, host) -> None:
        """Heal drift (rate back to 1.0) keeping the accumulated offset;
        clearing must not itself inject a jump."""
        with self._mu:
            self._reanchor_locked(host)[2] = 1.0

    def reset(self, host) -> None:
        """Drop all fault state: the host reads real time again. This IS
        a (possibly backward) jump — use `clear` for a continuous heal."""
        with self._mu:
            self._hosts.pop(host, None)

    # ----------------------------------------------------------- schedule
    def chaos_schedule(
        self,
        site: str,
        hosts,
        total_s: float,
        min_window_s: float = 0.2,
        max_window_s: float = 0.8,
    ):
        """Yield a seeded sequence of (host, kind, magnitude, window_s,
        idle_s) clock-fault windows covering ~total_s seconds. kind is
        "skew" (± fractions of a second), "drift" (rate 0.25..3.0) or
        "jump" (± seconds, enough to cross tick-burst and backward-
        reading thresholds). The caller applies each window
        (`apply(host, kind, magnitude)`, sleep window_s, `clear(host)`,
        sleep idle_s) so clock chaos interleaves with crash/partition
        orchestration. All draws ride the owning FaultPlane's `site`
        stream — same-seeded reruns replay the schedule bit-identically
        (schedule_signature)."""
        budget = total_s
        hosts = list(hosts)
        plane = self.plane
        while budget > 0:
            host = plane.choice(site, "clock_host", hosts)
            kind = plane.choice(
                site, "clock_kind", ["skew", "drift", "jump"]
            )
            if kind == "skew":
                mag = plane.uniform(site, "clock_skew_s", -0.25, 0.25)
            elif kind == "drift":
                mag = plane.uniform(site, "clock_rate", 0.25, 3.0)
            else:
                mag = plane.uniform(site, "clock_jump_s", -2.0, 2.0)
            window = plane.uniform(
                site, "clock_window", min_window_s, max_window_s
            )
            idle = plane.uniform(site, "clock_idle", 0.05, 0.3)
            flight_recorder().record(
                "clock_fault_window", site=site, host=host, kind=kind,
                magnitude=round(mag, 4), window_s=round(window, 4),
                seed=plane.seed,
            )
            yield host, kind, mag, window, idle
            budget -= window + idle

    def apply(self, host, kind: str, magnitude: float) -> None:
        """Apply one schedule entry to the live clock."""
        if kind == "drift":
            self.set_drift(host, magnitude)
        elif kind == "jump":
            self.step_jump(host, magnitude)
        else:
            self.set_skew(host, magnitude)


# message classes a chaos schedule usually wants to target (bulk data
# plane) while the control plane keeps flowing
REPLICATION_TYPES = frozenset(
    {MessageType.REPLICATE, MessageType.REPLICATE_RESP}
)


__all__ = [
    "ClockPlane",
    "FaultPlane",
    "FaultSpec",
    "FaultyKV",
    "REPLICATION_TYPES",
]
