"""Load-aware group placement with live migration.

The serving half of the millions-of-users work: the admission plane
lets a host KNOW it is saturated (the folded saturation score) and the
rejoin plane gives it the primitives to MOVE work (leadership transfer +
offset-resumable streamed snapshot install); this module is the brain
between them. A per-host PlacementPlane

  * folds a LOAD MODEL from the host's saturation score, the per-lane
    engine gauges (`lane_stats`: commit gap + last-index ingest rate —
    numpy-mirror reads, zero device syncs) and the per-tenant serving
    latency histograms (the (tenant, klass)-keyed plane the front
    feeds);
  * DECIDES which hot groups to move off a saturated host: groups
    ranked by heat (ingest rate + commit gap), targets ranked by their
    own advertised load, fresh node ids allocated past the group's
    membership (removed ids are never reused);
  * EXECUTES live migration entirely OFF the engine step loop, on the
    caller's thread or the plane's own pacer: add the new member on the
    target host → the leader catches it up (streamed snapshot install
    when compacted past — the resume-capable chunk path, tagged
    so migration streams are countable) → transfer leadership off the
    local replica when it leads → remove the local member → detach the
    local node. Every protocol step is a plain client-visible request;
    the step loop never blocks on a migration.

Admission-awareness: each migration step spends a BULK-class token of a
reserved migration tenant through the front's AdmissionController —
migration traffic is elastic by construction, so it is tightened and
shed exactly like user bulk load and can never starve the urgent class
(reads, session ops, membership changes of real tenants). A shed step
aborts the migration with the typed, retry-hinted ErrMigrationAborted;
the group stays where it was and keeps serving.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..requests import ErrMigrationAborted, RequestError
from ..trace import flight_recorder
from .admission import ErrOverloaded, KLASS_BULK

# reserved tenant id for migration traffic: its bulk bucket paces the
# migration's protocol steps, and its ledger line keeps the admitted/
# shed accounting of migrations separate from user tenants
MIGRATION_TENANT = -1


@dataclass
class PlacementConfig:
    """Placement knobs. `rebalance_at` is the saturation score at which
    the plane starts planning moves; `p99_rebalance_s` additionally
    triggers on the worst tenant's bulk p99 (0 disables). A target is
    eligible only when its advertised load sits `target_headroom` below
    this host's score — moving heat onto an equally hot box is churn,
    not balancing."""

    interval_s: float = 2.0
    rebalance_at: float = 0.6
    p99_rebalance_s: float = 0.0
    target_headroom: float = 0.1
    max_concurrent: int = 1
    # catch-up: the new member must be within `catchup_gap` entries of
    # the local applied index before leadership/removal proceed
    catchup_gap: int = 8
    catchup_timeout_s: float = 60.0
    transfer_timeout_s: float = 20.0
    config_change_timeout_s: float = 10.0
    poll_s: float = 0.05
    tenant_id: int = MIGRATION_TENANT
    # retry hint stamped on a catch-up/transfer abort: roughly one
    # snapshot-status retry window — when a re-streamed install should
    # have landed
    abort_retry_s: float = 2.0


@dataclass
class MigrationTarget:
    """One candidate destination host. The callbacks keep the plane
    deployment-agnostic: in-process harnesses bind them to a live
    NodeHost (`host_target`), a real deployment to its control plane."""

    address: str
    # start the joining replica on the target (join=True start_cluster)
    start_replica: Callable[[int, int], None]
    # the target's applied index for a cluster (catch-up probe)
    applied_index: Callable[[int], int]
    # the target's own load in [0, 1] (saturation score or equivalent)
    load: Callable[[], float] = lambda: 0.0
    # optional: mark the cluster migrating on the target so its inbound
    # chunk tracker tags the install stream (transport/chunks.py)
    mark_migrating: Optional[Callable[[int, bool], None]] = None


@dataclass
class MigrationPlan:
    cluster_id: int
    local_node_id: int
    new_node_id: int
    target: MigrationTarget
    reason: str = ""
    heat: float = 0.0


def host_target(nh, sm_factory, config_factory) -> MigrationTarget:
    """Bind a MigrationTarget to a live in-process NodeHost (tests,
    longhaul, bench). `config_factory(cluster_id, node_id)` returns the
    joiner's Config; witnesses/observers are not migration targets."""

    def start(cluster_id: int, node_id: int) -> None:
        nh.start_cluster(
            {}, True, sm_factory, config_factory(cluster_id, node_id)
        )

    def applied(cluster_id: int) -> int:
        try:
            return nh.get_applied_index(cluster_id)
        except RequestError:
            return 0

    def load() -> float:
        front = getattr(nh, "_serving", None)
        if front is not None:
            return front.monitor.score()
        return 0.0

    return MigrationTarget(
        address=nh.raft_address(),
        start_replica=start,
        applied_index=applied,
        load=load,
        mark_migrating=nh.mark_migrating,
    )


class PlacementPlane:
    """One host's placement brain. Construct via
    `NodeHost.placement_plane(targets)` (which also wires gauge export
    and teardown); `rebalance_once()` is the synchronous entry point,
    `start()` runs it on the plane's own pacer thread — never on the
    engine step loop."""

    def __init__(
        self,
        nh,
        targets: List[MigrationTarget],
        config: Optional[PlacementConfig] = None,
        front=None,
    ) -> None:
        self._nh = nh
        self.targets = list(targets)
        self.config = config or PlacementConfig()
        self.front = front if front is not None else nh.serving_front()
        self._mu = threading.Lock()
        # cluster_id -> (last_index, mono_t) from the previous model fold
        self._last_lanes: Dict[int, tuple] = {}
        self._active: Dict[int, MigrationPlan] = {}
        self._abort = False
        self._counters = {
            "migrations_started": 0,
            "migrations_completed": 0,
            "migrations_aborted": 0,
        }
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Run the pacer thread: one load fold + (maybe) one migration
        per interval. Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._pacer_main, name="placement-pacer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def abort(self) -> None:
        """Abort in-flight and future migrations: execute() raises the
        typed ErrMigrationAborted at its next checkpoint. Sticky until
        resume()."""
        with self._mu:
            self._abort = True

    def resume(self) -> None:
        with self._mu:
            self._abort = False

    def _pacer_main(self) -> None:
        while not self._stopped.wait(self.config.interval_s):
            try:
                self.rebalance_once()
            except ErrMigrationAborted:
                pass  # counted; the next interval re-plans
            except Exception:
                import traceback

                traceback.print_exc()

    # ------------------------------------------------------------ load model
    def load_model(self) -> dict:
        """Fold the host's live pressure picture: the saturation score,
        per-group heat from the lane gauges (ingest rate = last_index
        delta over the fold interval + commit gap), and the worst
        tenant's bulk p99 from the serving histograms. Mirror/metric
        reads only — zero device syncs, no locks held across any of
        it."""
        now = time.monotonic()
        lane_stats = {}
        stats_fn = getattr(self._nh.engine, "lane_stats", None)
        if stats_fn is not None:
            lane_stats = stats_fn()
        groups: Dict[int, dict] = {}
        with self._mu:
            prev = dict(self._last_lanes)
            self._last_lanes = {
                cid: (s.get("last_index", 0), now)
                for cid, s in lane_stats.items()
            }
        for cid, s in lane_stats.items():
            last = s.get("last_index", 0)
            p_last, p_t = prev.get(cid, (last, now))
            dt = max(now - p_t, 1e-6)
            ingest = max(last - p_last, 0) / dt
            gap = s.get("commit_gap", 0)
            groups[cid] = {
                "ingest_rate": round(ingest, 3),
                "commit_gap": gap,
                "heat": round(ingest + float(gap), 3),
            }
        worst_p99 = 0.0
        tenant_p99: Dict[int, float] = {}
        m = getattr(self._nh, "metrics", None)
        if m is not None:
            for (tid, klass), h in m.histogram_items(
                "serving_latency_seconds"
            ):
                if klass != KLASS_BULK or not h.count:
                    continue
                q = h.quantile(0.99)
                tenant_p99[tid] = round(q, 6)
                worst_p99 = max(worst_p99, q)
        return {
            "score": self.front.monitor.score(),
            "groups": groups,
            "tenant_p99_s": tenant_p99,
            "worst_tenant_p99_s": round(worst_p99, 6),
        }

    # ------------------------------------------------------------- planning
    def plan(self, force: bool = False) -> List[MigrationPlan]:
        """Decide which hot groups move where. Empty unless the host is
        past the rebalance trigger (or force=True); never plans more
        than max_concurrent total in-flight migrations."""
        cfg = self.config
        model = self.load_model()
        score = model["score"]
        hot_host = score >= cfg.rebalance_at or (
            cfg.p99_rebalance_s > 0
            and model["worst_tenant_p99_s"] >= cfg.p99_rebalance_s
        )
        if not (hot_host or force):
            return []
        with self._mu:
            budget = cfg.max_concurrent - len(self._active)
            active = set(self._active)
        if budget <= 0:
            return []
        ranked = sorted(
            model["groups"].items(),
            key=lambda kv: kv[1]["heat"],
            reverse=True,
        )
        plans: List[MigrationPlan] = []
        for cid, g in ranked:
            if len(plans) >= budget:
                break
            if cid in active or not self._nh.has_node(cid):
                continue
            target = self._pick_target(score, force)
            if target is None:
                continue
            try:
                member = self._nh.get_cluster_membership(cid)
                local_id = self._nh.local_node_id(cid)
            except RequestError:
                continue
            ids = (
                set(member.addresses)
                | set(getattr(member, "observers", {}) or {})
                | set(getattr(member, "witnesses", {}) or {})
                # removed ids are permanently unusable (the membership
                # manager rejects re-adding them): an aborted migration
                # leaves its undone member here, and re-allocating that
                # id would deterministically fail every retry
                | set(getattr(member, "removed", {}) or {})
            )
            new_id = max(ids) + 1 if ids else 1
            plans.append(
                MigrationPlan(
                    cluster_id=cid,
                    local_node_id=local_id,
                    new_node_id=new_id,
                    target=target,
                    reason=(
                        f"score={score:.2f} heat={g['heat']} "
                        f"gap={g['commit_gap']}"
                    ),
                    heat=g["heat"],
                )
            )
        return plans

    def _pick_target(self, score: float, force: bool):
        best, best_load = None, float("inf")
        for t in self.targets:
            try:
                load = t.load()
            except Exception:
                continue
            if not force and load > score - self.config.target_headroom:
                continue  # no headroom: moving there is churn
            if load < best_load:
                best, best_load = t, load
        return best

    # ------------------------------------------------------------ execution
    def rebalance_once(self, force: bool = False) -> List[MigrationPlan]:
        """One planning pass + serial execution of the plans. Returns
        the COMPLETED plans; an aborted migration raises the typed
        ErrMigrationAborted after its cleanup."""
        done = []
        for plan in self.plan(force=force):
            self.execute(plan)
            done.append(plan)
        return done

    def _checkpoint(self, plan: MigrationPlan, step: str) -> None:
        with self._mu:
            aborted = self._abort
        if aborted:
            raise ErrMigrationAborted(
                retry_after_s=self.config.abort_retry_s,
                reason=f"operator abort at {step}",
            )

    def _spend_bulk(self, plan: MigrationPlan, step: str) -> None:
        """Each protocol step of a migration rides the BULK class of the
        reserved migration tenant: paced by its bucket, tightened by the
        saturation curve, shed outright past the hard line — migration
        never competes with the urgent class."""
        try:
            self.front.admission.admit(self.config.tenant_id, KLASS_BULK)
        except ErrOverloaded as e:
            raise ErrMigrationAborted(
                retry_after_s=e.retry_after_s,
                reason=f"admission shed at {step}: {e.reason or e.code}",
            ) from e

    def execute(self, plan: MigrationPlan) -> None:
        """Live migration of one group replica: add member on the target
        → catch-up (streamed snapshot install when compacted past) →
        leadership transfer off this host when it leads → remove the
        local member → detach the local node. Abortable at every step
        with ErrMigrationAborted; an abort leaves the group serving
        where it was (a half-added member is best-effort removed)."""
        cid = plan.cluster_id
        with self._mu:
            if cid in self._active:
                raise ErrMigrationAborted(
                    retry_after_s=self.config.abort_retry_s,
                    reason=f"cluster {cid} already migrating",
                )
            self._active[cid] = plan
            self._counters["migrations_started"] += 1
        flight_recorder().record(
            "migration_started", cluster=cid,
            host=self._nh.raft_address(), target=plan.target.address,
            new_node=plan.new_node_id, reason=plan.reason,
        )
        self._nh.mark_migrating(cid, True)
        if plan.target.mark_migrating is not None:
            plan.target.mark_migrating(cid, True)
        try:
            self._run_migration(plan)
            with self._mu:
                self._counters["migrations_completed"] += 1
            flight_recorder().record(
                "migration_completed", cluster=cid,
                host=self._nh.raft_address(), target=plan.target.address,
            )
        except ErrMigrationAborted as e:
            with self._mu:
                self._counters["migrations_aborted"] += 1
            flight_recorder().record(
                "migration_aborted", cluster=cid,
                host=self._nh.raft_address(), reason=e.reason,
            )
            raise
        finally:
            self._nh.mark_migrating(cid, False)
            if plan.target.mark_migrating is not None:
                plan.target.mark_migrating(cid, False)
            with self._mu:
                self._active.pop(cid, None)

    def _run_migration(self, plan: MigrationPlan) -> None:
        cfg = self.config
        cid = plan.cluster_id
        nh = self._nh
        # 1. join the new member on the target host
        self._checkpoint(plan, "add_node")
        self._spend_bulk(plan, "add_node")
        try:
            nh.sync_request_add_node(
                cid, plan.new_node_id, plan.target.address,
                timeout_s=cfg.config_change_timeout_s,
            )
        except RequestError as e:
            raise ErrMigrationAborted(
                retry_after_s=cfg.abort_retry_s,
                reason=f"add_node failed: {type(e).__name__}",
            ) from e
        try:
            plan.target.start_replica(cid, plan.new_node_id)
        except Exception as e:
            self._undo_add(plan)
            raise ErrMigrationAborted(
                retry_after_s=cfg.abort_retry_s,
                reason=f"target start failed: {type(e).__name__}",
            ) from e
        # 2. catch-up: log replay from the leader, or a streamed
        # snapshot install when compaction already passed the joiner
        # (the resume-capable chunk path — the stream is tagged
        # migration on the target's chunk tracker)
        deadline = time.monotonic() + cfg.catchup_timeout_s
        while True:
            self._checkpoint(plan, "catchup")
            try:
                local = nh.get_applied_index(cid)
            except RequestError:
                local = 0
            remote = plan.target.applied_index(cid)
            if local and remote >= max(local - cfg.catchup_gap, 1):
                break
            if time.monotonic() >= deadline:
                self._undo_add(plan)
                raise ErrMigrationAborted(
                    retry_after_s=cfg.abort_retry_s,
                    reason=(
                        f"catchup timeout: target at {remote}, "
                        f"local at {local}"
                    ),
                )
            time.sleep(cfg.poll_s)
        # 3. leadership off this host first (transfer is cheap; removal
        # of a live leader is not)
        self._checkpoint(plan, "transfer")
        lid, has = nh.get_leader_id(cid)
        if has and lid == plan.local_node_id:
            self._spend_bulk(plan, "transfer")
            # transfer is best-effort in raft (the TimeoutNow only fires
            # once the target's match catches the leader's last index,
            # and an unlucky election can land elsewhere): re-issue it
            # on a heartbeat-ish cadence until leadership actually
            # leaves this host — any other member is a win, the goal is
            # moving load OFF the saturated box
            deadline = time.monotonic() + cfg.transfer_timeout_s
            next_req = 0.0
            while True:
                self._checkpoint(plan, "transfer_wait")
                lid, has = nh.get_leader_id(cid)
                if has and lid != plan.local_node_id:
                    break
                now = time.monotonic()
                if now >= deadline:
                    # the new member is caught up and harmless; the
                    # group keeps its leader here — abort the MOVE
                    self._undo_add(plan)
                    raise ErrMigrationAborted(
                        retry_after_s=cfg.abort_retry_s,
                        reason="leadership transfer timeout",
                    )
                if now >= next_req:
                    next_req = now + max(cfg.poll_s * 10, 0.5)
                    try:
                        nh.request_leader_transfer(cid, plan.new_node_id)
                    except RequestError:
                        pass  # a pending transfer is still in flight
                time.sleep(cfg.poll_s)
        # 4. remove the local member (forwarded to the new leader) and
        # detach the local node — the swap is complete
        self._checkpoint(plan, "remove")
        self._spend_bulk(plan, "remove")
        try:
            nh.sync_request_delete_node(
                cid, plan.local_node_id,
                timeout_s=cfg.config_change_timeout_s,
            )
        except RequestError as e:
            raise ErrMigrationAborted(
                retry_after_s=cfg.abort_retry_s,
                reason=f"delete_node failed: {type(e).__name__}",
            ) from e
        try:
            nh.stop_cluster(cid)
        except RequestError:
            pass  # already detached (e.g. a racing teardown)

    def _undo_add(self, plan: MigrationPlan) -> None:
        """Best-effort removal of a half-joined member: the group must
        not be left with a stray voter on an abort."""
        try:
            self._nh.sync_request_delete_node(
                plan.cluster_id, plan.new_node_id,
                timeout_s=self.config.config_change_timeout_s,
            )
        except RequestError:
            pass

    # ------------------------------------------------------------ introspect
    def counters(self) -> dict:
        with self._mu:
            out = dict(self._counters)
            out["active"] = len(self._active)
        return out

    def export_gauges(self, metrics) -> None:
        """Fold the migration ledger into the host MetricsRegistry
        (called ~1/s from NodeHost._export_health_gauges)."""
        metrics.declare_label_names("placement_migrations", ("phase",))
        c = self.counters()
        for phase in ("started", "completed", "aborted"):
            metrics.set_gauge(
                "placement_migrations", (f"migrations_{phase}",),
                float(c[f"migrations_{phase}"]),
            )


__all__ = [
    "MIGRATION_TENANT",
    "MigrationPlan",
    "MigrationTarget",
    "PlacementConfig",
    "PlacementPlane",
    "host_target",
]
