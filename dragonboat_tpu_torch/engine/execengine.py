"""Execution engine: fixed worker pools advancing many Raft groups.

cf. execengine.go:126-644 — the scheduler at the heart of multi-group
parallelism. Step workers run the protocol hot loop, task workers apply
committed entries to state machines, snapshot workers run save/recover/
stream. Groups are statically partitioned to workers by
cluster_id % worker_count (cf. internal/server/partition.go:22-41).

The hot loop preserves the reference's ordering invariants
(execengine.go:474-560):
  step -> fast-apply -> send Replicate (BEFORE fsync) -> SaveRaftState
  (fsync) -> stable-apply -> process update (append window, send rest)
  -> commit cursors
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..logger import get_logger
from ..profile import HOT_LANE_COUNTERS, DeviceCensus, phase_plane
from ..settings import hard, soft
from ..trace import LatencySampler, Profiler
from ..types import Update
from ..rsm.manager import From as OffloadFrom
from .fairness import FairnessWatchdog
from .node import Node

_plog = get_logger("execengine")

# Scalar twin of the kernel's counter plane. Mirrors ops.state.CTR_NAMES
# verbatim (pinned by a test) — duplicated here so the scalar engine stays
# importable without torch, which ops.state pulls in at module level.
_COUNTER_ATTRS = (
    "elections_started",
    "elections_won",
    "heartbeats_sent",
    "replicate_rejects",
    "commit_advances",
    "lease_served",
    "lease_fallback",
    "read_confirmations",
)


class _NullProfiler:
    """Zero-cost stand-in when profiling is disabled."""

    def new_iteration(self, n_groups: int = 0) -> None:
        pass

    def start(self) -> None:
        pass

    def end(self, stage: str) -> None:
        pass


_NULL_PROFILER = _NullProfiler()


class WorkReady:
    """Partitioned ready-channels (cf. execengine.go:82-124): producers mark
    a cluster ready; the owning worker drains its partition's set."""

    def __init__(self, partitions: int) -> None:
        self._n = partitions
        self._sets: List[Set[int]] = [set() for _ in range(partitions)]
        self._events = [threading.Event() for _ in range(partitions)]
        self._locks = [threading.Lock() for _ in range(partitions)]

    def partition(self, cluster_id) -> int:
        # hash() so composite keys work too (the shared VectorEngine keys
        # work by (host, cluster_id)); hash(int) == int keeps the scalar
        # engine's partition layout unchanged
        return hash(cluster_id) % self._n

    def notify(self, cluster_id: int) -> None:
        p = self.partition(cluster_id)
        with self._locks[p]:
            self._sets[p].add(cluster_id)
        self._events[p].set()

    def notify_all(self, cluster_ids) -> None:
        touched = set()
        for cid in cluster_ids:
            p = self.partition(cid)
            with self._locks[p]:
                self._sets[p].add(cid)
            touched.add(p)
        for p in touched:
            self._events[p].set()

    def wait_and_take(self, worker: int, timeout: float = 0.5) -> Set[int]:
        ev = self._events[worker]
        if not ev.wait(timeout):
            return set()
        with self._locks[worker]:
            out = self._sets[worker]
            self._sets[worker] = set()
            ev.clear()
        return out

    def wake_all(self) -> None:
        for ev in self._events:
            ev.set()


class ExecEngine:
    def __init__(
        self,
        logdb,
        num_step_workers: Optional[int] = None,
        num_task_workers: Optional[int] = None,
        num_snapshot_workers: int = 4,
        sample_ratio: Optional[int] = None,
        tick_period_s: float = 0.05,
        fairness_yield_ms: Optional[float] = None,
    ) -> None:
        self._logdb = logdb
        # tick-fairness watchdog (see engine/fairness.py): worker 0 is the
        # engine's heartbeat — it wakes at least once per tick period, so
        # an idle healthy engine reads starvation_ratio ~1.0 (same scale
        # as the vector loop) and a stale beat means this engine is being
        # starved of CPU by a co-scheduled peer loop (or is itself
        # starving them). fairness_yield_ms follows the EngineConfig
        # contract: None = auto threshold, 0 disables enforcement.
        self.watchdog = FairnessWatchdog(
            "exec-step",
            tick_period_s,
            yield_threshold_s=(
                float("inf") if fairness_yield_ms == 0
                else (fairness_yield_ms / 1000.0 if fairness_yield_ms else None)
            ),
        )
        self._wd_wait = min(0.5, max(tick_period_s, 1e-3))
        self._tick_period_s = max(tick_period_s, 1e-3)
        # Python threads contend on the GIL: default pools are smaller than
        # the Go engine's 16; protocol work is lock-striped the same way
        self._n_step = num_step_workers or min(hard.step_engine_worker_count, 8)
        self._n_task = num_task_workers or min(
            soft.step_engine_task_worker_count, 8
        )
        self._n_snap = num_snapshot_workers
        self._nodes: Dict[int, Node] = {}
        self._nodes_mu = threading.RLock()
        self._stopped = threading.Event()
        self.node_ready = WorkReady(self._n_step)
        self.task_ready = WorkReady(self._n_task)
        self.snapshot_ready = WorkReady(self._n_snap)
        # per-step-worker sampled profilers (cf. execengine.go:161-169);
        # ratio 0 (the default, cf. soft.latency_sample_ratio) disables
        # profiling entirely — no timing calls, no sample memory
        ratio = (
            sample_ratio if sample_ratio is not None
            else soft.latency_sample_ratio
        )
        self.profilers = (
            [Profiler(ratio) for _ in range(self._n_step)] if ratio > 0 else []
        )
        # sampled stage durations fan out to the shared phase plane
        # (engine_phase_seconds{engine="exec",phase=...}) so scalar and
        # vector step attribution read on one scale
        for p in self.profilers:
            p.attach_phase_plane(phase_plane(), "exec")
        # request-lifecycle latency sampling (see trace.LatencySampler):
        # same contract as the vector engine — a disabled stage profiler
        # still leaves the sparse 1-in-32 request sampler on, so latency
        # histograms exist in production without stage-timing overhead
        self.request_sampler = LatencySampler(ratio if ratio > 0 else 32)
        self._threads: List[threading.Thread] = []
        for i in range(self._n_step):
            t = threading.Thread(
                target=self._node_worker_main, args=(i,), name=f"step-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        for i in range(self._n_task):
            t = threading.Thread(
                target=self._task_worker_main, args=(i,), name=f"task-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        for i in range(self._n_snap):
            t = threading.Thread(
                target=self._snapshot_worker_main,
                args=(i,),
                name=f"snap-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------- registry
    def add_node(self, node: Node) -> None:
        with self._nodes_mu:
            self._nodes[node.cluster_id] = node
        self.set_node_ready(node.cluster_id)

    def remove_node(self, cluster_id: int) -> None:
        with self._nodes_mu:
            self._nodes.pop(cluster_id, None)

    def get_node(self, cluster_id: int) -> Optional[Node]:
        with self._nodes_mu:
            return self._nodes.get(cluster_id)

    def drain(self, timeout: float = 30.0) -> None:
        """Seam parity with VectorEngine.drain(): registry removal is
        synchronous here (remove_node pops under the lock) and a worker
        mid-exec_nodes sees node.stopped and skips it, so the restart
        plane has nothing to wait for."""
        return

    # -------------------------------------------------------------- wakeups
    def set_node_ready(self, cluster_id: int) -> None:
        self.node_ready.notify(cluster_id)

    def set_task_ready(self, cluster_id: int) -> None:
        self.task_ready.notify(cluster_id)

    def set_snapshot_ready(self, cluster_id: int) -> None:
        self.snapshot_ready.notify(cluster_id)

    # ---------------------------------------------------------- step workers
    def _node_worker_main(self, worker: int) -> None:
        wd = self.watchdog if worker == 0 else None
        while not self._stopped.is_set():
            cids = self.node_ready.wait_and_take(
                worker, self._wd_wait if wd is not None else 0.5
            )
            if not cids:
                if wd is not None:  # heartbeat: records the idle gap only
                    wd.iter_end(wd.iter_begin())
                continue
            nodes = []
            with self._nodes_mu:
                for cid in cids:
                    n = self._nodes.get(cid)
                    if n is not None and not n.stopped:
                        nodes.append(n)
            if nodes:
                t0 = wd.iter_begin() if wd is not None else 0.0
                try:
                    self.exec_nodes(nodes, worker)
                except Exception:  # a group failure must not kill the worker
                    import traceback

                    traceback.print_exc()
                if wd is not None:
                    wd.iter_end(t0)

    def exec_nodes(self, nodes: List[Node], worker: int = 0) -> None:
        """THE hot loop (cf. execNodes execengine.go:474-560)."""
        prof = self.profilers[worker] if self.profilers else _NULL_PROFILER
        prof.new_iteration(len(nodes))
        prof.start()
        updates: List[Tuple[Node, Update]] = []
        for node in nodes:
            if not node.initialized.is_set():
                node.recover_initial_snapshot()
            ud = node.step_node()
            if ud is not None:
                node.process_dropped(ud)
                updates.append((node, ud))
        prof.end("step")
        if not updates:
            return
        # 1. fast-apply: committed entries reach the SM before the fsync when
        #    safe (peer.set_fast_apply decided per update)
        prof.start()
        for node, ud in updates:
            if ud.fast_apply:
                node.apply_raft_update(ud)
        prof.end("fast_apply")
        # 2. Replicate messages leave before the local fsync
        prof.start()
        for node, ud in updates:
            node.send_replicate_messages(ud)
        prof.end("send")
        # 3. one batched fsynced write for every group this worker stepped
        prof.start()
        self._logdb.save_raft_state([ud for _, ud in updates])
        prof.end("save")
        # 4. stable apply for the rest
        prof.start()
        for node, ud in updates:
            if not ud.fast_apply:
                node.apply_raft_update(ud)
        prof.end("apply")
        # 5. window append, remaining sends, snapshot triggers, cursors
        prof.start()
        for node, ud in updates:
            node.process_raft_update(ud)
            node.commit_raft_update(ud)
        prof.end("exec")

    # ---------------------------------------------------------- task workers
    def _task_worker_main(self, worker: int) -> None:
        batch: list = []
        apply: list = []
        while not self._stopped.is_set():
            cids = self.task_ready.wait_and_take(worker)
            if not cids:
                continue
            for cid in cids:
                node = self.get_node(cid)
                if node is None or node.stopped:
                    continue
                if node.ss.recovering_from_snapshot():
                    # entries queued behind an installed snapshot apply
                    # only once the snapshot worker has rebuilt the state
                    # machine from it (a recovery would overwrite what
                    # they applied); the worker signals task_ready then
                    continue
                if not node.sm.loaded(OffloadFrom.COMMIT_WORKER):
                    continue  # lost the race with NodeHost close
                try:
                    node.handle_task(batch, apply)
                except Exception:
                    import traceback

                    traceback.print_exc()
                finally:
                    node.sm.offloaded(OffloadFrom.COMMIT_WORKER)
                if node.sm.task_queue.size() > 0:
                    self.set_task_ready(cid)

    # ------------------------------------------------------ snapshot workers
    def _snapshot_worker_main(self, worker: int) -> None:
        while not self._stopped.is_set():
            cids = self.snapshot_ready.wait_and_take(worker)
            if not cids:
                continue
            for cid in cids:
                node = self.get_node(cid)
                if node is None or node.stopped:
                    continue
                if not node.sm.loaded(OffloadFrom.SNAPSHOT_WORKER):
                    continue  # lost the race with NodeHost close
                try:
                    node.run_snapshot_work()
                except Exception:
                    import traceback

                    traceback.print_exc()
                finally:
                    node.sm.offloaded(OffloadFrom.SNAPSHOT_WORKER)

    # --------------------------------------------------------------- control
    def fairness_stats(self) -> dict:
        """Tick-fairness watchdog snapshot (see engine/fairness.py)."""
        return self.watchdog.stats()

    def lease_stats(self) -> dict:
        """Lease read counters, shape-compatible with
        VectorEngine.lease_stats(): 'local' / 'fallback' summed from each
        group's scalar core (plain int reads — a torn read costs one
        stale sample on an export path, never a protocol decision)."""
        local = fb = 0
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            r = getattr(node.peer, "raft", None)
            if r is not None:
                local += r.lease_served
                fb += r.lease_fallback
        return {"local": local, "fallback": fb}

    def lease_valid(self, cluster_id: int) -> bool:
        """Does this group's scalar core hold a live leader lease right
        now? Probe read for NodeHost.lease_read; the authoritative
        serve/fallback decision stays in the core's read path."""
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None or node.stopped:
            return False
        r = getattr(node.peer, "raft", None)
        if r is None:
            return False
        with node._mu:
            return bool(r.lease_valid())

    def set_clock_suspect(self, hold_s: float) -> None:
        """Clock-anomaly report from the host's tick worker: revoke every
        group's lease and refuse re-grants for hold_s (converted to ticks
        at the engine tick period) — lease reads degrade to the ReadIndex
        quorum path until the tick plane has proven sane again."""
        ticks = max(1, int(hold_s / self._tick_period_s + 0.999))
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            if node.stopped:
                continue
            try:
                with node._mu:
                    node.peer.raft.set_clock_suspect(ticks)
            except Exception:
                continue  # racing a concurrent close

    def pressure_stats(self) -> dict:
        """Serving-front backpressure probe, shape-compatible with
        VectorEngine.pressure_stats(): worst incoming-queue fill across
        this engine's groups (the EntryQueue/ReadIndexQueue whose
        overflow IS the ErrSystemBusy raise site one add() later).
        staged_backlog is the total count of accepted-but-not-yet-stepped
        requests across those queues — the scalar analogue of the vector
        engine's staged-row backlog."""
        occ = 0.0
        backlog = 0
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            occ = max(
                occ,
                node.incoming_proposals.fill(),
                node.incoming_reads.fill(),
            )
            backlog += (
                node.incoming_proposals.pending_count()
                + node.incoming_reads.pending_count()
            )
        return {"inbox_occupancy": occ, "staged_backlog": backlog}

    def counter_stats(self) -> Dict[str, int]:
        """Engine-wide protocol-event counter totals, shape-compatible
        with VectorEngine.counter_stats() (names = ops.state.CTR_NAMES).
        Summed from each group's scalar core; plain-int reads off the
        cores (same torn-read contract as lease_stats)."""
        totals = {name: 0 for name in _COUNTER_ATTRS}
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            r = getattr(node.peer, "raft", None)
            if r is None:
                continue
            for name in _COUNTER_ATTRS:
                totals[name] += int(getattr(r, name, 0))
        return totals

    def lane_counters(self) -> Dict[int, Dict[str, int]]:
        """Per-group counter rows, cluster_id-keyed — the scalar side of
        VectorEngineHandle.lane_counters() for tools.top."""
        out: Dict[int, Dict[str, int]] = {}
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            if node.stopped:
                continue
            r = getattr(node.peer, "raft", None)
            if r is None:
                continue
            out[node.cluster_id] = {
                name: int(getattr(r, name, 0)) for name in _COUNTER_ATTRS
            }
        return out

    def device_census(self) -> dict:
        """Shape-compatible HBM census: the scalar engine holds no device
        memory, so every byte/fill key is present and zero — consumers
        (bench JSON, gauges, tools.top) need not branch per engine."""
        return DeviceCensus.empty()

    def lane_stats(self) -> Dict[int, dict]:
        """Per-group introspection, shape-compatible with
        VectorEngine.lane_stats(): cluster_id -> {node_id, leader_id,
        term, commit_gap, ticks_since_leader_change}. Feeds the same
        engine_lane_* gauges (NodeHost._export_health_gauges) and the
        bench JSON lane fold, so dashboards read identically whichever
        engine a host runs. Derived from each group's protocol core under
        its step lock — the scalar engine hosts few groups and the export
        cadence is ~1/s, so the per-group lock round-trip is noise here
        (the vector engine's zero-sync numpy mirrors exist because it
        hosts thousands)."""
        out: Dict[int, dict] = {}
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for node in nodes:
            if node.stopped or not node.initialized.is_set():
                continue
            try:
                st = node.local_status()
            except Exception:
                continue  # racing a concurrent close
            tick = node.clock.tick
            last = st.get("last_index", st["commit"])
            # resident CLIENT-payload bytes in the in-memory log tier
            # (config-change cmds excluded: protocol metadata reaches
            # witnesses intact) — the witness-lane zero-payload probe,
            # vector-parity key
            try:
                inmem = node.peer.raft.log.inmem
                payload = sum(
                    len(e.cmd)
                    for e in inmem.entries
                    if not e.is_config_change()
                )
            except Exception:
                payload = 0
            out[node.cluster_id] = {
                "node_id": st["node_id"],
                "leader_id": st["leader_id"],
                "term": st["term"],
                "commit_gap": max(int(last - st["commit"]), 0),
                # append high-water mark (vector-parity key: the
                # placement plane's ingest-rate delta signal)
                "last_index": int(last),
                "ticks_since_leader_change": max(
                    int(tick - getattr(node, "_leader_change_tick", 0)), 0
                ),
                "role": int(st["state"]),
                "payload_bytes": payload,
            }
        return out

    def hot_lane_stats(self, k: int):
        """The k hottest groups by commit gap + the total the cap hides,
        shape-compatible with VectorEngineHandle.hot_lane_stats():
        (cluster_id -> lane_stats row + HOT_LANE_COUNTERS columns,
        total). The scalar engine hosts few groups, so 'capped' is just
        a sort here — the shape parity is what matters: the history
        sampler and tools.top read one surface whichever engine runs."""
        stats = self.lane_stats()
        counters = self.lane_counters()
        total = len(stats)
        hottest = sorted(
            stats.items(), key=lambda kv: kv[1]["commit_gap"], reverse=True
        )[: max(1, int(k))]
        out = {}
        for cid, row in hottest:
            row = dict(row)
            c = counters.get(cid, {})
            row["counters"] = {
                name: int(c.get(name, 0)) for name in HOT_LANE_COUNTERS
            }
            out[cid] = row
        return out, total

    def stop(self) -> None:
        self.watchdog.close()
        self._stopped.set()
        self.node_ready.wake_all()
        self.task_ready.wake_all()
        self.snapshot_ready.wake_all()
        for t in self._threads:
            t.join(timeout=2)
        # dump sampled stage latencies (cf. execengine.go:197-211)
        for i, prof in enumerate(self.profilers):
            report = prof.report()
            if report:
                _plog.infof("step worker %d stage latencies:\n%s", i, report)


__all__ = ["ExecEngine", "WorkReady"]
