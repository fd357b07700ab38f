"""NodeHost: the public facade hosting many Raft groups in one process.

cf. nodehost.go:243-2103 — lifecycle of all groups, the tick fanout, the
transport receive path, and every user-facing request method
(propose/read/membership/snapshot/transfer) in both async (RequestState)
and synchronous (Sync*) forms.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from .client import Session
from .config import Config, NodeHostConfig
from .core.peer import PeerAddress
from .engine.execengine import ExecEngine
from .engine.node import Node
from .events import MetricsRegistry, RaftEventAggregator
from .engine.snapshotter import Snapshotter
from .raftio import ErrNoBootstrapInfo, IMessageHandler
from .requests import (
    RequestError,
    ErrClusterClosed,
    ErrClusterNotFound,
    ErrClusterNotReady,
    ErrInvalidSession,
    ErrLeaseExpired,
    ErrRejected,
    ErrTimeout,
    RequestResult,
    RequestState,
    PendingLeaderTransfer,
)
from .rsm import SSRequest, SS_REQ_EXPORTED, SS_REQ_USER
from .statemachine import Result, sm_type_of
from .storage import LogReader, ShardedLogDB
from .profile import HistorySampler, compile_watch, sync_audit
from .profile import write_exposition as _write_profile_exposition
from .trace import flight_recorder, read_mmap_ring
from .transport import Transport, loopback_factory
from .transport.tcp import tcp_factory
from .types import (
    Bootstrap,
    ConfigChange,
    ConfigChangeType,
    Membership,
    Message,
    MessageType,
)


class ErrDirNotExist(RequestError):
    """Export path does not exist (cf. nodehost.go:905)."""


class ErrClusterAlreadyExist(RequestError):
    code = "cluster already exist"


class ErrInvalidClusterSettings(RequestError):
    code = "cluster settings are invalid"


class ErrDeadlineNotSet(RequestError):
    code = "deadline not set"


class ErrDirLocked(RuntimeError):
    """The nodehost dir is held by another live NodeHost
    (cf. internal/server/context.go dir-lock files)."""


class ClusterInfo:
    """cf. nodehost.go GetNodeHostInfo ClusterInfo."""

    def __init__(self, cluster_id, node_id, nodes, config_change_index, is_leader):
        self.cluster_id = cluster_id
        self.node_id = node_id
        self.nodes = nodes
        self.config_change_index = config_change_index
        self.is_leader = is_leader


class NodeHostInfo:
    """Aggregate introspection record (cf. nodehost.go:1289-1302
    GetNodeHostInfo): the host's address, per-cluster states, and the logdb
    inventory. Iterable over cluster_info for drop-in compatibility with
    callers that treated get_nodehost_info() as a ClusterInfo list."""

    def __init__(self, raft_address, cluster_info, log_info):
        self.raft_address = raft_address
        self.cluster_info = cluster_info
        self.log_info = log_info

    def __iter__(self):
        return iter(self.cluster_info)

    def __len__(self):
        return len(self.cluster_info)


class NodeHost(IMessageHandler):
    def __init__(self, cfg: NodeHostConfig) -> None:
        cfg.validate()
        self.config = cfg
        self._nodes_mu = threading.RLock()
        self._nodes: Dict[int, Node] = {}
        # restart plane: how each cluster was started, so
        # restart_cluster() can re-run WAL recovery and rejoin without
        # the caller re-supplying members/factory/config
        # (cluster_id -> (initial_members, join, sm_factory, cfg))
        self._launch_specs: Dict[int, tuple] = {}
        self._stopped = threading.Event()
        # --- events + metrics (cf. event.go:34-141)
        self.metrics = MetricsRegistry()
        self._event_aggregator = RaftEventAggregator(
            self.metrics,
            user_listener=cfg.raft_event_listener,
            enable_metrics=cfg.enable_metrics,
        )
        # --- directories
        self._dir_lock_fd = None
        if cfg.nodehost_dir:
            self._dir = os.path.join(
                cfg.nodehost_dir, cfg.raft_address.replace(":", "-")
            )
            os.makedirs(self._dir, exist_ok=True)
            self._acquire_dir_lock()
            self._tmpdir = None
        else:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="dbtpu-")
            self._dir = self._tmpdir.name
        # --- logdb
        if cfg.logdb_factory is not None:
            self.logdb = cfg.logdb_factory(self._dir)
        elif cfg.nodehost_dir:
            self.logdb = ShardedLogDB(os.path.join(self._dir, "logdb"))
        else:
            self.logdb = ShardedLogDB()  # in-memory
        # WAL durability-barrier latency -> fsync_latency_seconds histogram
        # (observed at every real fsync; barriers are ms-scale and the
        # observation is two clock reads + a bucket increment)
        set_fsync_obs = getattr(self.logdb, "set_fsync_observer", None)
        if set_fsync_obs is not None:
            set_fsync_obs(self._observe_fsync)
        # --- transport
        if cfg.raft_rpc_factory is not None:
            rpc_factory = cfg.raft_rpc_factory(cfg.get_listen_address())
        else:
            rpc_factory = tcp_factory(cfg.get_listen_address())
        self.transport = Transport(
            cfg.raft_address,
            cfg.deployment_id,
            rpc_factory,
            # max_send_queue_size is a BYTE bound (cf. NodeHostConfig in
            # config.go); the count bound stays at the soft default
            max_send_queue_bytes=cfg.max_send_queue_size or 0,
        )
        self.transport.set_message_handler(self)
        from .transport.chunks import Chunks  # lazy: needs snapshot dir root

        self._chunks = Chunks(self)
        self.transport.set_chunk_sink(self._recv_chunk)
        self.transport.start()
        # outbound snapshot stream admission (cf. lane.go:40-237 +
        # StreamConnections, config.go:299-306): hard caps on total and
        # per-target concurrent lanes — a request over either cap fails
        # fast via snapshot-status feedback, never queues a thread
        from .transport.snapshotstream import RateLimiter

        self._lane_mu = threading.Lock()
        self._lanes_total = 0
        self._lanes_by_target: Dict[str, int] = {}
        self._max_lanes = max(1, cfg.max_snapshot_connections)
        self._max_lanes_per_target = max(1, cfg.max_snapshot_lanes_per_target)
        self._snap_send_rate = (
            RateLimiter(cfg.max_snapshot_send_bytes_per_second)
            if cfg.max_snapshot_send_bytes_per_second
            else None
        )
        self._snap_recv_rate = (
            RateLimiter(cfg.max_snapshot_recv_bytes_per_second)
            if cfg.max_snapshot_recv_bytes_per_second
            else None
        )
        # --- engine
        if cfg.engine.kind == "vector":
            from .engine.vector import get_vector_engine

            self.engine = get_vector_engine(self.logdb, cfg)
        else:
            self.engine = ExecEngine(
                self.logdb,
                tick_period_s=cfg.rtt_millisecond / 1000.0,
                fairness_yield_ms=getattr(
                    cfg.engine, "fairness_yield_ms", None
                ),
            )
        # --- tick loop
        self._tick_ms = cfg.rtt_millisecond
        # injectable tick clock (faults.ClockPlane.clock_fn): the tick
        # worker mints ticks off THIS clock, so injected skew/drift/
        # step-jumps reach the tick plane exactly where a faulty machine
        # clock would. Default is real monotonic time; anomaly detection
        # only arms when a non-default clock is mounted.
        self._tick_clock: Callable[[], float] = time.monotonic
        self._clock_anomalies = 0
        self._tick_thread = threading.Thread(
            target=self._tick_worker_main, name="nh-tick", daemon=True
        )
        self._tick_thread.start()
        self._partitioned = False  # monkey-test knob
        # lazily-created overload-robust ingress (serving/front.py); read
        # lock-free by the gauge exporter, created/torn down under
        # _serving_mu
        self._serving = None
        self._serving_mu = threading.Lock()
        # lazily-created placement plane (serving/placement.py); same
        # create/teardown discipline as the front
        self._placement = None
        # clusters mid live-migration (serving/placement.py): consulted
        # by the inbound chunk tracker to tag migration install streams;
        # guarded by _nodes_mu like the rest of the cluster tables
        self._migrating: set = set()
        # ping/pong RTT samples: (cluster_id, peer) -> deque of microseconds
        self._rtt_mu = threading.Lock()
        self._rtt: Dict[tuple, object] = {}
        # crash-persistent flight recorder: DRAGONBOAT_FLIGHT_RING=<path>
        # tees the process-global recorder into an mmap ring so a
        # SIGKILL'd host still leaves a timeline recover_flight_ring()
        # can read (attach is idempotent across co-hosted NodeHosts)
        ring_path = os.environ.get("DRAGONBOAT_FLIGHT_RING")
        if ring_path:
            try:
                flight_recorder().attach_mmap(ring_path)
            except Exception:
                pass  # forensics must never block bring-up
        # telemetry history ring (profile.HistorySampler): a background
        # sampler turning this host's zero-sync stat surfaces into a
        # crash-persistent time series next to the flight ring.
        # DRAGONBOAT_HISTORY_RING=<path> auto-starts it at bring-up
        # (tools.doctor reads the ring back); start_history() is the
        # programmatic path (tools.longhaul samples a whole fleet into
        # one per-round ring instead).
        self._history: Optional[HistorySampler] = None
        hist_path = os.environ.get("DRAGONBOAT_HISTORY_RING")
        if hist_path:
            try:
                self.start_history(hist_path)
            except Exception:
                pass  # forensics must never block bring-up

    def _acquire_dir_lock(self) -> None:
        """Exclusive advisory lock on the nodehost dir (cf. reference
        internal/server/context.go:72-333 dir-lock files): a second process
        or NodeHost opening the same dir would silently corrupt the WAL, so
        it must fail fast instead."""
        import fcntl

        path = os.path.join(self._dir, "LOCK")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise ErrDirLocked(
                f"nodehost dir {self._dir} is locked by another NodeHost"
            )
        os.ftruncate(fd, 0)
        os.write(fd, f"pid={os.getpid()} addr={self.config.raft_address}\n".encode())
        self._dir_lock_fd = fd

    def _release_dir_lock(self) -> None:
        if self._dir_lock_fd is not None:
            import fcntl

            try:
                fcntl.flock(self._dir_lock_fd, fcntl.LOCK_UN)
            finally:
                os.close(self._dir_lock_fd)
                self._dir_lock_fd = None

    # ------------------------------------------------------------ properties
    def raft_address(self) -> str:
        return self.config.raft_address

    def snapshot_dir_root(self) -> str:
        return os.path.join(self._dir, "snapshots")

    # --------------------------------------------------------------- lifecyle
    def stop(self) -> None:
        self._teardown(crashed=False)

    def crash(self) -> None:
        """SIGKILL-equivalent in-process teardown of the WHOLE host (the
        drummer harness's kill verdict, cf. reference docs/test.md):
        nothing is drained or flushed — nodes are abandoned mid-flight
        (their pending requests terminate like a reset connection), a
        sole-tenant vector core discards its un-decoded in-flight step
        instead of decoding and saving it, and the WAL files close
        WITHOUT a final durability barrier (close_crashed), so the only
        durable state is what past save waves already fsynced. The
        nodehost dir survives for a restarted NodeHost to recover from;
        run FaultPlane.tear_wal_tails(crashed.logdb_dir(), ...) before
        the restart to also simulate a torn mid-write tail."""
        flight_recorder().record(
            "host_crashed", host=self.config.raft_address,
        )
        self._teardown(crashed=True)

    def _teardown(self, crashed: bool) -> None:
        self._stopped.set()
        # history sampler dies FIRST: it reads engine/logdb surfaces that
        # are about to close under it. Graceful stop flushes one final
        # sample; a crash abandons the ring mid-write like a SIGKILL
        # would — recovering THAT state is what the ring is for.
        try:
            self.stop_history(final_sample=not crashed)
        except Exception:
            pass  # forensics must never block teardown
        with self._serving_mu:
            front, self._serving = self._serving, None
            plane, self._placement = self._placement, None
        if plane is not None:
            # the pacer thread must die first (graceful or not): a
            # migration step against a closing host is just churn
            plane.abort()
            plane.stop()
        if front is not None and not crashed:
            # graceful stop drains queued tickets with ErrClusterClosed;
            # a crash abandons them exactly like every other in-flight
            # request on this host
            front.stop()
        with self._nodes_mu:
            nodes = list(self._nodes.values())
            self._nodes.clear()
            self._launch_specs.clear()
        for n in nodes:
            if crashed:
                # abrupt: terminate waiters FIRST so the engine's
                # in-flight step observes a dead node (skips sends/task
                # handoff) rather than a live one being unplugged
                n.close()
                self.engine.remove_node(n.cluster_id)
            else:
                self.engine.remove_node(n.cluster_id)
                n.close()
        if crashed:
            crash = getattr(self.engine, "crash", None)
            (crash if crash is not None else self.engine.stop)()
        else:
            self.engine.stop()
        self.transport.stop()
        if crashed:
            cc = getattr(self.logdb, "close_crashed", None)
            (cc if cc is not None else self.logdb.close)()
        else:
            self.logdb.close()
        self._event_aggregator.stop()
        if self._tick_thread.is_alive():
            self._tick_thread.join(timeout=2)
        self._release_dir_lock()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()

    def logdb_dir(self) -> str:
        """On-disk logdb root (shard WALs live in shard-<i> below it) —
        the tear_wal_tails target after a crash(). Derived from the live
        store's own layout when it exposes one (shard_dirs), so a custom
        logdb_factory rooting the WALs elsewhere still tears the real
        files; the `<nodehost_dir>/logdb` convention is the fallback."""
        sd = getattr(self.logdb, "shard_dirs", None)
        if sd is not None:
            dirs = sd()
            if dirs:
                return os.path.dirname(dirs[0])
        return os.path.join(self._dir, "logdb")

    def _observe_fsync(self, seconds: float) -> None:
        self.metrics.observe("fsync_latency_seconds", (0, 0), seconds)

    def write_health_metrics(self, w) -> None:
        """Prometheus text exposition of node + transport metrics
        (cf. WriteHealthMetrics event.go:30-32)."""
        self.metrics.write(w)
        for name, v in sorted(self.transport.metrics().items()):
            full = f"dragonboat_tpu_transport_{name}_total"
            w.write(f"# TYPE {full} counter\n")
            w.write(f"{full} {v:g}\n")
        # perf attribution plane: engine_phase_seconds{engine=,phase=}
        # histograms + per-function build-cache gauges
        _write_profile_exposition(w)

    # ----------------------------------------------------------- forensics
    # dump_flight artifact bound: a runaway event source must not turn a
    # forensic dump into a disk-filling liability on a production host
    # (the ROADMAP "ship recorder dumps off-host" headroom's shippable
    # slice — bounded, compressed artifacts)
    DUMP_FLIGHT_MAX_BYTES = 8 << 20

    def dump_flight(
        self,
        path: str,
        cluster_id: Optional[int] = None,
        max_bytes: int = DUMP_FLIGHT_MAX_BYTES,
    ) -> str:
        """Write the process flight recorder as JSONL (optionally filtered
        to one cluster) with a `_meta` header line so tools.timeline can
        merge this host's dump with other hosts' on one clock.

        Artifact discipline: the dump is capped at `max_bytes` — when the
        serialized timeline exceeds it, the OLDEST lines are dropped (the
        recent tail is the forensic payload) and the `_meta` line carries
        `dropped_events`. A pre-existing artifact at `path` rotates to
        `<path>.1.gz` (gzip-compressed, previous rotation overwritten) so
        repeated dumps keep exactly one bounded predecessor. A `path`
        ending in `.gz` writes gzip directly; tools.timeline reads both
        transparently. Returns the path."""
        import gzip

        rec = flight_recorder()
        kw = {} if cluster_id is None else {"cluster_id": cluster_id}
        meta = {"source": self.config.raft_address}
        text = rec.to_jsonl(meta=meta, **kw) + "\n"
        if max_bytes and len(text) > max_bytes:
            lines = text.splitlines(keepends=True)
            head, tail = lines[0], lines[1:]  # _meta line stays first
            size = len(head)
            keep: List[str] = []
            for ln in reversed(tail):  # newest-first fill
                if size + len(ln) > max_bytes:
                    break
                keep.append(ln)
                size += len(ln)
            keep.reverse()
            import json

            # re-emit the meta header with the drop count
            m = {
                "event": "_meta",
                "mono_offset": round(rec.mono_offset, 6),
                "dropped_events": len(tail) - len(keep),
            }
            m.update(meta)
            head = json.dumps(m, default=str, sort_keys=True) + "\n"
            text = head + "".join(keep)
        if os.path.exists(path) and not path.endswith(".gz"):
            # gzip rotation: the previous artifact survives, compressed
            try:
                with open(path, "rb") as src, gzip.open(
                    path + ".1.gz", "wb"
                ) as dst:
                    dst.write(src.read())
            except OSError:
                pass  # rotation is best-effort; the fresh dump matters more
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                f.write(text)
        else:
            with open(path, "w") as f:
                f.write(text)
        return path

    @staticmethod
    def recover_flight_ring(path: str) -> List[dict]:
        """Read a (possibly SIGKILL'd) process's mmap flight ring back as
        an ordered event list (see trace.read_mmap_ring)."""
        _meta, events = read_mmap_ring(path)
        return events

    def start_history(
        self,
        path: Optional[str] = None,
        interval_s: Optional[float] = None,
        **kw,
    ) -> HistorySampler:
        """Start the telemetry history sampler for THIS host: every
        ``interval_s`` (profile.HISTORY_INTERVAL_S default) a bounded
        snapshot of the zero-sync stat surfaces lands in a
        crash-persistent ring at ``path`` (default
        ``<nodehost_dir>/history.ring``, next to the WAL). Idempotent —
        a second call returns the running sampler. Entirely off the
        engine step path; the ``engine_history_*`` gauges report its
        measured cost."""
        if self._history is not None:
            return self._history
        if path is None:
            path = os.path.join(self._dir, "history.ring")
        if interval_s is not None:
            kw["interval_s"] = interval_s
        self._history = HistorySampler(path, {0: self}, **kw).start()
        return self._history

    def stop_history(self, final_sample: bool = True) -> None:
        """Stop the history sampler (graceful path takes one final
        sample so the last state of a clean shutdown is on disk too).
        No-op when no sampler is running."""
        sampler, self._history = self._history, None
        if sampler is not None:
            sampler.stop(final_sample=final_sample)

    def clock_anomalies(self) -> int:
        """Cumulative tick-clock fault count (the tick worker's
        divergence detector) — the history sampler's clock-fault
        series and tools.doctor's clock_anomaly signal."""
        return self._clock_anomalies

    # ------------------------------------------------------------ start paths
    def start_cluster(
        self,
        initial_members: Dict[int, str],
        join: bool,
        sm_factory: Callable,
        cfg: Config,
    ) -> None:
        """cf. nodehost.go:431-475 StartCluster + startCluster:1476-1560.
        sm_factory(cluster_id, node_id) returns an IStateMachine /
        IConcurrentStateMachine / IOnDiskStateMachine."""
        if self._stopped.is_set():
            raise ErrClusterClosed()
        bootstrap, new_node = self._prepare_cluster(
            initial_members, join, sm_factory, cfg
        )
        if new_node:
            self.logdb.save_bootstrap_info(
                cfg.cluster_id, cfg.node_id, bootstrap
            )
        self._launch_node(
            initial_members, join, sm_factory, cfg, bootstrap, new_node
        )

    def _prepare_cluster(self, initial_members, join, sm_factory, cfg: Config):
        """Shared validation + SM-type probing + bootstrap construction for
        both the single and bulk start paths (persisting is the caller's
        job — the bulk path batches it)."""
        cfg.validate()
        cluster_id, node_id = cfg.cluster_id, cfg.node_id
        with self._nodes_mu:
            if cluster_id in self._nodes:
                raise ErrClusterAlreadyExist()
        if join and initial_members:
            raise ErrInvalidClusterSettings()
        probe = sm_factory(cluster_id, node_id)
        smtype = sm_type_of(probe)
        if hasattr(probe, "close"):
            probe.close()
        return self._peek_bootstrap(initial_members, join, cfg, smtype)

    def start_clusters(self, specs) -> None:
        """Bulk StartCluster for fleet bring-up: specs are
        (initial_members, join, sm_factory, config) tuples. Bootstrap
        records for all new clusters persist in ONE fsynced batch per logdb
        shard, and the engine activates all lanes in its batched scatter
        rather than one group at a time (the reference brings groups up one StartCluster at a time,
        nodehost.go:431-475; its cheap-idle-group story starts only after
        launch, README.md:48-51)."""
        if self._stopped.is_set():
            raise ErrClusterClosed()
        prepared = []
        boots = []
        seen: set = set()
        for initial_members, join, sm_factory, cfg in specs:
            if cfg.cluster_id in seen:
                raise ErrClusterAlreadyExist()
            seen.add(cfg.cluster_id)
            bootstrap, new_node = self._prepare_cluster(
                initial_members, join, sm_factory, cfg
            )
            if new_node:
                boots.append((cfg.cluster_id, cfg.node_id, bootstrap))
            prepared.append(
                (initial_members, join, sm_factory, cfg, bootstrap, new_node)
            )
        # durability order preserved: every bootstrap record is on disk
        # before any of these nodes writes raft state
        if boots:
            self.logdb.save_bootstrap_infos(boots)
        for initial_members, join, sm_factory, cfg, bootstrap, new in prepared:
            self._launch_node(
                initial_members, join, sm_factory, cfg, bootstrap, new
            )

    def _launch_node(
        self, initial_members, join, sm_factory, cfg, bootstrap, new_node
    ) -> None:
        cluster_id, node_id = cfg.cluster_id, cfg.node_id
        addresses = bootstrap.addresses if not join else {}
        peer_addresses = [
            PeerAddress(node_id=nid, address=addr)
            for nid, addr in sorted(addresses.items())
        ]
        for nid, addr in addresses.items():
            self.transport.nodes.add_node(cluster_id, nid, addr)
        log_reader = LogReader(cluster_id, node_id, self.logdb)
        snapshotter = Snapshotter(
            self.snapshot_dir_root(), cluster_id, node_id, self.logdb
        )
        # restart path: position the window from snapshot + persisted log
        # BEFORE the protocol core launches and reads it (node.go:553-583)
        ss = snapshotter.get_most_recent_snapshot()
        if not new_node or (ss is not None and not ss.is_empty()):
            log_reader.load(ss)
        if self.config.engine.kind == "vector":
            from .engine.vector import VectorNode

            node_cls = VectorNode
        else:
            node_cls = Node
        node = node_cls(
            cfg,
            peer_addresses,
            initial=bool(initial_members) and new_node,
            new_node=new_node,
            sm_factory=sm_factory,
            log_reader=log_reader,
            logdb=self.logdb,
            snapshotter=snapshotter,
            send_message=self._send_message,
            send_messages=self._send_messages,
            engine=self.engine,
            event_listener=self._event_aggregator,
            register_peer=self._register_peer_address,
        )
        with self._nodes_mu:
            self._nodes[cluster_id] = node
            self._launch_specs[cluster_id] = (
                initial_members, join, sm_factory, cfg,
            )
        # initial-snapshot recovery runs HERE, on the control-plane
        # thread, BEFORE the engine sees the node: the vector engine's
        # lane activation otherwise runs it on the step-loop thread, and
        # a seconds-long SM restore (restart with a big image) would
        # stall every co-hosted lane's step cadence — the monolithic-
        # install stall the streamed-install plane exists to prevent.
        # (The activation path keeps its own idempotent call as the
        # race fallback.)
        node.recover_initial_snapshot()
        self.engine.add_node(node)

    def _bootstrap_cluster(
        self, initial_members, join, cfg: Config, smtype: int
    ):
        """cf. nodehost.go:1445-1474 bootstrapCluster."""
        bootstrap, new_node = self._peek_bootstrap(
            initial_members, join, cfg, smtype
        )
        if new_node:
            self.logdb.save_bootstrap_info(
                cfg.cluster_id, cfg.node_id, bootstrap
            )
        return bootstrap, new_node

    def _peek_bootstrap(self, initial_members, join, cfg: Config, smtype: int):
        """Validate + build the bootstrap record WITHOUT persisting it (the
        bulk path persists many records in one batch)."""
        cluster_id, node_id = cfg.cluster_id, cfg.node_id
        try:
            bootstrap = self.logdb.get_bootstrap_info(cluster_id, node_id)
            if not bootstrap.validate(initial_members or {}, join, smtype):
                raise ErrInvalidClusterSettings()
            return bootstrap, False
        except ErrNoBootstrapInfo:
            pass
        members = {} if join else dict(initial_members or {})
        if not join and cfg.is_witness is False and cfg.is_observer is False:
            if not members:
                raise ErrInvalidClusterSettings()
        bootstrap = Bootstrap(addresses=members, join=join, type=smtype)
        return bootstrap, True

    def stop_cluster(self, cluster_id: int) -> None:
        """Graceful detach of one cluster node (cf. nodehost.go
        StopCluster): the engine stops stepping it, its lane/worker
        registration drains fully (drain barrier) so the slot is
        immediately reusable, pending requests terminate, and the launch
        spec is KEPT — restart_cluster() rejoins from the durable state."""
        self._detach_cluster(cluster_id, crashed=False)

    def crash_cluster(self, cluster_id: int) -> None:
        """SIGKILL-equivalent teardown of ONE cluster node: no graceful
        handoff — staged proposals and in-flight snapshot work are
        abandoned, pending requests terminate like a reset connection,
        and nothing beyond past save waves is made durable. The node's
        engine lane is reaped for reuse; restart_cluster() later re-runs
        WAL recovery and rejoins the live group (log replay from the
        leader, or snapshot install when the log has been compacted past
        this node's index). The host's OTHER clusters keep running — use
        NodeHost.crash() for whole-process death semantics (incl. the
        skipped WAL barrier and torn-tail injection)."""
        self._detach_cluster(cluster_id, crashed=True)

    def _detach_cluster(self, cluster_id: int, crashed: bool) -> None:
        with self._nodes_mu:
            node = self._nodes.pop(cluster_id, None)
        if node is None:
            raise ErrClusterNotFound()
        flight_recorder().record(
            "node_crashed" if crashed else "cluster_stopped",
            cluster=cluster_id, host=self.config.raft_address,
        )
        if crashed:
            # abrupt: stop accepting + terminate waiters FIRST, so the
            # engine's in-flight step observes a dead node (skips sends/
            # task handoff) rather than a live one being unplugged
            node.close()
            self.engine.remove_node(cluster_id)
        else:
            self.engine.remove_node(cluster_id)
            node.close()
        # ordering barrier: the freed lane must be on the engine's free
        # list before this returns, or an immediate restart_cluster could
        # fail on its own predecessor's not-yet-reaped lane
        drain = getattr(self.engine, "drain", None)
        if drain is not None:
            drain()

    def restart_cluster(self, cluster_id: int) -> None:
        """Relaunch a stopped/crashed cluster node IN PROCESS from its
        durable state: re-runs WAL recovery (bootstrap record + persisted
        raft state + most recent snapshot, exactly the restart path a new
        process takes), rebuilds the engine lane from the recovered
        state, and rejoins the live group — the leader replays log from
        its window, or streams a snapshot when compaction has passed this
        node's index. Uses the launch spec recorded by start_cluster;
        raises ErrClusterNotFound if this host never started the cluster,
        ErrClusterAlreadyExist if it is still running."""
        if self._stopped.is_set():
            raise ErrClusterClosed()
        with self._nodes_mu:
            if cluster_id in self._nodes:
                raise ErrClusterAlreadyExist()
            spec = self._launch_specs.get(cluster_id)
        if spec is None:
            raise ErrClusterNotFound()
        initial_members, join, sm_factory, cfg = spec
        flight_recorder().record(
            "cluster_restarted", cluster=cluster_id,
            host=self.config.raft_address,
        )
        self.start_cluster(initial_members, join, sm_factory, cfg)

    def _register_peer_address(
        self, cluster_id: int, node_id: int, address: str
    ) -> None:
        """Replicated-state address registration (Node.apply_config_change
        / membership_loaded): an applied ADD_* change or a restored
        snapshot membership names a member's address — record it so THIS
        host can route to the member no matter which host requested the
        change (live migration depends on it: the swapped-in member must
        stay reachable after the adding host leaves the group)."""
        self.transport.nodes.add_node(cluster_id, node_id, address)

    def has_node(self, cluster_id: int) -> bool:
        with self._nodes_mu:
            return cluster_id in self._nodes

    def _get_node(self, cluster_id: int) -> Node:
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None:
            raise ErrClusterNotFound()
        return node

    # ------------------------------------------------------- time conversion
    def _to_ticks(self, timeout_s: float) -> int:
        return max(1, int(timeout_s * 1000 / self._tick_ms))

    # ---------------------------------------------------------------- writes
    def propose(
        self, session: Session, cmd: bytes, timeout_s: float
    ) -> RequestState:
        node = self._get_node(session.cluster_id)
        return node.propose(session, cmd, self._to_ticks(timeout_s))

    def propose_batch(
        self, session: Session, cmds, timeout_s: float
    ) -> List[RequestState]:
        """Pipelined submission: many proposals, one registry/queue lock
        round-trip and one engine wake-up (no-op sessions only — see
        Node.propose_batch). The engines ingest, replicate, persist and
        apply in batches already; this extends the batching to the
        client boundary."""
        node = self._get_node(session.cluster_id)
        return node.propose_batch(session, cmds, self._to_ticks(timeout_s))

    def propose_batch_async(
        self, session: Session, cmds, timeout_s: float
    ):
        """Fire-and-collect batch submission: returns ONE BatchRequestState
        whose event fires when every proposal in the batch has applied or
        timed out. Two orders of magnitude fewer Python objects than
        per-proposal RequestStates — the API for pipelined bulk writers."""
        node = self._get_node(session.cluster_id)
        return node.propose_batch_async(
            session, cmds, self._to_ticks(timeout_s)
        )

    def sync_propose(
        self, session: Session, cmd: bytes, timeout_s: float = 4.0
    ) -> Result:
        """cf. nodehost.go:514 SyncPropose."""
        rs = self.propose(session, cmd, timeout_s)
        r = rs.wait(timeout_s + 1.0)
        return self._unwrap(r)

    def _unwrap(self, r: RequestResult):
        if r.completed:
            return r.result
        if r.timeout:
            raise ErrTimeout()
        if r.rejected:
            raise ErrRejected()
        if r.terminated:
            raise ErrClusterClosed()
        raise ErrClusterNotReady()  # dropped

    # ----------------------------------------------------------------- reads
    def read_index(self, cluster_id: int, timeout_s: float) -> RequestState:
        node = self._get_node(cluster_id)
        return node.read(self._to_ticks(timeout_s))

    def sync_read(self, cluster_id: int, query, timeout_s: float = 4.0):
        """Linearizable read (cf. nodehost.go:539 SyncRead)."""
        rs = self.read_index(cluster_id, timeout_s)
        r = rs.wait(timeout_s + 1.0)
        self._unwrap(r)
        return self.read_local_node(cluster_id, query)

    def read_local_node(self, cluster_id: int, query):
        """Must only be called after a successful read_index round
        (cf. nodehost.go:808-820)."""
        node = self._get_node(cluster_id)
        return node.sm.lookup(query)

    def lease_read(self, cluster_id: int, query, timeout_s: float = 4.0):
        """Lease-ONLY linearizable read probe: raises ErrLeaseExpired
        immediately unless this host's replica holds a live leader lease
        (latency-SLO callers that would rather retry elsewhere than pay
        a quorum round). This is the one API that surfaces lease loss as
        an error — sync_read never does; with Config.lease_read on it
        serves off the lease when valid and silently degrades to the
        ReadIndex quorum path when not. If the lease lapses between the
        probe and the serve, the read degrades too: the outcome is
        always linearizable, only the latency contract is lease-only."""
        node = self._get_node(cluster_id)
        valid = getattr(self.engine, "lease_valid", None)
        if valid is None or not valid(cluster_id):
            raise ErrLeaseExpired(
                retry_after_s=self._tick_ms / 1000.0,
                reason="no live leader lease on this replica",
            )
        rs = node.read(self._to_ticks(timeout_s))
        r = rs.wait(timeout_s + 1.0)
        self._unwrap(r)
        return self.read_local_node(cluster_id, query)

    def stale_read(self, cluster_id: int, query):
        node = self._get_node(cluster_id)
        return node.sm.lookup(query)

    # --------------------------------------------------------- serving front
    def serving_front(self, admission=None, front=None):
        """The overload-robust ingress for this host (serving/front.py):
        per-tenant admission control + weighted-fair fan-in onto the
        batched propose path, fed by this host's live backpressure
        signals. Created lazily, ONE per host (the first call's knobs
        win); stop() tears it down with the host. Its per-tenant
        admit/shed/latency ledger exports through write_health_metrics
        alongside every other gauge."""
        with self._serving_mu:
            if self._serving is None:
                from .serving import ServingFront

                self._serving = ServingFront(
                    self, admission=admission, front=front
                )
            return self._serving

    def placement_plane(self, targets=None, config=None):
        """This host's load-aware placement brain (serving/placement.py):
        folds the saturation score, per-lane gauges and per-tenant
        serving histograms into a load model and live-migrates hot
        groups (leadership transfer + streamed-snapshot member swap) to
        the given MigrationTargets. Created lazily, ONE per host (the
        first call's targets/config win); torn down with the host. Its
        migration ledger exports through write_health_metrics."""
        # resolve the front FIRST: serving_front() takes _serving_mu too
        # (non-reentrant), and the plane's constructor needs it
        front = self.serving_front()
        with self._serving_mu:
            if self._placement is None:
                from .serving import PlacementPlane

                self._placement = PlacementPlane(
                    self, targets or [], config=config, front=front
                )
            return self._placement

    def mark_migrating(self, cluster_id: int, active: bool) -> None:
        """Tag/untag a cluster as mid live-migration on this host (both
        the source and the join target get marked): the inbound snapshot
        chunk tracker counts streams for marked clusters as MIGRATION
        streams, so the bench/longhaul ledgers can tell a migration's
        install traffic from ordinary catch-up."""
        with self._nodes_mu:
            if active:
                self._migrating.add(cluster_id)
            else:
                self._migrating.discard(cluster_id)

    def is_migrating(self, cluster_id: int) -> bool:
        with self._nodes_mu:
            return cluster_id in self._migrating

    def local_node_id(self, cluster_id: int) -> int:
        """The node id THIS host runs for the cluster (placement needs
        to know which member is 'here' before it can move it away)."""
        return self._get_node(cluster_id).node_id()

    def ingress_fill(self) -> float:
        """Worst incoming-proposal/read queue fill across this host's
        groups, in [0, 1] — the request-pool backpressure signal the
        serving front's SaturationMonitor folds into admission (a full
        queue here is the ErrSystemBusy raise site one add() later).
        Lock-free queue probes; a torn read costs one stale sample."""
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        fill = 0.0
        for node in nodes:
            fill = max(
                fill,
                node.incoming_proposals.fill(),
                node.incoming_reads.fill(),
            )
        return fill

    def notify_group_admission(self, cluster_id: int) -> bool:
        """Serving-front first-admit wake (engine/quiesce.py contract):
        returns True when the group was idle-quiesced and is being woken
        ahead of the admitted op reaching the step loop. Unknown groups
        are a no-op — admission must not fail before the real propose
        path gets to say ErrClusterNotFound itself."""
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None:
            return False
        return node.notify_admission()

    # -------------------------------------------------------------- sessions
    def get_noop_session(self, cluster_id: int) -> Session:
        return Session.noop_session(cluster_id)

    def sync_get_session(self, cluster_id: int, timeout_s: float = 4.0) -> Session:
        """Register a client session (cf. nodehost.go SyncGetSession)."""
        s = Session.new_session(cluster_id)
        s.prepare_for_register()
        self._sync_session_op(s, timeout_s)
        s.prepare_for_propose()
        return s

    def sync_close_session(self, session: Session, timeout_s: float = 4.0) -> None:
        session.prepare_for_unregister()
        self._sync_session_op(session, timeout_s)

    def _sync_session_op(self, session: Session, timeout_s: float) -> None:
        node = self._get_node(session.cluster_id)
        rs = node.propose(session, b"", self._to_ticks(timeout_s))
        result = self._unwrap(rs.wait(timeout_s + 1.0))
        if result.value != session.client_id:
            raise ErrRejected()

    # ------------------------------------------------------------ membership
    def request_add_node(
        self, cluster_id: int, node_id: int, address: str, cc_id: int = 0,
        timeout_s: float = 4.0,
    ) -> RequestState:
        return self._request_config_change(
            cluster_id, ConfigChangeType.ADD_NODE, node_id, address, cc_id, timeout_s
        )

    def request_delete_node(
        self, cluster_id: int, node_id: int, cc_id: int = 0, timeout_s: float = 4.0
    ) -> RequestState:
        return self._request_config_change(
            cluster_id, ConfigChangeType.REMOVE_NODE, node_id, "", cc_id, timeout_s
        )

    def request_add_observer(
        self, cluster_id, node_id, address, cc_id=0, timeout_s=4.0
    ) -> RequestState:
        return self._request_config_change(
            cluster_id, ConfigChangeType.ADD_OBSERVER, node_id, address, cc_id,
            timeout_s,
        )

    def request_add_witness(
        self, cluster_id, node_id, address, cc_id=0, timeout_s=4.0
    ) -> RequestState:
        return self._request_config_change(
            cluster_id, ConfigChangeType.ADD_WITNESS, node_id, address, cc_id,
            timeout_s,
        )

    def _request_config_change(
        self, cluster_id, cctype, node_id, address, cc_id, timeout_s
    ) -> RequestState:
        node = self._get_node(cluster_id)
        cc = ConfigChange(
            config_change_id=cc_id, type=cctype, node_id=node_id, address=address
        )
        flight_recorder().record(
            "config_change_requested", cluster=cluster_id,
            kind=cctype.name, target=node_id, host=self.config.raft_address,
        )
        if address:
            self.transport.nodes.add_node(cluster_id, node_id, address)
        return node.request_config_change(cc, self._to_ticks(timeout_s))

    def sync_request_add_node(self, cluster_id, node_id, address, cc_id=0,
                              timeout_s=4.0) -> None:
        rs = self.request_add_node(cluster_id, node_id, address, cc_id, timeout_s)
        self._unwrap(rs.wait(timeout_s + 1.0))

    def sync_request_delete_node(self, cluster_id, node_id, cc_id=0,
                                 timeout_s=4.0) -> None:
        rs = self.request_delete_node(cluster_id, node_id, cc_id, timeout_s)
        self._unwrap(rs.wait(timeout_s + 1.0))

    def sync_request_add_observer(self, cluster_id, node_id, address, cc_id=0,
                                  timeout_s=4.0) -> None:
        rs = self.request_add_observer(cluster_id, node_id, address, cc_id, timeout_s)
        self._unwrap(rs.wait(timeout_s + 1.0))

    def sync_request_add_witness(self, cluster_id, node_id, address, cc_id=0,
                                 timeout_s=4.0) -> None:
        rs = self.request_add_witness(cluster_id, node_id, address, cc_id, timeout_s)
        self._unwrap(rs.wait(timeout_s + 1.0))

    def get_cluster_membership(self, cluster_id: int) -> Membership:
        node = self._get_node(cluster_id)
        return node.sm.get_membership()

    # ---------------------------------------------------- leadership / status
    def get_leader_id(self, cluster_id: int):
        """Returns (leader_node_id, has_leader)."""
        node = self._get_node(cluster_id)
        lid = node.get_leader_id()
        return lid, lid != 0

    def request_leader_transfer(self, cluster_id: int, target_node_id: int) -> None:
        node = self._get_node(cluster_id)
        node.request_leader_transfer(target_node_id)

    def request_snapshot(
        self, cluster_id: int, export_path: str = "", compaction_overhead: int = 0,
        timeout_s: float = 10.0,
    ) -> RequestState:
        """cf. nodehost.go:877-949 RequestSnapshot (incl. exported)."""
        if export_path and not os.path.isdir(export_path):
            # fail fast before any snapshot work (cf. nodehost.go:905
            # ErrDirNotExist)
            raise ErrDirNotExist(export_path)
        node = self._get_node(cluster_id)
        req = SSRequest(
            type=SS_REQ_EXPORTED if export_path else SS_REQ_USER,
            path=export_path,
            override_compaction=compaction_overhead > 0,
            compaction_overhead=compaction_overhead,
        )
        flight_recorder().record(
            "snapshot_requested", cluster=cluster_id,
            exported=bool(export_path), host=self.config.raft_address,
        )
        return node.request_snapshot(req, self._to_ticks(timeout_s))

    def sync_request_snapshot(self, cluster_id: int, export_path: str = "",
                              timeout_s: float = 10.0) -> int:
        rs = self.request_snapshot(cluster_id, export_path, timeout_s=timeout_s)
        r = rs.wait(timeout_s + 1.0)
        if r.completed:
            return r.snapshot_index
        self._unwrap(r)

    def get_nodehost_info(self, skip_log_info: bool = False) -> NodeHostInfo:
        """cf. nodehost.go:1289-1302 GetNodeHostInfo."""
        out = []
        with self._nodes_mu:
            nodes = list(self._nodes.values())
        for n in nodes:
            st = n.local_status()
            m = n.sm.get_membership()
            out.append(
                ClusterInfo(
                    cluster_id=n.cluster_id,
                    node_id=n.node_id(),
                    nodes=dict(m.addresses),
                    config_change_index=m.config_change_id,
                    is_leader=st["leader_id"] == n.node_id(),
                )
            )
        log_info = [] if skip_log_info else self.logdb.list_node_info()
        return NodeHostInfo(
            raft_address=self.raft_address(),
            cluster_info=out,
            log_info=log_info,
        )

    # -------------------------------------------------------- RTT probing
    def ping_peers(self, cluster_id: Optional[int] = None) -> int:
        """Send Ping probes (cf. nodehost.go:2069-2088 sendPingMessage) to
        every remote member of the given cluster (or all local clusters).
        Pongs echo the monotonic timestamp; RTT samples land in
        get_rtt_samples() and the transport_ping_rtt_us metric. Returns
        the number of probes sent."""
        if self._partitioned:
            return 0  # probes are raft traffic too (monkey.go semantics)
        with self._nodes_mu:
            if cluster_id is not None:
                node = self._nodes.get(cluster_id)
                nodes = [node] if node is not None else []
            else:
                nodes = list(self._nodes.values())
        sent = 0
        now_us = time.monotonic_ns() // 1000
        for n in nodes:
            try:
                members = n.sm.get_membership().addresses
            except Exception:
                continue
            for nid in members:
                if nid == n.node_id():
                    continue
                # deliberately NOT the co-hosted shortcut: the probe
                # measures the WIRE path (a shared-core peer would answer
                # from the inbox and report zero while the NIC is dead)
                if self.transport.send(
                    Message(
                        type=MessageType.PING,
                        cluster_id=n.cluster_id,
                        to=nid,
                        from_=n.node_id(),
                        hint=now_us,
                    )
                ):
                    sent += 1
        return sent

    def get_rtt_samples(self) -> Dict[tuple, List[int]]:
        """(cluster_id, peer_node_id) -> recent RTT samples in microseconds."""
        with self._rtt_mu:
            return {k: list(v) for k, v in self._rtt.items()}

    def _record_pong(self, m: Message) -> None:
        rtt_us = max(0, time.monotonic_ns() // 1000 - m.hint)
        key = (m.cluster_id, m.from_)
        with self._rtt_mu:
            dq = self._rtt.get(key)
            if dq is None:
                from collections import deque

                dq = self._rtt[key] = deque(maxlen=16)
            dq.append(rtt_us)
        self.metrics.set_gauge("transport_ping_rtt_us", key, float(rtt_us))

    # ----------------------------------------------------- chaos-test knobs
    # cf. monkey.go:90-198 (build-tag-gated in the reference; here plain
    # methods — they cost nothing unless used)
    def set_partitioned(self, partitioned: bool) -> None:
        """Partition mode: drop ALL inbound and outbound raft traffic
        (cf. monkey.go:169-198)."""
        flight_recorder().record(
            "partition_set", host=self.config.raft_address,
            partitioned=partitioned,
        )
        self._partitioned = partitioned
        # co-hosted delivery bypasses the transport, so the engine core
        # must drop inbound traffic for this host too
        gate = getattr(self.engine, "set_host_partitioned", None)
        if gate is not None:
            gate(partitioned)

    def is_partitioned(self) -> bool:
        return self._partitioned

    def get_sm_hash(self, cluster_id: int) -> int:
        """Content digest of the node's SM for cross-replica equality checks
        (cf. monkey.go:90-142)."""
        return self._get_node(cluster_id).sm.get_hash()

    def get_session_hash(self, cluster_id: int) -> int:
        return self._get_node(cluster_id).sm.get_session_hash()

    def get_membership_hash(self, cluster_id: int) -> int:
        return self._get_node(cluster_id).sm.get_membership_hash()

    def get_applied_index(self, cluster_id: int) -> int:
        return self._get_node(cluster_id).sm.last_applied_index()

    # ------------------------------------------------------------- transport
    def _send_message(self, m: Message) -> None:
        if self._partitioned:
            return
        if m.type == MessageType.INSTALL_SNAPSHOT:
            self._async_send_snapshot(m)
            return
        # co-hosted short-circuit: replicas living on this process's engine
        # core receive directly (no codec, no transport thread); anything
        # else rides the wire
        deliver = getattr(self.engine, "try_local_deliver", None)
        if deliver is not None and deliver(m):
            return
        self.transport.send(m)

    def _send_messages(self, msgs) -> None:
        """Bulk send: one co-hosted delivery pass (grouped per destination
        lane, one queue lock + one wake per lane) and one grouped
        transport.send_many for whatever must ride the wire. The engine's
        columnar fan-out emits each step's messages through this seam
        instead of per-message _send_message calls."""
        if self._partitioned:
            return
        wire = []
        for m in msgs:
            if m.type == MessageType.INSTALL_SNAPSHOT:
                self._async_send_snapshot(m)
            else:
                wire.append(m)
        deliver_many = getattr(self.engine, "try_local_deliver_many", None)
        if deliver_many is not None:
            wire = deliver_many(wire)
        if not wire:
            return
        send_many = getattr(self.transport, "send_many", None)
        if send_many is not None:
            send_many(wire)
        else:
            for m in wire:
                self.transport.send(m)

    def _on_snapshot_stream_aborted(
        self, cluster_id: int, node_id: int, from_: int, reason: str
    ) -> None:
        """Inbound install stream died (Chunks._drop): open the receiving
        node's fail-fast window so client ops gated on the install get the
        typed ErrSnapshotStreamAborted (+ retry-after hint) instead of a
        generic timeout. The hint is the raft snapshot-status retry
        cadence — when the sender's re-streamed install should have
        landed (cf. feedback.go:38-128 / VectorEngine._run_snapshot_feedback)."""
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None or node.node_id() != node_id:
            return
        retry_ticks = max(4 * node.config.election_rtt, 16)
        node.notify_install_aborted(retry_ticks * self._tick_ms / 1000.0)

    def _recv_chunk(self, chunk) -> bool:
        """Inbound chunk sink with the receive-side bandwidth cap: the
        throttle sleeps the transport's delivery thread, back-pressuring
        the sender's stream naturally."""
        if self._snap_recv_rate is not None:
            self._snap_recv_rate.acquire(getattr(chunk, "chunk_size", 0))
        return self._chunks.add_chunk(chunk)

    def _try_admit_lane(self, addr: str) -> bool:
        with self._lane_mu:
            per = self._lanes_by_target.get(addr, 0)
            if (
                self._lanes_total >= self._max_lanes
                or per >= self._max_lanes_per_target
            ):
                return False
            self._lanes_total += 1
            self._lanes_by_target[addr] = per + 1
        return True

    def _release_lane(self, addr: str) -> None:
        with self._lane_mu:
            self._lanes_total = max(0, self._lanes_total - 1)
            per = self._lanes_by_target.get(addr, 1) - 1
            if per <= 0:
                self._lanes_by_target.pop(addr, None)
            else:
                self._lanes_by_target[addr] = per

    def _async_send_snapshot(self, m: Message) -> None:
        """Stream a snapshot to a lagging peer on a dedicated lane
        (cf. nodehost.go:1724-1744 + transport snapshot.go:55-110), subject
        to the total and per-target lane caps."""
        from .transport.snapshotstream import SnapshotLane

        addr = self.transport.nodes.resolve(m.cluster_id, m.to)
        if addr is None:
            self._report_snapshot_status(m.cluster_id, m.to, True)
            return
        if not self._try_admit_lane(addr):
            # over the cap: fail fast through the status-feedback path (the
            # raft core retries after its snapshot-status window) instead
            # of parking an unbounded thread on a slow sink
            self._report_snapshot_status(m.cluster_id, m.to, True)
            return
        try:
            try:
                ss_state = self._get_node(m.cluster_id).ss
                ss_state.begin_stream()
            except Exception:
                ss_state = None

            def on_done(cluster_id: int, to: int, failed: bool) -> None:
                if ss_state is not None:
                    ss_state.end_stream()
                self._report_snapshot_status(cluster_id, to, failed)

            lane = SnapshotLane(
                self.transport, addr, m, on_done,
                release=lambda: self._release_lane(addr),
                rate_limiter=self._snap_send_rate,
            )
            lane.start()
        except Exception:
            # thread exhaustion etc.: the admitted slot must not leak —
            # a few leaks would permanently fail-fast this target
            self._release_lane(addr)
            self._report_snapshot_status(m.cluster_id, m.to, True)

    def _report_snapshot_status(self, cluster_id: int, node_id: int, failed: bool):
        # status lands in the sender's own raft (remote leaves Snapshot state)
        self.handle_snapshot_status(cluster_id, node_id, failed)

    def handle_message_batch(self, batch) -> None:
        """Inbound traffic (cf. nodehost.go:1978-2026)."""
        if self._partitioned:
            return 0, 0
        snapshot_count = msg_count = 0
        for m in batch.requests:
            if m.type == MessageType.SNAPSHOT_RECEIVED:
                self._on_snapshot_received(m)
                continue
            if m.type == MessageType.PING:
                # transport-level RTT probe: echo without raft involvement
                # (cf. nodehost.go:1759-1773 handlePingMessage)
                self.transport.send(
                    Message(
                        type=MessageType.PONG,
                        cluster_id=m.cluster_id,
                        to=m.from_,
                        from_=m.to,
                        hint=m.hint,
                    )
                )
                continue
            if m.type == MessageType.PONG:
                self._record_pong(m)
                continue
            with self._nodes_mu:
                node = self._nodes.get(m.cluster_id)
            if node is None:
                continue
            if m.to != node.node_id():
                continue
            if m.type == MessageType.INSTALL_SNAPSHOT:
                if node.mq.add_snapshot(m):
                    snapshot_count += 1
            else:
                if node.mq.add(m):
                    msg_count += 1
            self.engine.set_node_ready(m.cluster_id)
        return snapshot_count, msg_count

    def handle_unreachable(self, cluster_id: int, node_id: int) -> None:
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None:
            return
        node.mq.add(
            Message(
                type=MessageType.UNREACHABLE, cluster_id=cluster_id, from_=node_id
            )
        )
        self.engine.set_node_ready(cluster_id)

    def handle_snapshot_status(self, cluster_id: int, node_id: int, failed: bool):
        with self._nodes_mu:
            node = self._nodes.get(cluster_id)
        if node is None:
            return
        node.mq.add(
            Message(
                type=MessageType.SNAPSHOT_STATUS,
                cluster_id=cluster_id,
                from_=node_id,
                reject=failed,
            )
        )
        self.engine.set_node_ready(cluster_id)

    def handle_snapshot(self, cluster_id: int, node_id: int, from_: int) -> None:
        """A snapshot finished arriving: ack the sender
        (cf. nodehost.go:2057-2067)."""
        self.transport.send(
            Message(
                type=MessageType.SNAPSHOT_RECEIVED,
                cluster_id=cluster_id,
                to=from_,
                from_=node_id,
            )
        )

    def _on_snapshot_received(self, m: Message) -> None:
        self.handle_snapshot_status(m.cluster_id, m.from_, False)

    # ------------------------------------------------------------- tick loop
    def set_tick_clock(self, clock: Optional[Callable[[], float]]) -> None:
        """Mount an injectable tick clock (faults.ClockPlane.clock_fn) —
        or None to return to real monotonic time. The tick worker picks
        the new clock up on its next iteration and re-anchors, so a
        mount is never itself misread as a jump."""
        self._tick_clock = clock or time.monotonic

    def _on_clock_anomaly(self, hold_s: float) -> None:
        """The tick clock read backward or diverged from real monotonic
        elapsed — a clock fault, not a scheduling stall (a stall
        advances both clocks equally). The caller sheds the phantom tick
        backlog (no burst replay past the clamp); here we keep the
        fairness gauge honest and put leases on suspect hold so reads
        degrade to ReadIndex instead of trusting a lying clock."""
        self._clock_anomalies += 1
        wd = getattr(self.engine, "watchdog", None)
        if wd is not None:
            try:
                wd.note_clock_anomaly()
            except Exception:
                pass
        suspect = getattr(self.engine, "set_clock_suspect", None)
        if suspect is not None:
            try:
                suspect(hold_s)
            except Exception:
                pass

    def _tick_worker_main(self) -> None:
        """cf. nodehost.go:1668-1684 tickWorkerMain."""
        period = self._tick_ms / 1000.0
        # a tick-clock reading that diverges from REAL monotonic elapsed
        # by more than this (since the last anchor) is a clock fault;
        # divergence below it replays as a bounded, clamp-safe backlog
        divergence_limit = max(8 * period, 0.05)
        # lease-suspect hold after an anomaly: comfortably past one
        # election RTT at default tick rates, so a healed clock must
        # re-earn its lease with a full quorum round
        suspect_hold_s = max(0.25, 32 * period)
        clock = self._tick_clock
        anchor_real = time.monotonic()
        anchor_fault = clock()
        next_t = anchor_fault + period
        next_gauges_t = anchor_fault + 1.0
        last_now = anchor_fault
        while not self._stopped.is_set():
            if clock is not self._tick_clock:
                # live (un)mount: re-anchor, never misread as a jump
                clock = self._tick_clock
                anchor_real = time.monotonic()
                anchor_fault = clock()
                next_t = anchor_fault + period
                last_now = anchor_fault
            now = clock()
            if clock is not time.monotonic:
                real = time.monotonic()
                div = (now - anchor_fault) - (real - anchor_real)
                if now < last_now or abs(div) > divergence_limit:
                    self._on_clock_anomaly(suspect_hold_s)
                    anchor_real, anchor_fault = real, now
                    next_t = now + period  # resync: shed phantom backlog
                    next_gauges_t = min(next_gauges_t, now + 1.0)
                    last_now = now
                    continue
            last_now = now
            if now >= next_gauges_t:
                next_gauges_t = now + 1.0
                try:
                    self._export_health_gauges()
                except Exception:
                    pass  # gauge export must never kill the tick loop
            if now < next_t:
                time.sleep(min(period, next_t - now))
                continue
            # catch-up ticks are coalesced by the MessageQueue counter
            # (scalar engine) or the engine-global tick counter (vector
            # engine: one increment covers every lane, no per-node work)
            global_tick = getattr(self.engine, "global_tick", None)
            while next_t <= now:
                next_t += period
                if global_tick is not None:
                    global_tick()
                else:
                    with self._nodes_mu:
                        nodes = list(self._nodes.values())
                    for n in nodes:
                        n.mq.add(Message(type=MessageType.LOCAL_TICK))
                        self.engine.set_node_ready(n.cluster_id)
                self._chunks.tick()  # abandoned inbound stream GC

    def _export_health_gauges(self) -> None:
        """Refresh host-level gauges (label key (0, 0)) in the
        MetricsRegistry: the engine's tick-fairness watchdog and the
        transport's breaker/queue state. Runs ~1/s on the tick thread so
        the Prometheus exposition (write_health_metrics) always carries a
        recent starvation/backpressure picture."""
        fairness = getattr(self.engine, "fairness_stats", None)
        if fairness is not None:
            s = fairness()
            key = (0, 0)
            self.metrics.set_gauge(
                "engine_tick_starvation_ratio", key, s["starvation_ratio"]
            )
            self.metrics.set_gauge(
                "engine_tick_gap_max_seconds", key, s["recent_max_gap_s"]
            )
            self.metrics.set_gauge(
                "engine_fairness_yields", key, s["fairness_yields"]
            )
            self.metrics.set_gauge(
                "engine_tick_bursts_clamped", key, s["tick_bursts_clamped"]
            )
        tm = self.transport.metrics()
        for name in (
            "breakers_open",
            "breaker_probe_failures",
            "dropped_while_open",
            "queue_evicted_bulk",
            "queue_dropped_bulk",
            "queue_dropped_urgent",
            "queued_urgent",
            "queued_bulk",
        ):
            if name in tm:
                self.metrics.set_gauge(f"transport_{name}", (0, 0), tm[name])
        # vector-engine per-step columnar counters (messages by plane,
        # commit-advancing lanes, elections, applied entries) — derived
        # host-side from decoded StepOutput, no device syncs to read
        step_stats = getattr(self.engine, "step_stats", None)
        if step_stats is not None:
            for name, v in step_stats().items():
                self.metrics.set_gauge(f"engine_step_{name}", (0, 0), float(v))
        # runtime device-sync / retrace audit (profile.py): total and
        # out-of-seam transfer counts plus kernel-build events, so a stray
        # sync or steady-state retrace is visible on the same dashboard
        # that watches throughput (counter semantics, exported 1/s)
        sa = sync_audit().snapshot()
        self.metrics.set_gauge(
            "engine_device_syncs_total", (0, 0),
            float(sa["in_seam"] + sa["out_of_seam"]),
        )
        self.metrics.set_gauge(
            "engine_device_syncs_out_of_seam", (0, 0),
            float(sa["out_of_seam"]),
        )
        # the multi-step engine's amortization ratio: protocol steps per
        # blessed _fetch_output/_fetch_super transfer (~1 classic, ~K
        # with steps_per_sync=K) — the honest denominator for the
        # zero-out-of-seam-per-step assertion at any K
        self.metrics.set_gauge(
            "engine_steps_per_sync", (0, 0),
            float(sa.get("steps_per_sync", 0.0)),
        )
        self.metrics.set_gauge(
            "engine_compile_events_total", (0, 0),
            float(compile_watch().total),
        )
        # history-sampler cost accounting: ALWAYS exported (zero-filled
        # when no sampler runs) so the engine_history_* schema is stable
        # and a dashboard can prove the sampler's overhead stayed noise
        sampler = self._history
        hs = (
            sampler.stats() if sampler is not None
            else HistorySampler.empty_stats()
        )
        for hname, v in hs.items():
            self.metrics.set_gauge(f"engine_history_{hname}", (0, 0), float(v))
        # HBM census: device-plane bytes + per-lane log fill vs the dense
        # widest-lane allocation (VectorEngine folds from its numpy
        # mirrors, the scalar engine reports an all-zero shape twin) —
        # the paged-arena sizing baseline on the live dashboard
        census = getattr(self.engine, "device_census", None)
        if census is not None:
            c = census()
            for gname, ckey in (
                ("engine_hbm_bytes_total", "hbm_bytes_total"),
                ("engine_hbm_log_bytes", "hbm_log_bytes"),
                ("engine_hbm_log_fill_p50", "log_fill_p50"),
                ("engine_hbm_log_fill_p99", "log_fill_p99"),
                ("engine_hbm_waste_ratio", "hbm_waste_ratio"),
            ):
                self.metrics.set_gauge(gname, (0, 0), float(c[ckey]))
        # protocol-event counter plane (ops/state.CTR): accumulated
        # on-device inside step_batch, decoded through the blessed fetch
        # seam — exporting is a numpy fold, never a device sync
        counter_stats = getattr(self.engine, "counter_stats", None)
        if counter_stats is not None:
            for name, v in counter_stats().items():
                self.metrics.set_gauge(
                    f"engine_counter_{name}", (0, 0), float(v)
                )
        # per-lane (cluster_id-labelled) introspection from the engine's
        # numpy mirrors: leader, term, commit gap, ticks since the last
        # leader change — zero device syncs (see VectorEngine.lane_stats)
        # serving-front overload plane: the per-tenant admit/shed/wake
        # ledger, queue depths and the folded saturation score (the
        # latency histograms are fed live by the completion callbacks)
        front = self._serving
        if front is not None:
            front.export_gauges(self.metrics)
        # placement plane: the migration ledger (started/completed/
        # aborted), same cadence as the serving gauges
        plane = self._placement
        if plane is not None:
            plane.export_gauges(self.metrics)
        lane_stats = getattr(self.engine, "lane_stats", None)
        if lane_stats is not None:
            for cid, s in lane_stats().items():
                key = (cid, s["node_id"])
                self.metrics.set_gauge(
                    "engine_lane_leader_id", key, float(s["leader_id"])
                )
                self.metrics.set_gauge(
                    "engine_lane_term", key, float(s["term"])
                )
                self.metrics.set_gauge(
                    "engine_lane_commit_gap", key, float(s["commit_gap"])
                )
                self.metrics.set_gauge(
                    "engine_lane_ticks_since_leader_change", key,
                    float(s["ticks_since_leader_change"]),
                )


__all__ = [
    "NodeHost",
    "ClusterInfo",
    "ErrClusterAlreadyExist",
    "ErrInvalidClusterSettings",
]
