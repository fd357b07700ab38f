"""Declarative analysis targets: WHICH code of the PyTorch port each rule
family watches.

This file is the contract between the port's performance/concurrency
architecture and the rule engine. Every table is derived from the port's
own code (`dragonboat_tpu_torch/`), not from the JAX package's names:

  * the engine step loop's hot functions (pack -> dispatch -> ship ->
    fetch -> decode/fan-out -> save, `engine/vector.py`) where
    per-message Python, host waits on the card and unguarded telemetry
    are regressions;
  * the two blessed sync seams, `VectorEngine._fetch_output` and
    `VectorEngine._fetch_super` — the same pair as the runtime
    `profile.SyncAudit.BLESSED` — and the device roots: the engine's
    tensors on the card (every lane block's state tree, residual inbox
    and device planes under `self._shards`, one block when unsharded;
    and the single-tree names of the JAX package's engine, `self._state`,
    `self._resid`, `self._dev_in`/`self._dev_inbox`, `self._dev_out`) and
    the pinned host slots the fetch reads (`self._out_slots`), which are
    not safe to read before the seam's event waits (one per shard);
  * the kernel-build family: the one blessed loader `ops/cuda.py:_lib`
    (it builds on first use, under a lock, and caches the library), the
    calls that build or load kernels (`build_kernels`, `ctypes.CDLL`,
    `torch.utils.cpp_extension.load*`), and the launch wrappers
    `step_batch_cuda` and `multi_step_cuda`, which must read no tensor on
    the host;
  * the declared LOCK HIERARCHY of the host runtime (the copied host
    modules and the port's own engine, NodeHost and profile) and the
    shared state each lock guards.

The JAX package's `retrace/*` family has no subject here: the port has
no jit, no tracer and no executable cache. Its four rules map as:

  * `retrace/python-branch-on-traced` -> `build/branch-in-launch`: a
    Python branch on a tensor in a launch wrapper calls `bool()` on it,
    a host sync on every launch;
  * `retrace/concretize-traced` -> `build/host-read-in-launch`: `int()`,
    `.item()`, `.cpu()` and the like on a tensor in a launch wrapper;
  * `retrace/jit-in-hot` -> `build/build-in-hot`: the port's counterpart
    of a compile on the step path is a kernel build or library load
    (`CompileWatch` counts builds at run time; e2e gates them at 0);
  * `retrace/dict-iter-in-traced` -> nothing, because nothing is keyed
    on call structure: a kernel's parameter struct is filled by field
    name from declared tuples (`ops/cuda.py:_PTR_FIELDS`, `_put`), and
    its layout is checked once against the library's own
    `*_params_size()` when `_lib` loads it.

Their cross-function twins map the same way: `retrace/cross-function-
taint` -> `build/cross-function-taint` (tensor taint from the launch
wrappers into the helpers they call), and the reachability half of the
build family, `build/cross-function`, has no JAX counterpart.

Paths are package-relative ("engine/vector.py"); functions are qualnames
("VectorEngine._decode", nested defs as "make_step_fn.step").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

VECTOR = "engine/vector.py"
NODE = "engine/node.py"
NODEHOST = "nodehost.py"
TRANSPORT = "transport/transport.py"
LOGDB = "storage/logdb.py"
KV = "storage/kv.py"
TRACE = "trace.py"
PROFILE = "profile.py"
MANAGED = "rsm/managed.py"
KERNEL = "ops/kernel.py"
CUDA = "ops/cuda.py"
SERVING_ADMISSION = "serving/admission.py"
SERVING_BACKPRESSURE = "serving/backpressure.py"
SERVING_FRONT = "serving/front.py"
SERVING_SESSIONS = "serving/sessions.py"
SERVING_PLACEMENT = "serving/placement.py"
CHUNKS = "transport/chunks.py"
FAULTS = "faults.py"

FnKey = Tuple[str, str]  # (relpath, qualname)


@dataclass
class LockSpec:
    """One declared lock: its rank in the acquisition hierarchy (SMALLER =
    must be taken FIRST / outermost) and a one-line role description."""

    cls: str  # owning class name
    attr: str  # attribute name on instances of cls
    rank: int
    doc: str = ""


@dataclass
class Targets:
    """The full target configuration handed to every rule."""

    # ---- hot-path families (columnar fan-out) ----------------------------
    hot_functions: Set[FnKey] = field(default_factory=set)
    hot_lock_functions: Set[FnKey] = field(default_factory=set)
    hot_telemetry_functions: Set[FnKey] = field(default_factory=set)
    hot_trace_functions: Set[FnKey] = field(default_factory=set)

    # ---- device-sync family ---------------------------------------------
    # the blessed host waits on the step path (SyncAudit.BLESSED's pair)
    blessed_sync: Set[FnKey] = field(default_factory=set)
    # dotted prefixes that name device-resident values in hot functions
    device_roots: Set[str] = field(default_factory=set)

    # ---- kernel-build family --------------------------------------------
    # the one loader allowed to build/load a kernel library (cached)
    blessed_build: Set[FnKey] = field(default_factory=set)
    # dotted call names that build or load kernels; a call matches when
    # its dotted name equals one or ends with "." + one
    build_calls: Set[str] = field(default_factory=set)
    # wrappers that launch a kernel: they must read no tensor on the host
    launch_wrappers: Set[FnKey] = field(default_factory=set)
    # parameter names that never carry a tensor in a launch wrapper
    static_param_names: Set[str] = field(default_factory=set)

    # ---- lock-discipline family -----------------------------------------
    locks: List[LockSpec] = field(default_factory=list)
    # variable-name -> class hints for non-self lock expressions (sh._mu)
    lock_var_hints: Dict[str, str] = field(default_factory=dict)
    # relpath -> {class -> {field -> guarding lock attr}}
    guarded_state: Dict[str, Dict[str, Dict[str, str]]] = field(
        default_factory=dict
    )
    # method-name suffix asserting the caller already holds the lock
    locked_suffix: str = "_locked"

    # ---- interprocedural families ---------------------------------------
    # (cls, attr) of locks on the engine step / per-node protocol path: a
    # blocking call (fsync, .result(), sleep, queue wait) TRANSITIVELY
    # reachable while one is held stalls the step loop for every lane
    # (locks/blocking-under-hot-lock)
    hot_locks: Set[Tuple[str, str]] = field(default_factory=set)
    # rule ids / families whose allow() pragmas are exempt from
    # pragma/unused (rules gated off by configuration fire nothing)
    unused_pragma_allowlist: Set[str] = field(default_factory=set)

    # -- queries -----------------------------------------------------------
    def is_hot(self, key: FnKey) -> bool:
        return key in self.hot_functions

    def is_hot_lock(self, key: FnKey) -> bool:
        return key in self.hot_lock_functions or key in self.hot_functions

    def is_hot_lock_spec(self, spec: Optional["LockSpec"]) -> bool:
        return spec is not None and (spec.cls, spec.attr) in self.hot_locks

    def is_build_call(self, dotted: str) -> bool:
        return any(
            dotted == c or dotted.endswith("." + c) for c in self.build_calls
        )

    def lock_rank(self, cls: Optional[str], attr: str, module=None):
        """Resolve (class, attr) -> LockSpec; subclass names resolve
        through the module's base map when one is provided."""
        for spec in self.locks:
            if spec.attr != attr:
                continue
            if cls is None or spec.cls == cls:
                return spec
            if module is not None and module.is_subclass_of(cls, spec.cls):
                return spec
        return None

    def all_function_targets(self):
        """(relpath, qualname, why) for config-drift detection."""
        for name in (
            "hot_functions",
            "hot_lock_functions",
            "hot_telemetry_functions",
            "hot_trace_functions",
            "blessed_sync",
            "blessed_build",
            "launch_wrappers",
        ):
            for relpath, qualname in sorted(getattr(self, name)):
                yield relpath, qualname, name


def _default_targets() -> Targets:
    # the step hot path: every function here runs once per engine step on
    # the loop thread (pack -> dispatch -> ship -> fetch -> decode/fan-out
    # -> save)
    hot = {
        (VECTOR, "VectorEngine._run_once"),
        (VECTOR, "VectorEngine._pack"),
        (VECTOR, "VectorEngine._pack_wire"),
        (VECTOR, "VectorEngine._stage_row"),
        (VECTOR, "VectorEngine._flush_staged_rows"),
        # the async copy of the step's output into the next pinned slot
        # and the event record (K=1 and K>1)
        (VECTOR, "VectorEngine._ship_output"),
        (VECTOR, "VectorEngine._ship_super"),
        # the per-shard ship and the join of the fetched shard parts
        (VECTOR, "VectorEngine._ship_shards"),
        (VECTOR, "VectorEngine._join_slot"),
        (VECTOR, "VectorEngine._fetch_output"),
        (VECTOR, "VectorEngine._fetch_super"),
        # the pipelined decode of step t-1 while step t runs
        (VECTOR, "VectorEngine._flush_one"),
        (VECTOR, "VectorEngine._decode"),
        # the decode phase bodies (shared by the K-step super-step path)
        # and the multi-step machinery — all once per step / inner step
        (VECTOR, "VectorEngine._decode_super"),
        (VECTOR, "VectorEngine._decode_place"),
        (VECTOR, "VectorEngine._refresh_mirrors"),
        (VECTOR, "VectorEngine._decode_send_rep"),
        (VECTOR, "VectorEngine._commit_saves"),
        (VECTOR, "VectorEngine._decode_send_post"),
        (VECTOR, "VectorEngine._decode_apply"),
        (VECTOR, "VectorEngine._decode_reads"),
        (VECTOR, "VectorEngine._routed_rep_plan"),
        (VECTOR, "VectorEngine._place_routed_reps"),
        (VECTOR, "VectorEngine._mask_routed"),
        (VECTOR, "VectorEngine._dispatch_sends"),
        (VECTOR, "VectorEngine._save_updates"),
        (VECTOR, "VectorEngine.try_local_deliver_many"),
        (VECTOR, "gather_replicate_sends"),
        (VECTOR, "gather_post_sends"),
        (VECTOR, "gather_resp_sends"),
        (VECTOR, "build_save_updates"),
    }
    # the transport send hot path: one lock/breaker-check per TARGET
    # BATCH, never per message
    hot_lock = {
        (TRANSPORT, "Transport.send_many"),
        (TRANSPORT, "_SendQueue.put_many"),
    }
    hot_telemetry = set(hot) | set(hot_lock) | {
        (TRANSPORT, "_SendQueue._admit_locked"),
        # the step-phase profiler's stamping seams: Sample.record + the
        # phase-plane fan-out run once per stage per step — they must stay
        # inside the `if self.sampling` gate
        (TRACE, "Profiler.end"),
        (TRACE, "Profiler.add"),
        (PROFILE, "PhasePlane.on_phase"),
    }
    # request entry points that mint trace ids + the decode/send phases
    # that propagate them: unsampled requests stay allocation/event-free
    hot_trace = {
        (NODE, "Node.propose"),
        (NODE, "Node.propose_batch"),
        (NODE, "Node.propose_batch_async"),
        (NODE, "Node.apply_raft_update"),
        (VECTOR, "gather_replicate_sends"),
        (VECTOR, "gather_resp_sends"),
        (VECTOR, "VectorEngine._pack_wire"),
        (VECTOR, "VectorEngine._decode"),
        (VECTOR, "VectorEngine._decode_apply"),
        (TRANSPORT, "Transport.send_many"),
    }
    # the declared lock hierarchy, outermost first. Acquisition must go
    # DOWN this table; taking an equal-or-outer lock while holding an
    # inner one is an ordering violation.
    locks = [
        LockSpec(
            "ManagedStateMachine", "_mu", 10,
            "SM serialization (exclusive()): update+applied-advance and "
            "snapshot index+data each form one critical section",
        ),
        LockSpec(
            "_Shard", "_wmu", 20,
            "logdb shard writer lock: append vs compaction boundary-batch "
            "rewrite",
        ),
        LockSpec(
            "_Shard", "_mu", 30,
            "logdb shard cache lock (state/max-index/last-batch caches)",
        ),
        LockSpec(
            "Chunks", "_mu", 36,
            "inbound snapshot-stream tracker; held across finalize's "
            "InstallSnapshot handoff and the abort notify, both of which "
            "take NodeHost._nodes_mu inside it",
        ),
        LockSpec(
            "PlacementPlane", "_mu", 35,
            "placement plan/active-migration table + migration ledger; "
            "outer of NodeHost._nodes_mu",
        ),
        LockSpec(
            "SessionManager", "_mu", 37,
            "session pool + lifecycle counters; outer of "
            "NodeHost._nodes_mu",
        ),
        LockSpec(
            "NodeHost", "_nodes_mu", 38,
            "node registry + launch-spec table (stop/crash/restart_cluster "
            "transition through it); released before any engine or node "
            "lock is taken",
        ),
        LockSpec(
            "Transport", "_mu", 40,
            "transport registry lock (queue/breaker maps)",
        ),
        LockSpec(
            "Node", "_mu", 41,
            "per-node protocol lock (step vs API surface); API paths take "
            "it before marking the engine dirty",
        ),
        LockSpec(
            "VectorEngine", "_lanes_mu", 42, "engine lane registry",
        ),
        LockSpec(
            "VectorEngine", "_dirty_mu", 44,
            "engine dirty-set / pending-tick state",
        ),
        LockSpec(
            "VectorEngine", "_snap_status_mu", 44,
            "engine snapshot-completion set",
        ),
        LockSpec(
            "ServingFront", "_mu", 45,
            "serving-front tenant queue table; released before "
            "propose_batch is called",
        ),
        LockSpec(
            "AdmissionController", "_mu", 46,
            "admission tenant registry + admit/shed ledger",
        ),
        LockSpec(
            "SaturationMonitor", "_mu", 47,
            "cached saturation score + last signal sample",
        ),
        LockSpec(
            "_SendQueue", "_cv", 50,
            "send-queue condition (urgent/bulk deques + admission counters)",
        ),
        LockSpec(
            "_Breaker", "_mu", 50, "circuit-breaker state",
        ),
        LockSpec(
            "TokenBucket", "_mu", 55,
            "token-bucket balance/refill-time pair (leaf)",
        ),
        LockSpec(
            "_BarrierStats", "_mu", 60,
            "WAL barrier-pressure gauge (leaf: taken inside the fsync "
            "seam with shard locks already held)",
        ),
        LockSpec(
            "MmapRing", "_mu", 60,
            "flight-ring slot seal (leaf: taken with no other lock held)",
        ),
        LockSpec(
            "PhasePlane", "_mu", 60,
            "phase-histogram table (leaf: dict probe only)",
        ),
        LockSpec(
            "SyncAudit", "_mu", 60,
            "device-sync site-attribution table (leaf)",
        ),
        LockSpec(
            "ClockPlane", "_mu", 60,
            "per-host clock-fault table (leaf: clock_fn closures read it "
            "from every tick worker with no other lock held)",
        ),
        LockSpec(
            "CompileWatch", "_mu", 60,
            "kernel-build counters + registered-function table (leaf)",
        ),
        LockSpec(
            "DeviceCensus", "_mu", 60,
            "device-memory census plane table (leaf)",
        ),
        LockSpec(
            "HistorySampler", "_mu", 60,
            "telemetry-history ring handle (leaf)",
        ),
    ]
    guarded_state = {
        TRANSPORT: {
            "_SendQueue": {
                "_urgent": "_cv",
                "_bulk": "_cv",
                "_closed": "_cv",
                "evicted_bulk": "_cv",
                "dropped_bulk": "_cv",
                "dropped_urgent": "_cv",
            },
            "_Breaker": {
                "_state": "_mu",
                "_fails": "_mu",
                "_nominal": "_mu",
                "_cooldown": "_mu",
                "_opened_at": "_mu",
                "_probe_inflight": "_mu",
                "opens": "_mu",
                "probes": "_mu",
                "probe_failures": "_mu",
            },
        },
        LOGDB: {
            "_Shard": {
                "_state_cache": "_mu",
                "_max_index_cache": "_mu",
                "_batch_cache": "_mu",
            },
        },
        TRACE: {
            "MmapRing": {"_seq": "_mu", "_mm": "_mu"},
        },
        PROFILE: {
            "PhasePlane": {"_hists": "_mu"},
            "SyncAudit": {"_out": "_mu"},
            "CompileWatch": {"_fns": "_mu", "_builds": "_mu"},
            "DeviceCensus": {"_planes": "_mu"},
            "HistorySampler": {"_ring": "_mu"},
        },
        MANAGED: {
            "ManagedStateMachine": {"_destroyed": "_mu"},
        },
        VECTOR: {
            "VectorEngine": {
                "_dirty": "_dirty_mu",
                "_gc_set": "_dirty_mu",
                "_pending_ticks": "_dirty_mu",
                "_snap_status": "_snap_status_mu",
                "_lanes": "_lanes_mu",
                # lane recycling: the free list, g->lane table and message
                # route are read by the loop/delivery hot paths and
                # mutated by add/remove/_deactivate
                "_free": "_lanes_mu",
                "_lane_by_g": "_lanes_mu",
                "_route": "_lanes_mu",
                # per-host suspect deadlines written by tick workers and
                # drained by the loop thread
                "_clock_suspect": "_dirty_mu",
            },
        },
        FAULTS: {
            "ClockPlane": {"_hosts": "_mu"},
        },
        NODEHOST: {
            "NodeHost": {
                "_nodes": "_nodes_mu",
                "_launch_specs": "_nodes_mu",
                "_migrating": "_nodes_mu",
            },
        },
        KV: {
            "_BarrierStats": {
                "ewma_s": "_mu",
                "last_s": "_mu",
                "last_wave_s": "_mu",
                "inflight": "_mu",
                "barriers": "_mu",
            },
        },
        SERVING_ADMISSION: {
            "AdmissionController": {"_tenants": "_mu"},
            "TokenBucket": {"tokens": "_mu", "_t": "_mu"},
        },
        SERVING_BACKPRESSURE: {
            "SaturationMonitor": {
                "_cached": "_mu",
                "_cached_at": "_mu",
                "_last_signals": "_mu",
            },
        },
        SERVING_FRONT: {
            "ServingFront": {"_queues": "_mu"},
        },
        SERVING_SESSIONS: {
            "SessionManager": {
                "_pools": "_mu",
                "_counters": "_mu",
                "_dead": "_mu",
            },
        },
        SERVING_PLACEMENT: {
            "PlacementPlane": {
                "_active": "_mu",
                "_counters": "_mu",
                "_last_lanes": "_mu",
                "_abort": "_mu",
            },
        },
        CHUNKS: {
            "Chunks": {
                "_tracked": "_mu",
                "_tick": "_mu",
                "_resumed_streams": "_mu",
                "_skipped_chunks": "_mu",
                "_aborted_streams": "_mu",
                "_completed_streams": "_mu",
                "_migration_streams": "_mu",
            },
        },
    }
    return Targets(
        hot_functions=hot,
        hot_lock_functions=hot_lock,
        hot_telemetry_functions=hot_telemetry,
        hot_trace_functions=hot_trace,
        blessed_sync={
            (VECTOR, "VectorEngine._fetch_output"),
            # the multi-step engine's once-per-K-steps wait
            (VECTOR, "VectorEngine._fetch_super"),
        },
        device_roots={
            "self._state",
            "self._resid",
            "self._dev_in",
            "self._dev_inbox",
            "self._dev_out",
            "self._out_slots",
            # the lane blocks' trees and planes
            "self._shards",
        },
        blessed_build={(CUDA, "_lib")},
        build_calls={
            "build_kernels",
            "CDLL",
            "cdll.LoadLibrary",
            "cpp_extension.load",
            "cpp_extension.load_inline",
        },
        launch_wrappers={
            (CUDA, "step_batch_cuda"),
            (CUDA, "multi_step_cuda"),
        },
        # the step count of a super-step and the config are Python values
        # fixed per engine; the device names a card, not a tensor
        static_param_names={"cfg", "steps", "device", "what", "name"},
        locks=locks,
        lock_var_hints={
            "node": "Node",
            "sh": "_Shard",
            "sq": "_SendQueue",
            "breaker": "_Breaker",
        },
        guarded_state=guarded_state,
        # blocking work must never be reachable under these: the engine
        # lane/dirty/snap registries gate the step loop itself, and
        # Node._mu gates every protocol step and API call on that node
        hot_locks={
            ("VectorEngine", "_lanes_mu"),
            ("VectorEngine", "_dirty_mu"),
            ("VectorEngine", "_snap_status_mu"),
            ("Node", "_mu"),
        },
    )


DEFAULT_TARGETS = _default_targets()

__all__ = [
    "DEFAULT_TARGETS",
    "FnKey",
    "LockSpec",
    "Targets",
    "CHUNKS",
    "CUDA",
    "FAULTS",
    "KERNEL",
    "KV",
    "LOGDB",
    "MANAGED",
    "NODE",
    "NODEHOST",
    "PROFILE",
    "SERVING_ADMISSION",
    "SERVING_BACKPRESSURE",
    "SERVING_FRONT",
    "SERVING_PLACEMENT",
    "SERVING_SESSIONS",
    "TRACE",
    "TRANSPORT",
    "VECTOR",
]
