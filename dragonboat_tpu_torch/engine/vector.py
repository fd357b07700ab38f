"""VectorEngine: the device-kernel-backed execution engine.

The scalar ExecEngine advances each group with a per-group Peer inside
worker threads (cf. reference execengine.go:474-560). This engine is the
device-first replacement: ALL groups hosted by a NodeHost live as lanes of
one (G, P) tensor state (ops/state.RaftTensors) on one torch device
(EngineConfig.device) and advance together in one kernel step
(ops/kernel.step_batch: the hand-written CUDA kernel on the card, the plain
PyTorch version on the CPU). The host side of the engine

  1. packs per-group events (wire messages, proposals, reads, config
     changes, transfers) into the device Inbox,
  2. ships the inbox in ONE host->device copy and runs the step,
  3. fans the StepOutput out with the reference's ordering invariants
     (cf. execengine.go:474-560): Replicate messages leave BEFORE the
     fsync; hard state + new entries are persisted in ONE batched
     save_raft_state call for every lane; responses (vote grants,
     ReplicateResp) leave only after persistence; committed entries are
     handed to the RSM task workers after persistence.

The host half is vectorized to match the device half: work is driven by a
dirty set (only lanes with pending host events are touched in Python),
ticks are a single engine-global counter folded into one device tick
array (replacing per-lane LocalTick messages, cf. node.go:1152-1159),
per-lane protocol mirrors live in whole-G numpy arrays refreshed from one
device->host copy per step, and lane activation is batched into one
`index_put_` per state field instead of per-lane device writes. Idle lanes
cost zero host work per step.

Columnar host dataflow (the step loop's host half stays O(active lanes),
never O(messages) Python):

  pack    - inbox rows are STAGED as column lists (_stage_row) and land in
            the numpy planes as one fancy-indexed scatter per plane
            (_flush_staged_rows), not ten scalar stores per message;
            per-lane mirror reads are gathered once per step as columns.
  fetch   - ONE consolidated device->host transfer of the StepOutput per
            step (_fetch_output, shared by the overlap/non-overlap paths):
            the step writes its planes into views of one device byte
            buffer, which lands in pinned host memory in one copy. The
            arrays are small (G- and GxP-sized), so per-copy overhead
            dominates and one copy beats per-plane fetches.
  fan-out - each decode phase derives its (g, p)/(g, k) work list from one
            np.nonzero and gathers every needed field as whole columns
            (`arr[gs, ps].tolist()`), so the per-message Python is just
            tuple unpacking + Message construction at the transport
            boundary; batches leave through Node._send_messages ->
            NodeHost._send_messages -> VectorEngine.try_local_deliver_many
            (one queue lock + one wake per destination lane) or
            Transport.send_many (grouped per target address).
  save    - every lane's per-step save is ONE multi-group write wave:
            a single write-batch per touched logdb shard with the
            durability barrier deferred, then one parallel sync over all
            touched WALs (storage/logdb.save_raft_state_deferred +
            storage/kv.sync_all), so a step pays max(fsync) not sum.

The kernel advances all groups in one step, and the host fans its output
out in whole-plane numpy instead of per-(group, peer) Python.

Payload bytes never touch the device: the kernel works on (index, term,
is_cc) metadata while the engine keeps an arena of Entry objects keyed by
(lane, real index). The kernel reports where each proposal/replicate landed
(StepOutput.prop_base / rep_base) so the host places payloads at the
device-assigned indexes without guessing.

Node identity on device is the peer slot (0..P-1). The canonical mapping is
rank-in-sorted-order of the member node ids, recomputed whenever membership
changes — a pure function of the (replicated) membership image, so every
replica derives the same mapping at the same applied index. The wire always
carries real node ids and real (un-rebased) indexes.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config, NodeHostConfig
from ..core.peer import PeerAddress, encode_config_change
from ..core.raft import _make_metadata_entries, _make_witness_snapshot
from ..core.rate import ENTRY_OVERHEAD_BYTES
from ..logger import get_logger
from ..ops.cuda import (
    ACT_COLUMNS,
    ACT_ROWS,
    ACT_SET,
    ACT_ZERO,
    _output_layout,
    activate_cuda,
    rebase_cuda,
    activation_layout,
    packed_spans,
    packed_views,
)
from ..ops.kernel import make_multi_step_fn, make_sharded_multi_step_fn, step_batch
from ..ops.state import (
    CTR,
    CTR_NAMES,
    MSG,
    NEED_SNAPSHOT,
    ROLE,
    RSTATE,
    SEND_HEARTBEAT,
    SEND_REPLICATE,
    SEND_TIMEOUT_NOW,
    SEND_VOTE_REQ,
    Inbox,
    KernelConfig,
    RaftTensors,
    init_state,
    StepOutput,
    RoutePlan,
    lane_seed,
    make_empty_inbox,
    rebase,
    resolve_device,
)
from ..profile import (
    HOT_LANE_COUNTERS,
    DeviceCensus,
    compile_watch,
    note_engine_steps,
    note_seam_sync,
    phase_plane,
)
from ..requests import LogicalClock
from ..settings import soft
from ..storage.kv import sync_all as _kv_sync_all
from ..trace import LatencySampler, Profiler, flight_recorder
from ..types import (
    Entry,
    EntryType,
    Message,
    MessageType,
    ReadyToRead,
    Snapshot,
    State,
    SystemCtx,
    Update,
)
from ..rsm.manager import From as OffloadFrom
from .execengine import WorkReady
from .fairness import FairnessWatchdog
from .node import Node

_plog = get_logger("vectorengine")

MT = MessageType

# device index value guard: rebase once any lane's last index crosses this
_REBASE_THRESHOLD = 1 << 30

# ctx encoding over TWO int32 device planes: the low plane carries
# (origin_slot + 1) << 24 | ctx.low[0:24], the high plane ctx.low[24:55].
# 55 bits of the node's sequential read counter plus the origin slot are
# collision-free for any realistic pending window (the reference carries a
# 128-bit random SystemCtx in the message envelope, requests.go:365-381;
# the origin slot rides inside the hint so a leader can route confirmed
# forwarded reads back to the requesting replica, raft.go:1871-1898)
_CTX_LOW_MASK = 0xFFFFFF


def _enc_ctx(origin_slot: int, low: int) -> tuple:
    return (
        ((origin_slot + 1) << 24) | (low & _CTX_LOW_MASK),
        (low >> 24) & 0x7FFFFFFF,
    )


def _ctx_origin(enc_lo: int) -> int:
    return (enc_lo >> 24) - 1


#: activate_packed calls (activate_lanes goes through it) by batch size
#: (the padded bucket): how many batches a bring-up takes
ACTIVATIONS: Dict[int, int] = {}


def activate_lanes_reference(s: RaftTensors, gi: torch.Tensor,
                             v: Dict[str, torch.Tensor]) -> RaftTensors:
    """The plain version of lane activation: write n lanes' bring-up values
    into the state IN PLACE, one ``index_put_`` per plane. ``gi`` holds the
    n lane rows and ``v`` the per-lane values (tensors on the state's
    device, one row per lane: ACT_COLUMNS and ACT_ROWS). The engine pads a
    batch to a power-of-4 bucket by repeating its last lane: duplicate
    indexes carry equal values, so the writes are order-free, and no
    padded index ever reaches G. Returns the same state."""
    gi = (gi.to(device=s.term.device, dtype=torch.long),)
    n = gi[0].shape[0]
    for name in ACT_SET:
        getattr(s, name).index_put_(gi, v[name])
    for name in ACT_ZERO:
        t = getattr(s, name)
        t.index_put_(gi, torch.zeros((), dtype=t.dtype, device=t.device))
    s.active.index_put_(gi, torch.ones((), dtype=torch.bool, device=s.active.device))
    s.next.index_put_(gi, v["next"][:, None].expand(n, s.next.shape[1]))
    s.rstate.index_put_(gi, torch.full((), RSTATE.RETRY, dtype=torch.int32,
                                       device=s.rstate.device))
    return s


def activate_lanes(s: RaftTensors, gi: torch.Tensor, v: Dict[str, torch.Tensor]) -> RaftTensors:
    """Lane activation of n lane rows ``gi`` with their values ``v`` (see
    activate_lanes_reference), in place: the rows and values copied into
    one packed buffer on the state's device, then activate_packed (on the
    card csrc/activate.cu, raising when it does not build or launch)."""
    n = int(gi.shape[0])
    layout = activation_layout(n, s.member.shape[1], s.log_term.shape[1])
    buf = torch.empty((packed_spans(layout)[1],), dtype=torch.uint8, device=s.term.device)
    for name, view in packed_views(buf, layout).items():
        view.copy_(gi if name == "rows" else v[name])
    return activate_packed(s, buf, n)


def unpack_activation(packed: torch.Tensor, n: int, P: int, W: int):
    """(lane rows, name -> per-lane values) of a packed activation buffer
    of n lane rows (ops/cuda.py:activation_layout), as views of it."""
    v = packed_views(packed, activation_layout(n, P, W))
    return v.pop("rows"), v


def activate_packed_reference(s: RaftTensors, packed: torch.Tensor, n: int) -> RaftTensors:
    """The plain version of csrc/activate.cu: the lane rows and values read
    from the packed buffer through its layout, then written as
    activate_lanes_reference writes them. Returns the state."""
    rows, v = unpack_activation(packed, n, s.member.shape[1], s.log_term.shape[1])
    return activate_lanes_reference(s, rows, v)


def activate_packed(s: RaftTensors, packed: torch.Tensor, n: int) -> RaftTensors:
    """One activation batch from its packed buffer (on the state's device),
    in place: csrc/activate.cu on the card (raising when it does not build
    or launch), activate_packed_reference on the CPU."""
    ACTIVATIONS[n] = ACTIVATIONS.get(n, 0) + 1
    if s.term.device.type != "cuda":
        return activate_packed_reference(s, packed, n)
    return activate_cuda(s, packed, n)


# ---- the engine's small device writes, each in place on whole planes or
# one lane's rows (rare-path host->device bridges; module-level so tests
# can hold each against the expression it replaces)


def advance_compaction(s: RaftTensors, mask, first, term) -> None:
    """Window compaction: first_index/marker_term take the new values on
    the lanes in ``mask`` (bool[G]; ``first``/``term`` i32[G])."""
    s.first_index.copy_(torch.where(mask, first, s.first_index))
    s.marker_term.copy_(torch.where(mask, term, s.marker_term))


#: rebase_lanes calls: every call ("calls") and those that also shifted a
#: residual inbox ("with_resid")
REBASES: Dict[str, int] = {"calls": 0, "with_resid": 0}


def rebase_lanes(s: RaftTensors, delta: torch.Tensor,
                 resid: Optional[Inbox] = None) -> RaftTensors:
    """The window rebase of one shard: the state's index planes shifted by
    each lane's delta (i32[G] on the state's device) and, when ``resid``
    is given, the residual inbox's parked messages (rebase_resid). On the
    card csrc/rebase.cu does both in place in one launch (raising when it
    does not build or launch); on the CPU ops/state.rebase (a new tree) and
    rebase_resid. Returns the state to keep."""
    REBASES["calls"] += 1
    if resid is not None:
        REBASES["with_resid"] += 1
    if s.term.device.type == "cuda":
        return rebase_cuda(s, delta, resid)
    s = rebase(s, delta)
    if resid is not None:
        rebase_resid(resid, delta)
    return s


def rebase_resid(r: Inbox, delta) -> None:
    """Shift the index-valued fields of the residual inbox's parked
    messages by their destination lane's rebase delta (i32[G]),
    type-aware: which fields hold indexes depends on the message type."""
    d = delta[:, None]
    mt = r.mtype
    idx_t = (
        (mt == MSG.REPLICATE)
        | (mt == MSG.REPLICATE_RESP)
        | (mt == MSG.READ_INDEX_RESP)
        | (mt == MSG.REQUEST_VOTE)
    )
    commit_t = (mt == MSG.REPLICATE) | (mt == MSG.HEARTBEAT)
    hint_t = mt == MSG.REPLICATE_RESP
    r.log_index.copy_(torch.where(idx_t, r.log_index - d, r.log_index))
    r.commit.copy_(
        torch.where(commit_t, torch.clamp(r.commit - d, min=0), r.commit)
    )
    r.hint.copy_(torch.where(hint_t, torch.clamp(r.hint - d, min=0), r.hint))


def clear_pending_cc(s: RaftTensors, mask) -> None:
    """Clear pending_cc on the lanes in ``mask`` (bool[G])."""
    s.pending_cc.logical_and_(~mask)


def write_lane_rows(tree, g: int, rows: Dict[str, object]) -> None:
    """Overwrite lane g's row of each named plane of ``tree`` (a state
    or an inbox) with a scalar or a row tensor: ``t[g] = x``."""
    for name, x in rows.items():
        getattr(tree, name)[g] = x


# One sharded super-step in flight per process (the reference's
# _MESH_LAUNCH_MU): a K>1 sharded super-step exchanges records between the
# shards' streams through events, and two engines of one process that
# interleave their launches on shared cards would only slow each other.
# K=1 sharded and every unsharded path have no exchange and never take it.
_MESH_LAUNCH_MU = threading.Lock()


def mesh_devices(device: torch.device) -> Tuple[torch.device, ...]:
    """The devices `EngineConfig.shard_over_mesh` spreads an engine's lanes
    over: every visible card when the engine runs on a card and more than
    one is visible; otherwise none, and the engine stays unsharded, as the
    JAX package does on one device. Tests and chip_smoke.py replace this
    function to name logical shards ((cpu,) * 8 on the CPU, (cuda:0,) * 4
    on one card), as the reference's tests pin eight virtual devices."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return ()
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


class _Shard:
    """One lane block of the engine: global lanes [lo, hi) as rows
    0..hi-lo of its own state tree, residual inbox and device planes, on
    its own device and (on a card) its own stream. An unsharded engine is
    one shard of every lane, on the engine's device and stream, which the
    loop thread keeps current (`loop_stream`)."""

    def __init__(self, device: torch.device, lo: int, hi: int,
                 stream: Optional["torch.cuda.Stream"], loop_stream: bool) -> None:
        self.device, self.lo, self.hi, self.stream = device, lo, hi, stream
        self._switch = stream is not None and not loop_stream

    def on(self):
        """Context that makes the shard's stream (and card) current on the
        engine's loop thread: a no-op on the CPU and for the shard on the
        loop thread's own stream, so the unsharded engine's steps switch
        no stream."""
        if not self._switch:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def alloc(self):
        """Context that makes the shard's stream current on any thread,
        for allocating its tensors on it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def _superstep_fn(cfg: KernelConfig, steps: int, devices: Tuple[torch.device, ...]):
    """The engine's super-step over its shards' devices: fn(states,
    inboxes, ticks, resids, routes, rdeltas, streams=None, into=None), each
    a sequence of one per shard, -> (states, outs, plans, resids,
    resid_counts), each a tuple of one per shard. Over several shards the
    sharded super-step with its candidate exchange; over one the unsharded
    super-step, which has no exchange."""
    if len(devices) > 1:
        return make_sharded_multi_step_fn(cfg, steps, devices)
    fn = make_multi_step_fn(cfg, steps)

    def one(states, inboxes, ticks, resids, routes, rdeltas, streams=None, into=None):
        ctx = contextlib.nullcontext() if streams is None else torch.cuda.stream(streams[0])
        with ctx:
            res = fn(states[0], inboxes[0], ticks[0], resids[0], routes[0], rdeltas[0],
                     into=None if into is None else into[0])
        return tuple((x,) for x in res)

    return one


def _engine_device(name) -> torch.device:
    """resolve_device with a card's index made explicit (the current device
    when the name carries none), so that two names of one card compare
    equal and the loop thread can make the device current."""
    dev = resolve_device(name)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return dev


class _Planes:
    """Named planes laid out in ONE byte buffer (each plane 16-byte
    aligned), so one copy moves them all. ``t`` maps a name to its tensor
    view; on the host ``np`` maps it to a numpy view of the same bytes
    (pinned when ``pin``, so copies to and from the card run
    asynchronously). The views alias the buffer: whatever must outlive
    the buffer's next reuse is copied out."""

    _NP = {
        torch.int32: np.int32, torch.bool: np.bool_,
        torch.uint32: np.uint32,
    }

    def __init__(self, layout, device, pin: bool = False) -> None:
        spans, size = packed_spans(layout)
        self.bytes = torch.zeros(
            size, dtype=torch.uint8, device=device, pin_memory=pin
        )
        self.t = {
            name: self.bytes[o : o + n].view(dt).view(shape)
            for name, shape, dt, o, n in spans
        }
        self.np = {}
        if self.bytes.device.type == "cpu":
            raw = self.bytes.numpy()
            self.np = {
                name: raw[o : o + n].view(self._NP[dt]).reshape(shape)
                for name, shape, dt, o, n in spans
            }


def activation_bucket(n: int, lanes: int) -> int:
    """The rows an activation batch of n lanes is padded to: the next power
    of 4, at most the shard's lanes (a few batch shapes, as the JAX
    package's buckets bound its compile cache)."""
    bucket = 1
    while bucket < n:
        bucket *= 4
    return min(bucket, lanes)


def pack_activation(rows: List[int], vals: List[dict], bucket: int, P: int,
                    W: int) -> torch.Tensor:
    """One activation batch in ONE host byte buffer, laid out by
    ops/cuda.py:activation_layout: the lane rows and each lane's values
    (dicts of ACT_COLUMNS and ACT_ROWS), padded to ``bucket`` rows by
    repeating the last lane (duplicate scatter indexes with equal values
    are order-free). Filled through numpy views of its bytes, so packing
    reads no tensor on the host."""
    spans, size = packed_spans(activation_layout(bucket, P, W))
    raw = np.zeros(size, np.uint8)
    v = {name: raw[o:o + nb].view(_Planes._NP[dt]).reshape(shape)
         for name, shape, dt, o, nb in spans}
    n = len(vals)
    v["rows"][:n] = rows
    for key, _dt in ACT_COLUMNS:
        v[key][:n] = [x[key] for x in vals]
    for key, _dt in ACT_ROWS:
        v[key][:n] = np.stack([x[key] for x in vals])
    if bucket > n:
        for a in v.values():
            a[n:] = a[n - 1]
    return torch.from_numpy(raw)


class _SharedClock(LogicalClock):
    """One logical clock shared by every lane of a VectorEngine. The engine
    loop gates the pending-queue gc pass with ONE should_gc() check per
    window (see _run_gc) — Pending*.gc() itself sweeps unconditionally."""


class VectorNode(Node):
    """A Node whose protocol core is a lane of the shared device state.

    The public request surface (propose/read/config-change/snapshot/
    transfer), the RSM manager, the snapshotter drivers and the pending
    notification machinery are all inherited; only the protocol stepping is
    different — there is no Peer, the VectorEngine advances every lane in
    one kernel call. Protocol status (leader/term/role/commit) is read from
    the engine's numpy mirror arrays, refreshed once per kernel step."""

    def _make_clock(self, engine):
        # all lanes share the engine's logical clock so request deadlines
        # are comparable across lanes and gc is one pass, not G passes
        return engine.clock

    def _launch_core(self, cfg, log_reader, peer_addresses, initial, new_node, rng):
        self._vec_initial = initial
        self._vec_new_node = new_node
        self._vec_addresses = list(peer_addresses)
        self._vec_lane = None  # bound by VectorEngine.add_node
        self._vec_wake_counted = False  # see notify_admission
        # snapshot record awaiting persistence on the snapshot worker
        # (handed off by _handle_install_snapshot; at most one in flight —
        # lane.recovering gates re-entry)
        self._vec_install_record = None
        return None  # no scalar Peer

    @property
    def _rate_limited(self) -> bool:
        """Per-lane Config.max_in_mem_log_size enforcement: the arena is
        this replica's in-memory log tier, and its tracked byte size gates
        new proposals (the scalar core additionally aggregates follower
        reports via RATE_LIMIT messages, cf. rate.go; lanes enforce the
        bound locally — device lanes carry no payload bytes to report)."""
        mx = self.config.max_in_mem_log_size
        if not mx:
            return False
        lane = self._vec_lane
        return lane is not None and lane.arena.unapplied_bytes > mx

    @_rate_limited.setter
    def _rate_limited(self, value) -> None:
        # derived live from the lane arena; the base class's cached-flag
        # writes (Node.__init__ / step_node) are meaningless here
        pass

    def fail_requests(self) -> None:
        """The engine stopped on a fault (VectorEngine._halt): complete
        every request in flight as terminated and refuse new ones (a
        batch submitted now completes as dropped). The node stays
        registered until NodeHost closes it."""
        self.incoming_proposals.close()
        self.incoming_reads.close()
        for p in (self.pending_proposals, self.pending_read_indexes,
                  self.pending_config_change, self.pending_snapshot):
            p.close()
        with self._batch_mu:
            handles = list(self._batches.values())
            self._batches.clear()
        for h in handles:
            h.expire()

    # ------------------------------------------------------------ status
    def get_leader_id(self) -> int:
        lane = self._vec_lane
        if lane is None or not lane.active:
            return 0
        eng = self.engine
        return lane.rev.get(int(eng._m_leader[lane.g]) - 1, 0)

    def local_status(self):
        lane = self._vec_lane
        if lane is None:
            return {
                "leader_id": 0,
                "term": 0,
                "state": ROLE.FOLLOWER,
                "commit": 0,
                "cluster_id": self.cluster_id,
                "node_id": self._node_id,
                "applied": self.sm.last_applied_index(),
            }
        eng = self.engine
        g = lane.g
        return {
            "leader_id": lane.rev.get(int(eng._m_leader[g]) - 1, 0),
            "term": int(eng._m_term[g]),
            "state": int(eng._m_role[g]),
            "commit": int(eng._m_base[g] + eng._m_commit[g]),
            "cluster_id": self.cluster_id,
            "node_id": self._node_id,
            "applied": self.sm.last_applied_index(),
        }

    def notify_admission(self) -> bool:
        """Serving-front first-admit wake (see Node.notify_admission).
        Vector quiesce lives in the kernel plane; the decode-maintained
        _m_quiesced mirror says whether this lane was quiesced as of its
        last step (zero device syncs). The admitted op's arrival stages
        the wake NOOP itself (_pack wakes quiesced lanes with fresh host
        work); marking the lane ready here just lets the loop turn
        immediately instead of waiting out the pump interval."""
        lane = self._vec_lane
        if lane is None or not lane.active:
            return False
        if not bool(self.engine._m_quiesced[lane.g]):
            self._vec_wake_counted = False
            return False
        # the mirror stays stale until the next decode clears it: a burst
        # of admits against one quiesced lane is ONE quiesced->active
        # transition, so only the first admit reports (and counts) a wake
        # — matching the scalar QuiesceManager.wake_on_admit semantics.
        # Later admits still nudge the loop (cheap, idempotent).
        self.engine.set_node_ready(self.cluster_id)
        if self._vec_wake_counted:
            return False
        self._vec_wake_counted = True
        return True

    def _leader_event(self, leader_id: int, term: int) -> None:
        """Engine loop: the lane's (leader, term) changed this step."""
        if self.events is not None:
            self.events.leader_updated(
                self.cluster_id, self._node_id, leader_id, term
            )

    # ------------------------------------------------- INodeProxy overrides
    def apply_config_change(self, cc) -> None:
        """A config change committed and passed the membership legality
        checks: reconcile the device lane (slot remap) on the engine loop.
        The new member's address registers host-wide first (base-class
        seam): the replicated entry is every replica's routing source."""
        self._register_cc_address(cc)
        self.engine.membership_changed(self)

    def config_change_processed(self, key: int, accepted: bool) -> None:
        self.pending_config_change.apply(key, rejected=not accepted)
        # the device's single-pending-config-change latch opens once the
        # change is applied or rejected (cf. raft.go:1242-1295; the scalar
        # core clears it through apply_config_change/reject_config_change)
        self.engine.cc_processed(self)

    # --------------------------------------------------- snapshot overrides
    def _recover_initial_snapshot_locked(self) -> None:
        from ..rsm import Task

        t = Task(
            cluster_id=self.cluster_id,
            node_id=self._node_id,
            snapshot_available=True,
        )
        self.sm.recover_from_snapshot(t)

    def _do_recover_snapshot(self, task) -> None:
        """InstallSnapshot arrived and the SM recovered from it on a
        snapshot worker; reconcile the device lane and ack the leader
        (cf. node.go:950-965 + raft.go handleInstallSnapshotMessage)."""
        try:
            # persist the snapshot record FIRST (restart safety: the
            # recovery below reads the image through this record) — on
            # THIS worker thread, not the engine loop: the record write is
            # an fsync, and a monolithic install must not stall the whole
            # fleet's super-step cadence (see _handle_install_snapshot)
            ss_rec = self._vec_install_record
            self._vec_install_record = None
            if ss_rec is not None:
                self.logdb.save_raft_state(
                    [
                        Update(
                            cluster_id=self.cluster_id,
                            node_id=self._node_id,
                            snapshot=ss_rec,
                        )
                    ]
                )
            idx = self.sm.recover_from_snapshot(task)
            if idx > 0:
                self.clear_install_aborted()
                ss = self.snapshotter.get_most_recent_snapshot()
                if ss is not None and not ss.is_empty():
                    # the log window moves to the snapshot on the engine
                    # loop, with the device lane (_reconcile_restore): the
                    # loop is the only writer of this lane's window
                    self.engine.snapshot_restored(self, ss)
                    return
            self.engine.recover_done(self)
        finally:
            self.ss.clear_recovering_from_snapshot()

    def _notify_snapshot_status(self) -> None:
        # the engine loop owns this lane's protocol state (incl. the log
        # reader the finalization mutates): route completions there
        self.engine.snapshot_status_ready(self)


class _Arena:
    """Entry arena over the device window: a RING of W slots indexed by
    real index % W, so placement/lookup are list indexing (a dict per
    index was a measured hot spot across place/send/save/apply) and
    compaction is free — overwriting a slot IS the eviction, exactly when
    the device window has moved past it.

    Byte counters back per-lane Config.max_in_mem_log_size enforcement
    (cf. internal/server/rate.go + inmemory.go size accounting; the arena
    is the vector engine's in-memory log tier): mem_bytes is everything
    resident; unapplied_bytes covers only entries above the applied
    watermark — the real backpressure signal, because applied entries stay
    resident merely as the window's payload cache (the scalar inmem drops
    them instead, inmemory.go appliedLogTo).

    A step can accept a run wider than the ring (a follower's inbox holding
    several catch-up Replicates: entry i and i+W share a slot). The ring
    evicts an entry only once it is saved: an entry above the `saved`
    watermark that a placement displaces waits in `spill` until the save
    wave has written it (mark_saved), so a save never lacks a payload. A
    placement at or below the watermark (a new leader overwriting a saved
    suffix) lowers it, so every entry from there on is unsaved again."""

    __slots__ = (
        "w", "buf", "mem_bytes", "unapplied_bytes", "payload_bytes", "applied",
        "saved", "spill",
    )

    def __init__(self, window: int) -> None:
        self.w = window
        self.buf: List[Optional[Entry]] = [None] * window
        self.mem_bytes = 0
        self.unapplied_bytes = 0
        # resident CLIENT-payload bytes only (no per-entry overhead, and
        # config-change entries excluded — their encoded membership cmd
        # is protocol metadata that legitimately reaches witnesses
        # intact, cf. raft.go:742-756): the witness-lane probe — a
        # witness replica must hold ZERO of these, asserted by
        # lane_stats/tests and the observer_witness_churn verdict
        self.payload_bytes = 0
        self.applied = 0
        self.saved = 0
        self.spill: Dict[int, Entry] = {}

    def __setitem__(self, key: int, entry: Entry) -> None:
        slot = key % self.w
        old = self.buf[slot]
        sz = ENTRY_OVERHEAD_BYTES + len(entry.cmd)
        if key <= self.saved:
            self.saved = key - 1
        if self.spill:
            self.spill.pop(key, None)
        if old is not None:
            if old.index > self.saved and old.index != key:
                self.spill[old.index] = old
            osz = ENTRY_OVERHEAD_BYTES + len(old.cmd)
            self.mem_bytes -= osz
            if old.type != EntryType.CONFIG_CHANGE:
                self.payload_bytes -= len(old.cmd)
            if old.index > self.applied:
                self.unapplied_bytes -= osz
        self.mem_bytes += sz
        if entry.type != EntryType.CONFIG_CHANGE:
            self.payload_bytes += len(entry.cmd)
        if key > self.applied:
            self.unapplied_bytes += sz
        self.buf[slot] = entry

    def get(self, key: int) -> Optional[Entry]:
        e = self.buf[key % self.w]
        if e is not None and e.index == key:
            return e
        return self.spill.get(key) if self.spill else None

    def __getitem__(self, key: int) -> Entry:
        e = self.get(key)
        if e is None:
            raise KeyError(key)
        return e

    def get_run(self, lo: int, hi: int):
        """Entries [lo, hi] inclusive, or (None, missing_index) on a hole."""
        w, buf, spill = self.w, self.buf, self.spill
        out = []
        for i in range(lo, hi + 1):
            e = buf[i % w]
            if e is None or e.index != i:
                e = spill.get(i) if spill else None
                if e is None:
                    return None, i
            out.append(e)
        return out, -1

    def mark_saved(self, index: int) -> None:
        """The lane's save wave has written its entries through `index`:
        the spill (entries placed since the last wave that the ring
        evicted, or stale ones of a truncated suffix) is no longer needed."""
        self.saved = index
        if self.spill:
            self.spill = {}

    def mark_applied(self, index: int) -> None:
        """Advance the applied watermark; entries in (applied, index] no
        longer count toward unapplied_bytes."""
        w, buf = self.w, self.buf
        dec = 0
        for i in range(self.applied + 1, index + 1):
            e = buf[i % w]
            if e is not None and e.index == i:
                dec += ENTRY_OVERHEAD_BYTES + len(e.cmd)
        self.unapplied_bytes -= dec
        if index > self.applied:
            self.applied = index


class _Lane:
    """Per-group host bookkeeping owned by the engine loop thread. Protocol
    mirrors (term/role/leader/commit/last/first/base) live in the engine's
    whole-G numpy arrays, not here."""

    __slots__ = (
        "g",
        "key",
        "node",
        "cfg",
        "slots",
        "rev",
        "arena",
        "staged_props",
        "staged_reads",
        "staged_ccs",
        "msg_backlog",
        "pack_info",
        "packed_pending",
        "ri_pending",
        "recovering",
        "adopted_term",
        "catchup",
        "snap_inflight",
        "active",
        "cc_inflight",
        "mem_sig",
        "wit_slots",
    )

    def __init__(self, g: int, node: VectorNode, key=None) -> None:
        self.g = g
        self.key = key if key is not None else node.cluster_id
        self.node = node
        self.cfg: Config = node.config
        self.slots: Dict[int, int] = {}  # node_id -> slot
        self.rev: Dict[int, int] = {}  # slot -> node_id
        # ring over the device window; real index -> Entry, size-tracked
        self.arena: _Arena = _Arena(node.engine.kcfg.log_window)
        self.staged_props: deque = deque()  # Entry
        self.staged_reads: deque = deque()  # RequestState
        self.staged_ccs: deque = deque()  # (Entry, key)
        self.msg_backlog: deque = deque()  # wire Messages awaiting a slot
        self.pack_info: Dict[int, tuple] = {}
        self.packed_pending = 0  # entries packed into not-yet-decoded steps
        self.ri_pending: Dict[Tuple[int, int], SystemCtx] = {}  # (lo,hi)->ctx
        self.recovering = False
        # term adopted from an InstallSnapshot sender; the restore ack must
        # carry it or the leader drops the ack as stale. Kept on the lane
        # because the engine's _m_term mirror is rebound from device state
        # every step (the device never saw the snapshot message).
        self.adopted_term = 0
        # slot -> [next_to_send, goal, match_at_progress, progress_tick]
        self.catchup: Dict[int, list] = {}
        # snapshot-status feedback (cf. feedback.go:38-128): slot ->
        # (sent_tick, snapshot_index); a peer that does not ack the
        # snapshot within the retry window gets a synthetic
        # SNAPSHOT_STATUS reject so the kernel un-parks it and the
        # leader retries — a lost InstallSnapshot must not wedge the
        # remote in SNAPSHOT state forever
        self.snap_inflight: Dict[int, Tuple[int, int]] = {}
        self.active = False
        self.cc_inflight = False
        # (members, observers, witnesses) snapshot of the last membership
        # image reconciled onto the device — config changes that restate
        # the same image (e.g. bootstrap CCs) skip the device remap
        self.mem_sig: Optional[tuple] = None
        # peer slots holding WITNESS members: replication toward these is
        # payload-stripped (metadata entries / witness-shaped snapshots,
        # cf. raft.go:742-756) at every host sender site. Maintained by
        # the same three reconcile paths that maintain mem_sig.
        self.wit_slots: frozenset = frozenset()

    # ------------------------------------------------------- slot mapping
    def set_slots(self, member_ids) -> Dict[int, int]:
        """Canonical mapping: rank in sorted member-id order. Returns the
        old->new slot permutation for device remap."""
        new = {nid: i for i, nid in enumerate(sorted(member_ids))}
        perm = {}
        for nid, old_slot in self.slots.items():
            if nid in new:
                perm[old_slot] = new[nid]
        self.slots = new
        self.rev = {s: nid for nid, s in new.items()}
        return perm

    def slot_of(self, node_id: int, provisional: bool = False) -> int:
        s = self.slots.get(node_id)
        if s is not None:
            return s
        if not provisional:
            return -1
        # a sender we have not learned through membership yet (join path):
        # park it on a free slot; the canonical remap fixes it at apply time
        P = self.node.engine.kcfg.peers
        used = set(self.slots.values())
        for s in range(P):
            if s not in used:
                self.slots[node_id] = s
                self.rev[s] = node_id
                return s
        return -1

    def self_slot(self) -> int:
        return self.slots.get(self.node.node_id(), -1)

    def has_staged(self) -> bool:
        return bool(
            self.msg_backlog
            or self.staged_props
            or self.staged_reads
            or self.staged_ccs
        )


# wire type for each device response-plane type (phase-3 fan-out)
_RESP_WIRE = {
    int(MSG.REPLICATE_RESP): MT.REPLICATE_RESP,
    int(MSG.REQUEST_VOTE_RESP): MT.REQUEST_VOTE_RESP,
    int(MSG.REQUEST_PREVOTE_RESP): MT.REQUEST_PREVOTE_RESP,
    int(MSG.HEARTBEAT_RESP): MT.HEARTBEAT_RESP,
    int(MSG.NOOP): MT.NOOP,
}


# ---------------------------------------------------------------------------
# Columnar fan-out: StepOutput planes -> wire Messages.
#
# Each builder derives its work list from ONE np.nonzero over the relevant
# mask, gathers every field it needs as whole columns (`arr[gs, ps]`), and
# only then iterates plain python values — Message objects materialize at
# the transport boundary and nowhere earlier. These are module-level pure
# readers (they mutate no engine state) so the differential test can drive
# them directly against a per-element reference (tests/test_fanout_columnar).
# ---------------------------------------------------------------------------


def _send_target(lane_by_g, g: int, p: int):
    """The fan-out builders' shared skip rules: (lane, to_nid), or None
    when the lane is unoccupied or the peer slot has no known node id.
    One place to extend when a new skip rule applies to every send kind."""
    lane = lane_by_g[g]
    if lane is None:
        return None
    to_nid = lane.rev.get(p)
    if to_nid is None:
        return None
    return lane, to_nid


def gather_replicate_sends(
    o: dict, base, lane_by_g, fetch_from_log=None
) -> List[Tuple[_Lane, Message]]:
    """Phase-1 Replicate materialization (these leave BEFORE the fsync)."""
    sends: List[Tuple[_Lane, Message]] = []
    gs, ps = np.nonzero(o["send_flags"] & SEND_REPLICATE)
    if not gs.size:
        return sends
    cols = zip(
        gs.tolist(),
        ps.tolist(),
        base[gs].tolist(),
        o["term"][gs].tolist(),
        o["send_prev_index"][gs, ps].tolist(),
        o["send_prev_term"][gs, ps].tolist(),
        o["send_n_entries"][gs, ps].tolist(),
        o["send_commit"][gs, ps].tolist(),
    )
    for g, p, b, term, prev, prev_term, n, commit in cols:
        tgt = _send_target(lane_by_g, g, p)
        if tgt is None:
            continue
        lane, to_nid = tgt
        ents, _missing = lane.arena.get_run(b + prev + 1, b + prev + n)
        if ents is None:
            ents = (
                fetch_from_log(lane, b + prev + 1, b + prev + n)
                if fetch_from_log is not None
                else None
            )
            if ents is None:
                _plog.errorf(
                    "%s missing entries for replicate [%d..%d]",
                    lane.node.describe(), b + prev + 1, b + prev + n,
                )
                continue
        if p in lane.wit_slots:
            # witness peers replicate metadata only — payload bytes never
            # leave this host toward a witness
            ents = _make_metadata_entries(ents)
        # causal trace: a sampled entry's trace id rides the Message (and
        # the Entry codec) so the follower stamps the same key. Scanning
        # is bounded by max_entries_per_msg; only the 1-in-N sampled case
        # records anything.
        trace_id = 0
        for e in ents:
            if e.trace_id:
                trace_id = e.trace_id
        if trace_id:
            flight_recorder().record(
                "replicate_send", cluster=lane.node.cluster_id,
                node=lane.node.node_id(), to=to_nid, trace=trace_id,
            )
        sends.append(
            (
                lane,
                Message(
                    type=MT.REPLICATE,
                    cluster_id=lane.node.cluster_id,
                    to=to_nid,
                    from_=lane.node.node_id(),
                    term=term,
                    log_index=b + prev,
                    log_term=prev_term,
                    commit=b + commit,
                    trace_id=trace_id,
                    entries=ents,
                ),
            )
        )
    return sends


def gather_post_sends(o: dict, base, lane_by_g) -> List[Tuple[_Lane, Message]]:
    """Phase-3 broadcast-plane sends (vote requests, heartbeats,
    TimeoutNow), in the same per-kind order the scalar fan-out used."""
    sends: List[Tuple[_Lane, Message]] = []
    send_flags = o["send_flags"]
    term_plane = o["term"]
    role_plane = o["role"]
    gs, ps = np.nonzero(send_flags & SEND_VOTE_REQ)
    if gs.size:
        for g, p, b, term, role, vli, vlt, hint in zip(
            gs.tolist(),
            ps.tolist(),
            base[gs].tolist(),
            term_plane[gs].tolist(),
            role_plane[gs].tolist(),
            o["vote_last_index"][gs].tolist(),
            o["vote_last_term"][gs].tolist(),
            o["send_hint"][gs, ps].tolist(),
        ):
            tgt = _send_target(lane_by_g, g, p)
            if tgt is None:
                continue
            lane, to_nid = tgt
            # the shared vote plane serves both election phases: a
            # PRE_CANDIDATE lane polls with REQUEST_PREVOTE at the
            # PROSPECTIVE term (its own term stays untouched)
            pre = role == ROLE.PRE_CANDIDATE
            sends.append(
                (
                    lane,
                    Message(
                        type=MT.REQUEST_PREVOTE if pre else MT.REQUEST_VOTE,
                        cluster_id=lane.node.cluster_id,
                        to=to_nid,
                        from_=lane.node.node_id(),
                        term=term + 1 if pre else term,
                        log_index=b + vli,
                        log_term=vlt,
                        hint=hint,
                    ),
                )
            )
    gs, ps = np.nonzero(send_flags & SEND_HEARTBEAT)
    if gs.size:
        for g, p, b, term, hb_commit, hint, hint2, lease_round in zip(
            gs.tolist(),
            ps.tolist(),
            base[gs].tolist(),
            term_plane[gs].tolist(),
            o["send_hb_commit"][gs, ps].tolist(),
            o["send_hint"][gs, ps].tolist(),
            o["send_hint2"][gs, ps].tolist(),
            o["lease_round"][gs].tolist(),
        ):
            tgt = _send_target(lane_by_g, g, p)
            if tgt is None:
                continue
            lane, to_nid = tgt
            sends.append(
                (
                    lane,
                    Message(
                        type=MT.HEARTBEAT,
                        cluster_id=lane.node.cluster_id,
                        to=to_nid,
                        from_=lane.node.node_id(),
                        term=term,
                        # lease round tag: an opaque tick stamp the follower
                        # echoes back, NOT an index — no +b translation
                        log_index=lease_round,
                        commit=b + hb_commit,
                        hint=hint,
                        hint_high=hint2,
                    ),
                )
            )
    gs, ps = np.nonzero(send_flags & SEND_TIMEOUT_NOW)
    if gs.size:
        for g, p, term in zip(
            gs.tolist(), ps.tolist(), term_plane[gs].tolist()
        ):
            tgt = _send_target(lane_by_g, g, p)
            if tgt is None:
                continue
            lane, to_nid = tgt
            sends.append(
                (
                    lane,
                    Message(
                        type=MT.TIMEOUT_NOW,
                        cluster_id=lane.node.cluster_id,
                        to=to_nid,
                        from_=lane.node.node_id(),
                        term=term,
                    ),
                )
            )
    return sends


def gather_resp_sends(o: dict, base, lane_by_g) -> List[Tuple[_Lane, Message]]:
    """Phase-3 response-plane sends: one reply per consumed inbox slot."""
    sends: List[Tuple[_Lane, Message]] = []
    resp_type = o["resp_type"]
    gs, ks = np.nonzero(resp_type != MSG.NONE)
    if not gs.size:
        return sends
    cols = zip(
        gs.tolist(),
        base[gs].tolist(),
        resp_type[gs, ks].tolist(),
        o["resp_to"][gs, ks].tolist(),
        o["resp_term"][gs, ks].tolist(),
        o["resp_log_index"][gs, ks].tolist(),
        o["resp_reject"][gs, ks].tolist(),
        o["resp_hint"][gs, ks].tolist(),
        o["resp_hint2"][gs, ks].tolist(),
    )
    for g, b, t, to_slot, term, log_index, reject, hint, hint2 in cols:
        tgt = _send_target(lane_by_g, g, to_slot)
        if tgt is None:
            continue
        lane, to_nid = tgt
        if to_nid == lane.node.node_id():
            continue  # self-addressed (e.g. local election artifacts)
        wire = _RESP_WIRE.get(t)
        if wire is None:
            continue
        trace_id = 0
        if wire == MT.REPLICATE_RESP:
            log_index += b
            hint += b
            # ack hop of the causal chain: if the ACCEPTED index is a
            # sampled entry this follower placed, carry its trace id back
            # (one arena ring probe; records only on the 1-in-N case).
            # Best-effort by design: a sampled entry that is not the last
            # of its acked run goes unprobed, and rejected acks never
            # probe — a reject's hint index can land on a stale
            # conflicting arena entry and would misattribute an unrelated
            # proposal's chain.
            if not reject:
                te = lane.arena.get(log_index)
                if te is not None:
                    trace_id = te.trace_id
            if trace_id:
                flight_recorder().record(
                    "replicate_ack", cluster=lane.node.cluster_id,
                    node=lane.node.node_id(), to=to_nid, trace=trace_id,
                    index=log_index,
                )
        sends.append(
            (
                lane,
                Message(
                    type=wire,
                    cluster_id=lane.node.cluster_id,
                    to=to_nid,
                    from_=lane.node.node_id(),
                    term=term,
                    log_index=log_index,
                    reject=bool(reject),
                    hint=hint,
                    hint_high=hint2,
                    trace_id=trace_id,
                ),
            )
        )
    return sends


class SaveHoleError(RuntimeError):
    """A step says to save a run whose payload the lane's arena does not
    hold. Saving less and acking would break durability, so the engine
    stops (VectorEngine.fault) instead of carrying on."""

    def __init__(self, lane, lo: int, hi: int, missing_at: int) -> None:
        super().__init__(
            f"{lane.node.describe()} missing arena entry {missing_at} for "
            f"save of [{lo}, {hi}]"
        )
        self.lane, self.lo, self.hi, self.missing_at = lane, lo, hi, missing_at


def build_save_updates(o: dict, base, lane_by_g):
    """Phase-2 hard-state/entry persistence as (updates, lane_saves): the
    whole step's saves gathered columnar, written downstream as ONE
    multi-group write wave. Each run comes from its lane's arena, where
    it waits from its placement to its save wave; a run the arena lacks
    raises SaveHoleError."""
    updates: List[Update] = []
    lane_saves: List[Tuple[_Lane, List[Entry], State]] = []
    gs = np.nonzero((o["save_from"] > 0) | o["hard_changed"])[0]
    if not gs.size:
        return updates, lane_saves
    cols = zip(
        gs.tolist(),
        base[gs].tolist(),
        o["save_from"][gs].tolist(),
        o["save_to"][gs].tolist(),
        o["vote"][gs].tolist(),
        o["term"][gs].tolist(),
        o["commit_index"][gs].tolist(),
        o["hard_changed"][gs].tolist(),
    )
    for g, b, sf, st_, vote_slot, term, commit, hard_changed in cols:
        lane = lane_by_g[g]
        if lane is None or not lane.active:
            continue
        ents: List[Entry] = []
        if sf > 0:
            ents, missing_at = lane.arena.get_run(b + sf, b + st_)
            if ents is None:
                raise SaveHoleError(lane, b + sf, b + st_, missing_at)
        state = State(
            term=term,
            vote=lane.rev.get(vote_slot - 1, 0) if vote_slot > 0 else 0,
            commit=b + commit,
        )
        if ents or hard_changed:
            updates.append(
                Update(
                    cluster_id=lane.node.cluster_id,
                    node_id=lane.node.node_id(),
                    state=state,
                    entries_to_save=ents,
                )
            )
            lane_saves.append((lane, ents, state))
    return updates, lane_saves


class VectorEngine:
    """Engine-compatible facade (add/remove/set_*_ready/stop) around the
    single-stepper loop that advances all lanes per kernel call."""

    def __init__(
        self,
        logdb,
        nh_config: Optional[NodeHostConfig] = None,
        num_task_workers: Optional[int] = None,
        num_snapshot_workers: int = 2,
    ) -> None:
        self._logdb = logdb
        ecfg = nh_config.engine if nh_config is not None else None
        self.kcfg = KernelConfig(
            groups=ecfg.max_groups if ecfg else 64,
            peers=ecfg.max_peers if ecfg else 8,
            log_window=ecfg.log_window if ecfg else 128,
            inbox_depth=ecfg.inbox_depth if ecfg else 8,
            max_entries_per_msg=(
                getattr(ecfg, "max_entries_per_msg", 8) if ecfg else 8
            ),
            readindex_depth=ecfg.readindex_depth if ecfg else 4,
        )
        if self.kcfg.max_entries_per_msg > self.kcfg.log_window:
            # the kernel's ring-slot scatter maps each written index to a
            # unique slot only while a message's span fits the window
            raise ValueError(
                f"max_entries_per_msg ({self.kcfg.max_entries_per_msg}) must "
                f"not exceed log_window ({self.kcfg.log_window})"
            )
        # the torch device every state plane lives on (EngineConfig.device):
        # the card unless the caller names the CPU; resolve_device raises
        # when the card is asked for and absent
        self.device = _engine_device(
            getattr(ecfg, "device", "cuda") if ecfg else "cuda"
        )
        self._cuda = self.device.type == "cuda"
        # the engine's own stream: every device op of the engine (state
        # allocation here, then the loop thread's copies, kernels and
        # small writes) is enqueued on it, so stream order alone orders
        # them; None on the CPU
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # the group axis in contiguous lane blocks, the shards (the
        # reference's NamedSharding(P("groups"))): global lane g lives on
        # shard g // Gl, row g % Gl. shard_over_mesh spreads them over
        # mesh_devices(), each shard on its own stream; with one device it
        # is a no-op, as it is for the JAX package, and the engine is one
        # shard on its own device and stream
        self._mesh_devices = 0  # 0 = unsharded single-device engine
        groups_requested = self.kcfg.groups
        devs = (
            mesh_devices(self.device)
            if ecfg is not None and getattr(ecfg, "shard_over_mesh", False)
            else ()
        )
        if len(devs) > 1:
            if any(d.type != self.device.type for d in devs):
                raise ValueError(
                    f"mesh devices {devs} do not match the engine's {self.device}"
                )
            n = len(devs)
            # round UP to a device multiple so every shard holds the same
            # block; stamped in step_stats (padded_groups, mesh_devices),
            # and the ghost lanes are never handed out by the allocator
            self.kcfg = self.kcfg._replace(groups=-(-self.kcfg.groups // n) * n)
            devs = tuple(_engine_device(d) for d in devs)
            streams = [torch.cuda.Stream(d) if self._cuda else None for d in devs]
            self._mesh_devices = n
        else:
            devs, streams = (self.device,), [self._stream]
        Gl = self.kcfg.groups // len(devs)
        self._shards = [
            _Shard(d, i * Gl, (i + 1) * Gl, st, st is self._stream)
            for i, (d, st) in enumerate(zip(devs, streams))
        ]
        # one sharded super-step in flight per process; one shard has no
        # exchange and never takes the lock
        self._launch_mu = (
            _MESH_LAUNCH_MU if len(devs) > 1 else contextlib.nullcontext()
        )
        self._groups_requested = groups_requested
        self._padded_groups = self.kcfg.groups - groups_requested
        self.clock = _SharedClock()
        # device-resident multi-step: K protocol steps per kernel launch
        # (EngineConfig.steps_per_sync). K=1 keeps the classic one-step
        # loop byte-identical; K>1 runs the super-step path.
        self._multi = (
            max(1, int(getattr(ecfg, "steps_per_sync", 1) or 1))
            if ecfg
            else 1
        )
        ov = getattr(ecfg, "overlap_decode", None) if ecfg else None
        if ov is None:
            ov = self._cuda  # auto: see EngineConfig
        if self._multi > 1:
            # the super-step IS the pipelining: dispatch/fetch amortize
            # over K steps, and the pack path needs the PREVIOUS fetch's
            # residual-inbox occupancy (overlap would make it two steps
            # stale and clobber device-routed residual rows)
            ov = False
        self._overlap = bool(ov)
        self._pending = None  # in-flight (work, packs, fetch slot)
        self._rebase_due = False
        # stage profiler for the hot loop (cf. reference execengine.go
        # :197-211 + trace.go:98-162). Sparse sampling by default (1/32):
        # per-step full sampling is pure hot-loop overhead in production;
        # benches and debugging opt into every-step recording through
        # EngineConfig.profile_sample_ratio=1.
        ratio = (getattr(ecfg, "profile_sample_ratio", 0) or 0) if ecfg else 0
        self.profiler = Profiler(sample_ratio=ratio if ratio > 0 else 32)
        # sampled stage durations also land in the process-global phase
        # plane (engine_phase_seconds{engine="vector",phase=...} + flight-
        # recorder spans); unsampled steps never reach it
        self.profiler.attach_phase_plane(phase_plane(), "vector")
        # request-lifecycle latency sampling shares the profiler's ratio
        # knob: 1-in-N proposals/reads carry a LatencyTrace into the
        # proposal_commit/apply and readindex latency histograms; the
        # other N-1 stay allocation-free (see trace.LatencySampler)
        self.request_sampler = LatencySampler(ratio if ratio > 0 else 32)
        # per-step counters accumulated inline by the decode phases on
        # objects they already materialize (no extra device syncs, no
        # extra numpy reductions); exported via step_stats() and folded
        # into NodeHost._export_health_gauges as engine_step_* gauges
        self._sstats = {
            "steps": 0,
            "msgs_replicate": 0,  # phase-1 Replicate messages out
            "msgs_broadcast": 0,  # phase-3 votes/heartbeats/TimeoutNow out
            "msgs_resp": 0,  # phase-3 response-plane messages out
            "lanes_commit_advanced": 0,  # lanes handing commits to the RSM
            "leader_changes": 0,  # (leader, term) transitions observed
            "elections_started": 0,  # lanes that went leaderless
            "entries_applied": 0,  # entries handed to the RSM
            # multi-step engine: co-hosted messages routed ON DEVICE
            # between inner steps (zero host Message objects each)
            "msgs_routed_device": 0,
            # sharded mesh: ghost lanes added by a device-multiple
            # round-up and the mesh width — static stamps, not counters
            "padded_groups": self._padded_groups,
            "mesh_devices": self._mesh_devices,
            # K=1 overlap: steps decoded while the next step was already
            # dispatched (the rest were drained by _flush_pending)
            "steps_pipelined": 0,
            # 1 once the loop stopped on a save it could not make (_halt)
            "faults": 0,
        }
        # the SaveHoleError that stopped the loop, or None (_halt)
        self.fault: Optional[BaseException] = None
        # ---- tick-fairness watchdog (ROADMAP seed flake) -----------------
        # Inter-iteration latency vs the host's tick period, a starvation
        # gauge, and an enforced yield when a long kernel step starved a
        # co-scheduled peer loop (see engine/fairness.py).
        tick_s = (
            (nh_config.rtt_millisecond or 50) / 1000.0
            if nh_config is not None
            else 0.05
        )
        yield_ms = getattr(ecfg, "fairness_yield_ms", None) if ecfg else None
        self.watchdog = FairnessWatchdog(
            "vec-step",
            tick_s,
            # 0 disables enforcement (measurement stays on); None = auto
            yield_threshold_s=(
                float("inf") if yield_ms == 0
                else (yield_ms / 1000.0 if yield_ms else None)
            ),
        )
        # per-step replay clamp for coalesced tick backlogs: replaying a
        # stall's whole backlog at election-RTT granularity expires every
        # follower's randomized timer in the same step (synchronized
        # split-vote storms after any multi-second stall — the seed
        # flake); 0 = auto: clamp at each lane's heartbeat RTT
        self._catchup_tick_cap = (
            getattr(ecfg, "max_catchup_ticks", 0) or 0 if ecfg else 0
        )
        self._last_tick_burst = 0
        # runtime build attribution: kernel builds (ops/cuda.build_kernels)
        # show up in engine_compile_events_total; a build in steady state
        # is a fault
        compile_watch().install()
        # ---- multi-step (K>1) state --------------------------------------
        # the device route table (lane index of the co-hosted replica
        # behind each peer slot, -1 = host path) + window-base deltas,
        # rebuilt on the loop thread whenever lane topology changes; the
        # device-resident residual inbox (the last inner step's routed
        # messages, consumed by the next super-step's inner step 0) and
        # its fetched per-lane occupancy; and the routed-Replicate
        # payload placements awaiting their acceptance report.
        G = self.kcfg.groups
        self._m_resid = np.zeros(G, np.int32)
        self._pending_rep_copies: list = []
        self._routes_dirty = True
        # every shard its own state tree (and, at K>1, residual inbox),
        # allocated on its own stream
        lcfg = self.kcfg._replace(groups=Gl)
        for sh in self._shards:
            with sh.alloc():
                sh.state = init_state(lcfg, device=sh.device)
                sh.resid = (
                    make_empty_inbox(lcfg, device=sh.device)
                    if self._multi > 1 else None
                )
        if self._multi > 1:
            self._multi_fn = _superstep_fn(
                self.kcfg, self._multi, tuple(sh.device for sh in self._shards)
            )
        # lanes keyed by (host, cluster_id): a SHARED core hosts replicas
        # from several NodeHosts (hosts = handle ids), so cluster_id alone
        # does not identify a lane
        self._lanes: Dict[tuple, _Lane] = {}
        # (cluster_id, node_id) -> lane, for in-core message short-circuit
        self._route: Dict[tuple, _Lane] = {}
        # ghost lanes from the sharded round-up are NOT capacity: the
        # allocator only hands out the lanes the caller configured, so
        # padded lanes never reach _lanes / lane_stats / gauges
        self._free = list(range(self._groups_requested - 1, -1, -1))
        self._lanes_mu = threading.RLock()
        self._reconq: deque = deque()  # host->device ops, loop-applied
        self._stopped = threading.Event()
        self._ready = threading.Event()
        # crash teardown flag (stop(flush=False)): the loop discards its
        # un-decoded in-flight step instead of landing it
        self._discard_pending = False
        # ---- host sharing (handles) --------------------------------------
        self._hosts_mu = threading.Lock()
        self._host_refs: Set[int] = set()
        self._next_host = 0
        self._blocked_hosts: Set[int] = set()  # partitioned NodeHosts
        # per-host clock-suspect deadlines (monotonic seconds): a host
        # whose tick worker reported a clock anomaly loses lease rights
        # (clock_ok=False) on all its lanes until the hold expires.
        # Written by tick workers under _dirty_mu, reconciled onto the
        # device clock_ok plane by the loop thread on transitions only.
        self._clock_suspect: Dict[int, float] = {}
        # cumulative lease read counters (loop-thread writes, lock-free
        # int reads via lease_stats)
        self._lease_local = 0
        self._lease_fb = 0
        # chaos hook over co-hosted delivery (the analogue of the
        # transport's pre-send hook for traffic that never touches the
        # wire): return True to drop the message
        self._local_drop_hook = None
        # ---- host-event staging (producers: API/transport threads) -------
        self._dirty_mu = threading.Lock()
        self._dirty: Set[tuple] = set()  # lane keys with host events
        self._gc_set: Set[tuple] = set()  # lane keys with pending requests
        self._pending_ticks: Dict[int, int] = {}  # host -> coalesced ticks
        # ---- serving-plane backpressure mirrors --------------------------
        # refreshed once per _pack from data the pack pass already touches
        # (zero device syncs); read lock-free by pressure_stats — a torn
        # read costs one stale sample, never a wrong decision stream
        self._p_inbox_rows = 0
        self._p_inbox_lanes = 0
        self._p_staged_backlog = 0
        # ---- loop-thread-only work sets ----------------------------------
        self._carry: Set[_Lane] = set()  # lanes with leftover staged work
        self._catchups: Set[_Lane] = set()  # lanes replaying host log
        self._snapfb: Set[_Lane] = set()  # lanes with in-flight snapshots
        # nodes with completed snapshot work awaiting finalization on this
        # loop (cf. node.go processSaveStatus; scalar nodes do this in
        # step_node)
        self._snap_status: Set[VectorNode] = set()
        self._snap_status_mu = threading.Lock()
        self._alloc_buffers()
        self._alloc_mirrors()
        # device memory census (profile.DeviceCensus): plane bytes are
        # STATIC tensor metadata (shapes never change over the engine's
        # life), reported once here from `.nbytes` — device_census() folds
        # the logical log fill from the decode-maintained mirrors, so
        # reading the census costs zero device syncs at any point
        self.census = DeviceCensus()
        trees = [("state", sh.state) for sh in self._shards]
        if self._multi > 1:
            trees += [("resid", sh.resid) for sh in self._shards]
        planes: Dict[str, int] = {}
        for kind, tree in trees:
            for name, arr in tree._asdict().items():
                key = f"{kind}.{name}"
                planes[key] = planes.get(key, 0) + int(arr.nbytes)
        staging = sum(
            int(host.bytes.nbytes) for _b, _t, _i, host in self._bufsets
        )
        self.census.set_planes(
            planes,
            log_planes=("state.log_term", "state.log_is_cc"),
            devices=max(1, self._mesh_devices),
            log_window=self.kcfg.log_window,
            host_staging_bytes=staging,
        )
        # worker pools for apply + snapshot work (same split as ExecEngine)
        self._n_task = num_task_workers or min(
            soft.step_engine_task_worker_count, 4
        )
        self._n_snap = num_snapshot_workers
        self.task_ready = WorkReady(self._n_task)
        self.snapshot_ready = WorkReady(self._n_snap)
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._loop, name="vec-step", daemon=True)
        t.start()
        self._threads.append(t)
        for i in range(self._n_task):
            t = threading.Thread(
                target=self._task_worker_main, args=(i,), name=f"vtask-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        for i in range(self._n_snap):
            t = threading.Thread(
                target=self._snapshot_worker_main, args=(i,), name=f"vsnap-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _alloc_buffers(self) -> None:
        # inbox staging: each buffer set is ONE host byte buffer (pinned on
        # the card) whose numpy views are the inbox planes, the ticks and,
        # at K>1, the route/delta planes; the device planes are views of
        # one device byte buffer of the same layout, so a single copy
        # ships them all. TWO sets with overlapped decode: step t's host
        # buffer must stay untouched while its copy may still be reading
        # it, so pack alternates between the sets. One device buffer
        # serves both: step t+1's copy is stream-ordered after step t.
        G, K = self.kcfg.groups, self.kcfg.inbox_depth
        E, P = self.kcfg.max_entries_per_msg, self.kcfg.peers
        i32, b8 = torch.int32, torch.bool
        layout = [
            ("mtype", (G, K), i32), ("from_slot", (G, K), i32),
            ("term", (G, K), i32), ("log_index", (G, K), i32),
            ("log_term", (G, K), i32), ("commit", (G, K), i32),
            ("reject", (G, K), b8), ("hint", (G, K), i32),
            ("hint_high", (G, K), i32), ("n_entries", (G, K), i32),
            ("entry_terms", (G, K, E), i32), ("entry_cc", (G, K, E), b8),
            ("ticks", (G,), i32),
        ]
        if self._multi > 1:
            layout += [("route", (G, P), i32), ("rdelta", (G, P), i32)]
        self._bufsets = []
        for _ in range(2 if self._overlap else 1):
            host = _Planes(layout, "cpu", pin=self._cuda)
            buf = {f: host.np[f] for f in Inbox._fields}
            buf["mtype"].fill(MSG.NONE)
            inbox = Inbox(**buf)
            self._bufsets.append((buf, host.np["ticks"], inbox, host))
        if self._multi > 1:
            # K>1 forces overlap off: one set, whose route/delta views the
            # loop rebuilds between super-steps (after the fetch sync, so
            # never under an in-flight copy)
            self._np_route = self._bufsets[0][3].np["route"]
            self._np_rdelta = self._bufsets[0][3].np["rdelta"]
            self._np_route.fill(-1)
        # per shard: device planes of its Gl lanes and the host planes its
        # ONE host->device copy reads: the buffer sets themselves when one
        # shard holds every lane; else, on the card, a pinned copy of its
        # slice of each set (filled at dispatch), and on the CPU none
        # (dispatch fills its device planes directly)
        n = len(self._shards)
        Gl = G // n
        llayout = [(f, (Gl,) + shape[1:], dt) for f, shape, dt in layout]
        for sh in self._shards:
            with sh.alloc():
                sh.dev_in = _Planes(llayout, sh.device)
            sh.dev_inbox = Inbox(**{f: sh.dev_in.t[f] for f in Inbox._fields})
            if n == 1:
                sh.host_ins = [host for *_, host in self._bufsets]
            elif self._cuda:
                sh.host_ins = [_Planes(llayout, "cpu", pin=True) for _ in self._bufsets]
            else:
                sh.host_ins = None
        self._buf_idx = 0
        self._buf, self._ticks, self._host_inbox, self._host_in = self._bufsets[0]
        # fetch side: the K=1 step writes its StepOutput into views of one
        # device byte buffer; each dispatch copies it into the next of two
        # pinned host slots (decode of step t-1 reads one slot while step
        # t's copy fills the other) and records an event the fetch waits
        # on. At K>1 one slot holds the stacked outputs, plans and the
        # residual occupancy of a super-step.
        R = self.kcfg.readindex_depth

        def out_layout_of(G):
            lay = [
                (f, shape, dt) for f, shape, dt in _output_layout(G, P, K, R)
            ]
            if self._multi > 1:
                Kt = self._multi
                lay = [
                    (f, (Kt,) + shape, dt) for f, shape, dt in lay
                ] + [
                    ("plan_" + f, (Kt,) + shape, torch.bool)
                    for f, shape in zip(
                        RoutePlan._fields,
                        [(G, P)] * 4 + [(G, K), (G, R)],
                    )
                ] + [("resid_count", (G,), i32)]
            return lay

        n_slots = 1 if self._multi > 1 else 2
        # per shard: device output planes (on the card, at K=1 and at K>1)
        # and its part of each pinned host slot, so that ONE device->host
        # copy per shard lands its outputs
        lout = out_layout_of(Gl)
        for sh in self._shards:
            # the step's (K=1) or the super-step's (K>1: `into`) output
            # trees over the device planes; None on the CPU, whose steps
            # return fresh trees
            sh.dev_out = sh.outs = sh.plans = None
            if self._cuda:
                with sh.alloc():
                    sh.dev_out = _Planes(lout, sh.device)
                t = sh.dev_out.t
                sh.outs = StepOutput(**{f: t[f] for f in StepOutput._fields})
                if self._multi > 1:
                    sh.plans = RoutePlan(
                        **{f: t["plan_" + f] for f in RoutePlan._fields}
                    )
        self._out_slots = [
            [_Planes(lout, "cpu", pin=self._cuda) for _ in self._shards]
            for _ in range(n_slots)
        ]
        self._out_idx = 0
        # columnar row staging for _pack: rows accumulate as python column
        # lists and land in the numpy planes as ONE fancy-indexed scatter
        # per plane (_flush_staged_rows) — list appends are cheaper than
        # per-row scalar numpy stores across ten planes
        self._rows = {
            "g": [], "k": [], "mtype": [], "from_slot": [], "term": [],
            "log_index": [], "log_term": [], "commit": [], "reject": [],
            "hint": [], "hint_high": [], "n_entries": [], "ents": [],
        }

    # ------------------------------------------------- the shards' trees
    def _shard_of(self, g: int) -> _Shard:
        """The shard that holds lane g."""
        return self._shards[g // self._shards[0].hi]

    def _lane_rows(self, g: int):
        """(state tree, residual inbox or None, row, stream context) of lane
        g: its shard's trees and its row there."""
        sh = self._shard_of(g)
        return sh.state, sh.resid, g - sh.lo, sh.on()

    def _blocks(self, *arrays):
        """Per shard: (shard, stream context, each host array's rows of
        that shard)."""
        return [
            (sh, sh.on(), tuple(a[sh.lo:sh.hi] for a in arrays))
            for sh in self._shards
        ]

    def _alloc_mirrors(self) -> None:
        """Whole-G numpy mirrors of per-lane protocol state, refreshed from
        the StepOutput once per step (device units where applicable)."""
        G = self.kcfg.groups
        self._lane_by_g: List[Optional[_Lane]] = [None] * G
        self._m_base = np.zeros(G, np.int64)  # real = device + base
        self._m_devfirst = np.ones(G, np.int64)  # device-units first index
        self._m_term = np.zeros(G, np.int32)
        self._m_role = np.full(G, ROLE.FOLLOWER, np.int32)
        self._m_leader = np.zeros(G, np.int32)  # slot+1, 0=none
        self._m_commit = np.zeros(G, np.int64)  # device units
        self._m_last = np.zeros(G, np.int64)  # device units
        self._m_tick_cap = np.ones(G, np.int32)  # election_rtt per lane
        self._m_active = np.zeros(G, bool)
        self._m_snap_every = np.zeros(G, np.int64)  # cfg.snapshot_entries
        self._m_applied_since = np.zeros(G, np.int64)
        self._m_snap_pending = np.zeros(G, bool)
        self._m_quiesced = np.zeros(G, bool)
        self._m_host = np.zeros(G, np.int32)  # owning handle id per lane
        self._m_clock_ok = np.ones(G, bool)  # mirror of device clock_ok
        # lease validity after the last decoded step (StepOutput.lease_ok):
        # read by the lease-only probe (NodeHost.lease_read) with zero
        # device syncs; a stale read is inherent to probing and safe — the
        # serve itself is decided by the kernel, not this mirror
        self._m_lease_ok = np.zeros(G, bool)
        # engine-clock tick of the lane's last LEADER transition: feeds the
        # per-lane ticks_since_leader_change gauge (lane_stats) with zero
        # device syncs — updated only for lanes the decode phase already
        # iterates as changed
        self._m_leader_change_tick = np.zeros(G, np.int64)
        # cumulative per-lane protocol-event counters: the kernel's
        # per-step u32 deltas (StepOutput.counters, one CTR.* column per
        # event) summed here by the decode fold — loop-thread writes,
        # lock-free reads via counter_stats/lane_counters (a torn read
        # costs one stale sample on an export path, never a decision)
        self._ctr = np.zeros((G, CTR.COUNT), np.uint64)

    # ------------------------------------------------------- mirror helpers
    def _committed_real(self, g: int) -> int:
        return int(self._m_base[g] + self._m_commit[g])

    def _last_real(self, g: int) -> int:
        return int(self._m_base[g] + self._m_last[g])

    # --------------------------------------------------------- registration
    def add_node(self, node: VectorNode, host: int = 0) -> None:
        key = (host, node.cluster_id)
        lane = None
        for attempt in range(2):
            with self._lanes_mu:
                if self._free:
                    g = self._free.pop()
                    lane = _Lane(g, node, key=key)
                    self._lanes[key] = lane
                    self._lane_by_g[g] = lane
                    self._route[(node.cluster_id, node.node_id())] = lane
                    self._m_host[g] = host
                    break
            if attempt == 0:
                # the free list can be momentarily empty while freed lanes
                # sit in the reconcile queue (stop_cluster immediately
                # followed by restart_cluster): drain the loop once so a
                # restart is never failed by its own predecessor's
                # not-yet-reaped lane
                self.drain(10.0)
        if lane is None:
            raise RuntimeError(
                f"vector engine lane capacity ({self.kcfg.groups}) exhausted"
            )
        node._vec_lane = lane
        self._reconq.append(("activate", lane))
        self.set_node_ready(key)

    def remove_node(self, key) -> None:
        with self._lanes_mu:
            lane = self._lanes.pop(key, None)
            if lane is not None:
                rk = (lane.node.cluster_id, lane.node.node_id())
                if self._route.get(rk) is lane:
                    del self._route[rk]
        if lane is not None:
            self._reconq.append(("deactivate", lane))
            self._ready.set()

    def get_node(self, key):
        with self._lanes_mu:
            lane = self._lanes.get(key)
        return lane.node if lane is not None else None

    def lease_valid(self, key) -> bool:
        """Did this lane hold a live leader lease after the last decoded
        step? Mirror read (no device sync) for the lease-only probe;
        the authoritative serve/fallback decision stays in the kernel."""
        with self._lanes_mu:
            lane = self._lanes.get(key)
        return lane is not None and bool(self._m_lease_ok[lane.g])

    # -------------------------------------------------------------- wakeups
    def set_node_ready(self, key) -> None:
        with self._dirty_mu:
            self._dirty.add(key)
            self._gc_set.add(key)
        self._ready.set()

    def _wake(self, key) -> None:
        """Like set_node_ready but without arming request GC — the hot path
        for message delivery (messages alone never need a timeout sweep)."""
        with self._dirty_mu:
            self._dirty.add(key)
        self._ready.set()

    def global_tick(self, host: int = 0) -> None:
        """One logical tick for every lane of `host` (replaces per-lane
        LocalTick messages; the loop folds counts into the device tick
        array, per owning host)."""
        with self._dirty_mu:
            self._pending_ticks[host] = self._pending_ticks.get(host, 0) + 1
        self._ready.set()

    def set_task_ready(self, key) -> None:
        self.task_ready.notify(key)

    def set_snapshot_ready(self, key) -> None:
        self.snapshot_ready.notify(key)

    # ------------------------------------------------------ local delivery
    def try_local_deliver(self, m: Message) -> bool:
        """Deliver a wire message directly to a co-hosted lane of this core
        (same engine => same process), skipping the transport and codec
        entirely. This is the host half of SURVEY §7's 'co-hosted replica
        exchange': replicas that advance in one kernel step exchange their
        protocol traffic through the shared inbox, not the network.
        InstallSnapshot is excluded — snapshot images move through the
        streaming path so the receiver owns its on-disk copy."""
        if m.type == MT.INSTALL_SNAPSHOT:
            return False
        lane = self._route.get((m.cluster_id, m.to))
        if lane is None:
            return False
        if lane.key[0] in self._blocked_hosts:
            # the receiving NodeHost simulates a partition: co-hosted
            # traffic must drop exactly like the wire path does
            # (nodehost.handle_message_batch returns early when
            # partitioned)
            return True
        hook = self._local_drop_hook
        if hook is not None and hook(m):
            return True  # dropped by chaos hook
        node = lane.node
        if node.stopped or not node.mq.add(m):
            return False
        self._wake(lane.key)
        return True

    def try_local_deliver_many(self, msgs: List[Message]) -> List[Message]:
        """Bulk co-hosted delivery: group the batch by destination lane,
        enqueue each lane's messages under ONE queue lock, mark every
        receiver dirty under ONE engine lock and wake the loop once.
        Returns the messages that must ride the wire instead (no co-hosted
        lane, stopped node, or a full receive queue — the same per-message
        fallthrough try_local_deliver reports with False)."""
        rest: List[Message] = []
        by_lane: Dict[_Lane, List[Message]] = {}
        route = self._route
        blocked = self._blocked_hosts
        hook = self._local_drop_hook
        for m in msgs:
            if m.type == MT.INSTALL_SNAPSHOT:
                rest.append(m)
                continue
            lane = route.get((m.cluster_id, m.to))
            if lane is None:
                rest.append(m)
                continue
            if lane.key[0] in blocked:
                continue  # partitioned receiver: drop like the wire path
            if hook is not None and hook(m):
                continue  # dropped by chaos hook
            lst = by_lane.get(lane)
            if lst is None:
                lst = by_lane[lane] = []
            lst.append(m)
        if not by_lane:
            return rest
        woke = []
        for lane, ms in by_lane.items():
            node = lane.node
            if node.stopped:
                rest.extend(ms)
                continue
            taken = node.mq.add_many(ms)
            if taken < len(ms):
                rest.extend(ms[taken:])
            if taken:
                woke.append(lane.key)
        if woke:
            with self._dirty_mu:
                self._dirty.update(woke)
            self._ready.set()
        return rest

    def set_host_partitioned(self, host: int, partitioned: bool) -> None:
        if partitioned:
            self._blocked_hosts.add(host)
        else:
            self._blocked_hosts.discard(host)
        # multi-step: a partitioned host's lanes must drop out of the
        # on-device routing table (its traffic falls back to the host
        # path, where the partition drop applies)
        self._routes_dirty = True

    def set_clock_suspect(self, host: int, hold_s: float) -> None:
        """Clock-anomaly report from a host's tick worker (backward
        reading / backlog past the catch-up cap): every lane owned by
        `host` loses lease rights (clock_ok=False) until the hold
        expires — lease reads degrade to the ReadIndex quorum path,
        never to staleness. Cheap to call; the loop thread touches the
        device only on suspect-set transitions."""
        deadline = time.monotonic() + max(float(hold_s), 0.0)
        with self._dirty_mu:
            cur = self._clock_suspect.get(host, 0.0)
            self._clock_suspect[host] = max(cur, deadline)
        self._ready.set()

    def _apply_clock_suspect(self) -> None:
        """Loop-thread reconcile of the per-host suspect deadlines onto
        the per-lane clock_ok plane. No-op (one dict probe) while no host
        is suspect; while one is, a G-bool compare per iteration and a
        device write only when the lane set actually changes — including
        the final restore when the last hold expires."""
        if not self._clock_suspect and self._m_clock_ok.all():
            return
        now = time.monotonic()
        with self._dirty_mu:
            for h in [
                h for h, d in self._clock_suspect.items() if d <= now
            ]:
                del self._clock_suspect[h]
            bad = list(self._clock_suspect)
        if bad:
            want = ~np.isin(self._m_host, np.asarray(bad, np.int32))
        else:
            want = np.ones(self.kcfg.groups, bool)
        if not np.array_equal(want, self._m_clock_ok):
            self._m_clock_ok = want
            for sh, ctx, (w,) in self._blocks(want):
                with ctx:
                    sh.state.clock_ok.copy_(
                        torch.from_numpy(np.ascontiguousarray(w))
                    )

    def set_local_drop_hook(self, hook) -> None:
        """Install a chaos drop predicate over co-hosted delivery
        (hook(message) -> True drops it). None clears. While a hook is
        installed the multi-step engine disables on-device routing
        entirely: every co-hosted message must pass the hook, which only
        the host path can evaluate."""
        self._local_drop_hook = hook
        self._routes_dirty = True

    # ------------------------------------------------- host->device bridges
    def membership_changed(self, node: VectorNode) -> None:
        """Called on a task worker when a config change applies; the loop
        recomputes the canonical slot mapping from the SM membership."""
        self._reconq.append(("membership", node))
        self._ready.set()

    def snapshot_restored(self, node: VectorNode, ss: Snapshot) -> None:
        self._reconq.append(("restore", node, ss))
        self._ready.set()

    def cc_processed(self, node: VectorNode) -> None:
        self._reconq.append(("cc_done", node))
        self._ready.set()

    def recover_done(self, node: VectorNode) -> None:
        self._reconq.append(("recover_done", node))
        self._ready.set()

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        # per-thread CUDA state (the current device and stream) is the
        # loop thread's alone: every device op of the engine runs here
        if self._cuda:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self._stream)
        period = 0.002
        wd = self.watchdog
        while not self._stopped.is_set():
            self._ready.wait(period)
            self._ready.clear()
            if self._stopped.is_set():
                break
            t0 = wd.iter_begin()
            self._last_tick_burst = 0
            try:
                self._run_once()
            except SaveHoleError as e:
                self._halt(e)
                break
            except Exception:
                import traceback

                traceback.print_exc()
            wd.iter_end(t0, ticks=self._last_tick_burst, steps=self._multi)
        try:
            if self._discard_pending:
                # crash teardown (stop(flush=False)): the un-decoded
                # in-flight step dies undecoded — a SIGKILL'd process
                # would never have fanned it out or saved it, and chaos
                # restarts must not silently grant that durability
                self._pending = None
            else:
                self._flush_pending()  # the last step's saves must land
        except SaveHoleError as e:
            self._halt(e)
        except Exception:
            import traceback

            traceback.print_exc()

    def _halt(self, e: SaveHoleError) -> None:
        """Durability first: nothing of the step that lacks a run is saved
        or acked, and the loop stops rather than step past the hole. Every
        request in flight on the core's nodes completes as terminated, and
        new ones raise ErrClusterClosed: with the loop stopped no clock
        ticks, so they would otherwise never time out. `fault` and the
        `faults` step stat (NodeHost's engine_step_faults gauge) say so."""
        self.fault = e
        self._sstats["faults"] = 1
        self._discard_pending = True
        _plog.errorf("vector engine stopped: %s", e)
        with self._lanes_mu:
            nodes = [lane.node for lane in self._lanes.values()]
        for node in nodes:
            node.fail_requests()

    def snapshot_status_ready(self, node) -> None:
        with self._snap_status_mu:
            self._snap_status.add(node)
        self._ready.set()

    def _run_once(self) -> None:
        # reconciles, snapshot finalization and rebase rewrite per-group
        # mirrors (_m_base/_m_last/_lane_by_g); an undecoded in-flight step
        # would later clobber them with stale device output, so these rare
        # paths drain the pipeline first
        if self._reconq or self._snap_status or self._rebase_due:
            self._flush_pending()
            if self._rebase_due:
                self._rebase_due = False
                self._do_rebase()
        self._apply_reconciles()
        self._apply_clock_suspect()
        with self._snap_status_mu:
            snap_done, self._snap_status = self._snap_status, set()
        for node in snap_done:
            # lint: allow(locks/lock-in-hot-loop) snapshot completions:
            # empty ~every step, bounded by in-flight snapshot workers
            with node._mu:
                node._process_snapshot_status()
        if self._multi > 1 and self._routes_dirty:
            self._rebuild_routes()
        with self._dirty_mu:
            dirty = self._dirty
            self._dirty = set()
            tick_counts = self._pending_ticks
            self._pending_ticks = {}
            ticks = max(tick_counts.values()) if tick_counts else 0
            gc_cids = list(self._gc_set) if ticks else ()
        if ticks:
            for _ in range(ticks):
                self.clock.increase_tick()
            self._run_gc(gc_cids)
        work = self._carry
        self._carry = set()
        if dirty:
            with self._lanes_mu:
                for cid in dirty:
                    lane = self._lanes.get(cid)
                    if lane is not None and lane.active:
                        work.add(lane)
        work |= self._catchups
        prof = self.profiler
        prof.new_iteration(len(work))
        # swap to the idle buffer set BEFORE packing: the other set may
        # still be read by the in-flight step
        if self._overlap:
            self._buf_idx = 1 - self._buf_idx
            (
                self._buf, self._ticks, self._host_inbox, self._host_in,
            ) = self._bufsets[self._buf_idx]
        prof.start()
        had, packs = self._pack(work)
        prof.end("pack")
        if not had:
            skip = False
            if ticks == 0:
                skip = True
            else:
                # no active lanes: ticks have nobody to advance
                act = self._m_active
                if not act.any():
                    skip = True
                # a fully-quiesced fleet needs no kernel step for ticks:
                # every timer is frozen, so the step would be a no-op (this
                # is what makes 10k+ idle lanes cost zero host AND device
                # work)
                elif bool(np.all(~act | self._m_quiesced)):
                    skip = True
            if skip and self._m_resid.any():
                # device-routed messages from the previous super-step's
                # last inner step are parked in the residual inbox: they
                # must be consumed even with no fresh host work
                skip = False
            if skip:
                # nothing new dispatched: the pipeline must not sit on an
                # undecoded step indefinitely
                self._flush_pending()
                return
        if ticks:
            # per-lane tick counts come from the OWNING host's counter (a
            # shared core serves several NodeHosts, each with its own tick
            # thread); clamped per lane at its catch-up burst cap, and the
            # EXCESS backlog is shed — not deferred — so a stall charges
            # at most one small burst to each timer and the randomized
            # election spread survives (see _catchup_tick_cap)
            if self._next_host <= 1:
                per_lane = ticks
            else:
                hv = np.zeros(self._next_host + 1, np.int32)
                for h, c in tick_counts.items():
                    hv[h] = c
                per_lane = hv[self._m_host]
            np.minimum(self._m_tick_cap, per_lane, out=self._ticks)
            self._ticks *= self._m_active
            self._last_tick_burst = ticks
            if ticks > 1 and bool(
                np.any((per_lane > self._m_tick_cap) & self._m_active)
            ):
                # some ACTIVE lane's own host backlog exceeded its cap
                # (per_lane broadcasts: scalar for a single host, the
                # owning host's column otherwise)
                self.watchdog.tick_burst_clamped()
        else:
            self._ticks.fill(0)
        # ONE host->device copy per shard ships its staging buffer: the
        # inbox planes, the ticks and, at K>1, the route/delta planes (small
        # G x P arrays, rebuilt host-side only when lane topology changes);
        # the device planes are views of the buffer it lands in. Then at
        # K=1 one step per shard (no exchange, as in the reference's K=1
        # program over the mesh), at K>1 the super-step over the shards;
        # then ONE device->host copy per shard into its part of the pinned
        # slot, with one event per shard
        prof.start()
        shards = self._shards
        host = self._host_in.np
        for sh in shards:
            stage = sh.dev_in if sh.host_ins is None else sh.host_ins[self._buf_idx]
            if stage is not self._host_in:
                # the shard's slice of the pack buffer
                for f, a in stage.np.items():
                    a[...] = host[f][sh.lo:sh.hi]
            if sh.host_ins is not None:
                # lint: allow(locks/lock-in-hot-loop) a CUDA stream context, not a
                # lock: one per shard per step
                with sh.on():
                    sh.dev_in.bytes.copy_(stage.bytes, non_blocking=self._cuda)
        if self._multi > 1:
            kw = {}
            if self._cuda:
                kw = dict(streams=[sh.stream for sh in shards],
                          into=[(sh.outs, sh.plans) for sh in shards])
            with self._launch_mu:
                states, outs, plans, resids, rcs = self._multi_fn(
                    [sh.state for sh in shards], [sh.dev_inbox for sh in shards],
                    [sh.dev_in.t["ticks"] for sh in shards],
                    [sh.resid for sh in shards],
                    [sh.dev_in.t["route"] for sh in shards],
                    [sh.dev_in.t["rdelta"] for sh in shards],
                    **kw,
                )
                for sh, st, r in zip(shards, states, resids):
                    sh.state, sh.resid = st, r
                slot = self._ship_super(outs, plans, rcs)
                prof.end("dispatch")
                o, pl, rc = self._fetch_super(slot)
            self._m_resid = rc
            self._decode_super(work, packs, o, pl)
            return
        outs = []
        for sh in shards:
            # lint: allow(locks/lock-in-hot-loop) a CUDA stream context, not a
            # lock: one per shard per step
            with sh.on():
                sh.state, out = step_batch(
                    sh.state, sh.dev_inbox, sh.dev_in.t["ticks"], self.kcfg,
                    out=sh.outs,
                )
            outs.append(out)
        slot = self._ship_output(outs)
        prof.end("dispatch")
        if self._overlap:
            # pipeline: decode step t-1 while the device computes step t
            # (the launch and the copy into the pinned slot are async;
            # `slot` carries the events the fetch waits on). Ordering
            # invariants live inside each step's decode, so pipelining
            # steps preserves them; pack staleness is accounted for by the
            # per-lane packed_pending window tracking. Swap FIRST so a
            # decode exception cannot also lose the just-dispatched step.
            pending, self._pending = self._pending, (work, packs, slot)
            if pending is not None:
                self._sstats["steps_pipelined"] += 1
            self._flush_one(pending)
        else:
            self._decode(work, packs, self._fetch_output(slot))

    def _ship_shards(self, planes) -> tuple:
        """Ship the step's planes: `planes[i]` maps slot plane names to
        shard i's tensors (on the card: those its device output planes do
        not hold yet, copied into them first). ONE device->host copy per
        shard into its part of the next pinned slot and an event on its
        stream; on the CPU a copy per plane. Returns (slot, events); the
        fetch waits."""
        slot = self._next_slot()
        evs = []
        for sh, part, named in zip(self._shards, slot, planes):
            if not self._cuda:
                for f, x in named.items():
                    part.t[f].copy_(x)
                continue
            # lint: allow(locks/lock-in-hot-loop) a CUDA stream context, not a
            # lock: one per shard per step
            with sh.on():
                for f, x in named.items():
                    sh.dev_out.t[f].copy_(x)
                part.bytes.copy_(sh.dev_out.bytes, non_blocking=True)
            ev = torch.cuda.Event()
            # lint: allow(telemetry/unguarded) torch.cuda.Event.record, not
            # telemetry: one marker per shard per step, the fetch seam's
            ev.record(sh.stream)
            evs.append(ev)
        return slot, evs

    def _join_slot(self, slot) -> Dict[str, np.ndarray]:
        """The whole-G planes of a slot: each plane's shard parts joined
        along the lane axis (axis 1 of the stacked K>1 planes); one shard's
        are its planes themselves."""
        if len(slot) == 1:
            return dict(slot[0].np)
        out = {}
        for f in slot[0].np:
            ax = 1 if self._multi > 1 and f != "resid_count" else 0
            out[f] = np.concatenate([p.np[f] for p in slot], axis=ax)
        return out

    def _next_slot(self):
        slot = self._out_slots[self._out_idx]
        self._out_idx = (self._out_idx + 1) % len(self._out_slots)
        return slot

    def _ship_output(self, outs):
        """Enqueue the step's StepOutput, one tree per shard, into the next
        pinned host slot (_ship_shards): on the card the step wrote its
        planes into views of the shard's device output buffer, which ONE
        async copy ships. Returns (slot, events); the fetch waits."""
        return self._ship_shards([
            {} if self._cuda else dict(zip(StepOutput._fields, o)) for o in outs
        ])

    def _ship_super(self, outs, plans, resid_count):
        """The K>1 twin of _ship_output: the stacked per-step outputs, the
        per-step route plans and the residual occupancy of each shard (one
        tree each) land in its part of ONE pinned host slot."""
        named = []
        for o, p, rc in zip(outs, plans, resid_count):
            # on the card the super-step wrote outs and plans into the
            # shard's device output planes (`into`)
            d = {} if self._cuda else dict(zip(StepOutput._fields, o))
            if not self._cuda:
                d.update(("plan_" + f, x) for f, x in zip(RoutePlan._fields, p))
            d["resid_count"] = rc
            named.append(d)
        return self._ship_shards(named)

    def _fetch_output(self, pending) -> dict:
        """THE consolidated device->host sync for the whole StepOutput,
        shared by the overlap and non-overlap paths: one wait on each
        shard's event for the copy _ship_output enqueued, one seam. The
        planes ship together rather than per-plane masked gets: every
        plane is G- or GxP-sized, so per-copy overhead dominates transfer
        cost, and each decode phase masks its own work list host-side from
        send_flags/dirty lanes. The returned arrays are views of the pinned
        slot (joined copies when sharded), valid until the slot's next use
        two dispatches later."""
        prof = self.profiler
        prof.start()
        slot, evs = pending
        for e in evs:
            e.synchronize()
        note_seam_sync()  # runtime sync audit: the ONE blessed transfer
        prof.end("fetch")
        return self._join_slot(slot)

    def _fetch_super(self, pending):
        """The multi-step twin of _fetch_output: ONE seam for the whole
        K-step super-step (the stacked per-step StepOutput planes, the
        per-step route plans and the residual-inbox occupancy ship
        together). This is the other blessed sync seam — it fires once
        per K protocol steps, whatever the number of shards."""
        prof = self.profiler
        prof.start()
        slot, evs = pending
        for e in evs:
            e.synchronize()
        note_seam_sync()  # runtime sync audit: one transfer per K steps
        prof.end("fetch")
        n = self._join_slot(slot)
        o = {f: n[f] for f in StepOutput._fields}
        pl = {f: n["plan_" + f] for f in RoutePlan._fields}
        return o, pl, n["resid_count"].astype(np.int32)

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        self._flush_one(pending)

    def _flush_one(self, pending) -> None:
        if pending is None:
            return
        work, packs, out = pending
        self._decode(work, packs, self._fetch_output(out))

    def _run_gc(self, gc_cids) -> None:
        """Request-timeout pass over lanes with outstanding requests only
        (the reference runs four gc calls per node per tick; idle lanes
        here cost nothing)."""
        if not self.clock.should_gc():
            return
        drop = []
        for cid in gc_cids:
            with self._lanes_mu:
                lane = self._lanes.get(cid)
            if lane is None:
                drop.append(cid)
                continue
            node = lane.node
            node.pending_proposals.gc()
            node.pending_read_indexes.gc()
            node.pending_config_change.gc()
            node.pending_snapshot.gc()
            node.gc_batches()
            if lane.ri_pending:
                # engine-side ctx routing entries die with their batches
                # (timed-out forwarded reads would otherwise leak here)
                pri = node.pending_read_indexes
                dead = [
                    enc
                    for enc, ctx in lane.ri_pending.items()
                    if not pri.has_ctx(ctx)
                ]
                for enc in dead:
                    del lane.ri_pending[enc]
            if not (
                node.pending_proposals.has_pending()
                or node.pending_read_indexes.has_pending()
                or node.pending_config_change.has_pending()
                or node.pending_snapshot.has_pending()
                or node._batches
            ):
                drop.append(cid)
        if drop:
            with self._dirty_mu:
                # a request registered concurrently re-adds its cid to
                # _dirty AND _gc_set (set_node_ready); keep those — else
                # the new request's timeout gc would never run
                self._gc_set.difference_update(set(drop) - self._dirty)

    # ---------------------------------------------------------------- pack
    def _pack(self, lanes: Set[_Lane]):
        K = self.kcfg.inbox_depth
        E = self.kcfg.max_entries_per_msg
        W = self.kcfg.log_window
        buf = self._buf
        buf["mtype"].fill(MSG.NONE)
        buf["n_entries"].fill(0)
        buf["entry_cc"].fill(False)
        # self-healing like the old direct writes: rows staged by an
        # iteration that died mid-pack (loop catches and continues) must
        # not replay into this step's planes as phantom kernel messages
        for col in self._rows.values():
            col.clear()
        had = bool(self._catchups)
        packs: Dict[_Lane, Dict[int, tuple]] = {}
        # per-lane mirror reads gathered ONCE as columns (per-element
        # int(arr[g]) reads were a measured hot spot at fleet widths)
        work = list(lanes)
        if work:
            w_gs = [lane.g for lane in work]
            cols = zip(
                work,
                self._m_quiesced[w_gs].tolist(),
                self._m_role[w_gs].tolist(),
                self._m_leader[w_gs].tolist(),
                self._m_last[w_gs].tolist(),
                self._m_devfirst[w_gs].tolist(),
                self._m_base[w_gs].tolist(),
                # multi-step: device-routed residual messages occupy the
                # low inbox slots of the NEXT super-step; host rows pack
                # after them (all-zero at K=1)
                self._m_resid[w_gs].tolist(),
            )
        else:
            cols = ()
        for (
            lane, g_quiesced, g_role, g_leader, g_last, g_devfirst, b, g_resid,
        ) in cols:
            node = lane.node
            g = lane.g
            lane.pack_info = {}
            # queue drains gated on lock-free emptiness probes: producers
            # mark the lane dirty AFTER enqueueing, so a racy miss is
            # re-delivered next iteration; most dirty lanes carry only ONE
            # kind of event and skip the other queues' lock round-trips
            if node.mq.has_pending():
                msgs, _ = node.mq.get()
                lane.msg_backlog.extend(msgs)
            if lane.recovering:
                # an InstallSnapshot recover is in flight: hold everything
                # until the device lane is reconciled (cf. node.go:1199)
                if lane.has_staged():
                    self._carry.add(lane)
                continue
            # drain API queues into the staging deques
            if node.incoming_proposals.has_pending():
                lane.staged_props.extend(node.incoming_proposals.get())
            if node.incoming_reads.has_pending():
                lane.staged_reads.extend(node.incoming_reads.get())
            if node._cc_queue:
                # lint: allow(locks/lock-in-hot-loop) config changes: the
                # lock-free emptiness probe above keeps steady-state lanes
                # off this lock; only lanes with a queued cc pay it
                with node._mu:
                    ccs, node._cc_queue = node._cc_queue, []
                for cc, key in ccs:
                    ce = Entry(
                        type=EntryType.CONFIG_CHANGE,
                        cmd=encode_config_change(cc),
                        key=key,
                    )
                    lane.staged_ccs.append((ce, key))
            k = g_resid
            # a quiesced lane with fresh host work gets a wake NOOP (the
            # kernel exits quiesce on any non-heartbeat inbox message; the
            # reference wakes through exitQuiesce on activity, quiesce.go)
            if (
                g_quiesced
                and k < K
                and (lane.has_staged() or node.pending_leader_transfer.peek())
            ):
                self._stage_row(
                    g, k, MSG.NOOP, from_slot=max(lane.self_slot(), 0)
                )
                had = True
                k += 1
            # 1. wire/protocol messages first
            while lane.msg_backlog and k < K:
                m = lane.msg_backlog.popleft()
                k_used = self._pack_wire(lane, m, k, b)
                if k_used:
                    had = True
                    k += 1
            is_leader = g_role == ROLE.LEADER
            leader_nid = lane.rev.get(g_leader - 1)
            # 2. one config change per step (lone message; host invariant)
            if k < K and lane.staged_ccs and not lane.cc_inflight:
                if is_leader:
                    ce, key = lane.staged_ccs.popleft()
                    self._stage_row(
                        g, k, MSG.PROPOSE, from_slot=lane.self_slot(),
                        n_entries=1,
                    )
                    self._rows["ents"].append((g, k, None, (True,)))
                    lane.pack_info[k] = ("cc", ce, key)
                    lane.cc_inflight = True
                    lane.packed_pending += 1
                    had = True
                    k += 1
                elif leader_nid is not None and leader_nid != node.node_id():
                    while lane.staged_ccs:
                        ce, key = lane.staged_ccs.popleft()
                        node._send_message(
                            Message(
                                type=MT.PROPOSE,
                                cluster_id=node.cluster_id,
                                to=leader_nid,
                                from_=node.node_id(),
                                entries=[ce],
                            )
                        )
            # 3. proposals — throttled to the device window's free space so
            # the kernel never has to drop for lack of room (minus 1 slot
            # of slack for a concurrent new-leader noop append); what
            # doesn't fit stays staged and re-packs after compaction
            if lane.staged_props:
                if is_leader:
                    free = (
                        W - 1 - (g_last - g_devfirst + 1)
                        - lane.packed_pending
                    )
                    while lane.staged_props and k < K and free > 0:
                        ents = []
                        cap = min(E, free)
                        while lane.staged_props and len(ents) < cap:
                            ents.append(lane.staged_props.popleft())
                        free -= len(ents)
                        lane.packed_pending += len(ents)
                        self._stage_row(
                            g, k, MSG.PROPOSE, from_slot=lane.self_slot(),
                            n_entries=len(ents),
                        )
                        lane.pack_info[k] = ("prop", ents)
                        had = True
                        k += 1
                elif leader_nid is not None and leader_nid != node.node_id():
                    ents = list(lane.staged_props)
                    lane.staged_props.clear()
                    for i in range(0, len(ents), 64):
                        node._send_message(
                            Message(
                                type=MT.PROPOSE,
                                cluster_id=node.cluster_id,
                                to=leader_nid,
                                from_=node.node_id(),
                                entries=ents[i : i + 64],
                            )
                        )
            # 4. reads
            if lane.staged_reads:
                if is_leader and lane.self_slot() >= 0:
                    if k < K:
                        states = list(lane.staged_reads)
                        lane.staged_reads.clear()
                        ctx = node.pending_read_indexes.next_ctx()
                        if node.pending_read_indexes.bind_queued_states(
                            states, ctx
                        ):
                            enc = _enc_ctx(lane.self_slot(), ctx.low)
                            lane.ri_pending[enc] = ctx
                            self._stage_row(
                                g, k, MSG.READ_INDEX,
                                from_slot=lane.self_slot(), hint=enc[0],
                                hint_high=enc[1],
                            )
                            had = True
                            k += 1
                elif leader_nid is not None and leader_nid != node.node_id():
                    states = list(lane.staged_reads)
                    lane.staged_reads.clear()
                    ctx = node.pending_read_indexes.next_ctx()
                    if node.pending_read_indexes.bind_queued_states(states, ctx):
                        enc = _enc_ctx(lane.self_slot(), ctx.low)
                        lane.ri_pending[enc] = ctx
                        node._send_message(
                            Message(
                                type=MT.READ_INDEX,
                                cluster_id=node.cluster_id,
                                to=leader_nid,
                                from_=node.node_id(),
                                hint=enc[0],
                                hint_high=enc[1],
                            )
                        )
            # 5. leadership transfer
            target = node.pending_leader_transfer.get()
            if target is not None and k < K:
                tslot = lane.slots.get(target, -1)
                if tslot >= 0:
                    self._stage_row(
                        g, k, MSG.LEADER_TRANSFER,
                        from_slot=lane.self_slot(), hint=tslot + 1,
                    )
                    had = True
                    k += 1
            # lanes with leftover staged work re-pack next iteration
            # (K exhausted, or a leaderless lane waiting for an election)
            if lane.has_staged():
                self._carry.add(lane)
            if lane.pack_info:
                packs[lane] = lane.pack_info
        # serving backpressure mirrors: rows packed vs this step's lane
        # capacity, and the staged backlog the carry set drags into the
        # next step (leftover staged work means the inbox could not drain
        # the offered load — the engine-side saturation signal). Row
        # count captured BEFORE the flush clears the staging columns.
        self._p_inbox_rows = len(self._rows["g"])
        self._p_inbox_lanes = len(work)
        backlog = 0
        for lane in self._carry:
            backlog += (
                len(lane.staged_props)
                + len(lane.staged_reads)
                + len(lane.staged_ccs)
            )
        self._p_staged_backlog = backlog
        self._flush_staged_rows()
        return had, packs

    def _stage_row(
        self, g: int, k: int, mtype: int, from_slot: int = 0, term: int = 0,
        log_index: int = 0, log_term: int = 0, commit: int = 0,
        reject: bool = False, hint: int = 0, hint_high: int = 0,
        n_entries: int = 0,
    ) -> None:
        """Stage one inbox row as column appends; _flush_staged_rows lands
        the whole step's rows with one scatter per plane."""
        r = self._rows
        r["g"].append(g)
        r["k"].append(k)
        r["mtype"].append(mtype)
        r["from_slot"].append(max(from_slot, 0))
        r["term"].append(term)
        r["log_index"].append(log_index)
        r["log_term"].append(log_term)
        r["commit"].append(commit)
        r["reject"].append(reject)
        r["hint"].append(hint)
        r["hint_high"].append(hint_high)
        r["n_entries"].append(n_entries)

    def _flush_staged_rows(self) -> None:
        rows = self._rows
        gs = rows["g"]
        if gs:
            buf = self._buf
            ks = rows["k"]
            buf["mtype"][gs, ks] = rows["mtype"]
            buf["from_slot"][gs, ks] = rows["from_slot"]
            buf["term"][gs, ks] = rows["term"]
            buf["log_index"][gs, ks] = rows["log_index"]
            buf["log_term"][gs, ks] = rows["log_term"]
            buf["commit"][gs, ks] = rows["commit"]
            buf["reject"][gs, ks] = rows["reject"]
            buf["hint"][gs, ks] = rows["hint"]
            buf["hint_high"][gs, ks] = rows["hint_high"]
            buf["n_entries"][gs, ks] = rows["n_entries"]
            ents = rows["ents"]
            if ents:
                terms_buf = buf["entry_terms"]
                cc_buf = buf["entry_cc"]
                for g, k, terms, ccs in ents:
                    if terms is not None:
                        terms_buf[g, k, : len(terms)] = terms
                    cc_buf[g, k, : len(ccs)] = ccs
        for col in rows.values():
            col.clear()

    def _pack_wire(self, lane: _Lane, m: Message, k: int, b: int) -> bool:
        """Convert one wire message into a staged inbox row (b = the lane's
        device window base, gathered once per step by _pack). Returns False
        when the message was consumed host-side (snapshot, propose
        staging)."""
        g = lane.g
        t = m.type
        if t == MT.INSTALL_SNAPSHOT:
            self._handle_install_snapshot(lane, m)
            return False
        if t == MT.PROPOSE:
            for e in m.entries:
                if e.type == EntryType.CONFIG_CHANGE:
                    lane.staged_ccs.append((e, e.key))
                else:
                    lane.staged_props.append(e)
            return False
        if t == MT.QUIESCE:
            return False
        from_slot = lane.slot_of(m.from_, provisional=t == MT.REPLICATE or t == MT.HEARTBEAT or t == MT.REQUEST_VOTE or t == MT.REQUEST_PREVOTE or t == MT.TIMEOUT_NOW or t == MT.READ_INDEX_RESP)
        if from_slot < 0 and m.from_ != 0:
            return False  # unknown sender and no room to learn it
        if t == MT.REPLICATE:
            n = len(m.entries)
            E = self.kcfg.max_entries_per_msg
            if n > E:
                # split: re-queue the tail as a chained Replicate
                head, tail = m.entries[:E], m.entries[E:]
                rest = Message(
                    type=MT.REPLICATE, cluster_id=m.cluster_id, to=m.to,
                    from_=m.from_, term=m.term, commit=m.commit,
                    log_index=head[-1].index, log_term=head[-1].term,
                    entries=tail,
                )
                lane.msg_backlog.appendleft(rest)
                m.entries = head
                n = E
            # causal trace: the receive hop of a sampled entry's chain
            # (after the split so a trace in the requeued tail records
            # when ITS chunk packs)
            trace_id = 0
            for e in m.entries:
                if e.trace_id:
                    trace_id = e.trace_id
            if trace_id:
                flight_recorder().record(
                    "replicate_recv", cluster=lane.node.cluster_id,
                    node=lane.node.node_id(), from_node=m.from_,
                    trace=trace_id,
                )
            self._stage_row(
                g, k, MSG.REPLICATE, from_slot=from_slot, term=m.term,
                log_index=m.log_index - b, log_term=m.log_term,
                commit=max(m.commit - b, 0), n_entries=n,
            )
            self._rows["ents"].append(
                (
                    g, k,
                    [e.term for e in m.entries],
                    [e.is_config_change() for e in m.entries],
                )
            )
            lane.pack_info[k] = ("rep", list(m.entries))
            return True
        if t == MT.HEARTBEAT:
            self._stage_row(
                g, k, MSG.HEARTBEAT, from_slot=from_slot, term=m.term,
                # log_index is the lease round tag (opaque tick stamp,
                # 0 when leases off) — staged raw, no -b translation
                log_index=m.log_index,
                commit=max(m.commit - b, 0), hint=m.hint,
                hint_high=m.hint_high,
            )
            return True
        if t == MT.REQUEST_VOTE:
            self._stage_row(
                g, k, MSG.REQUEST_VOTE, from_slot=from_slot, term=m.term,
                log_index=m.log_index - b, log_term=m.log_term, hint=m.hint,
            )
            return True
        if t == MT.REQUEST_VOTE_RESP:
            self._stage_row(
                g, k, MSG.REQUEST_VOTE_RESP, from_slot=from_slot, term=m.term,
                reject=m.reject,
            )
            return True
        if t == MT.REQUEST_PREVOTE:
            self._stage_row(
                g, k, MSG.REQUEST_PREVOTE, from_slot=from_slot, term=m.term,
                log_index=m.log_index - b, log_term=m.log_term, hint=m.hint,
            )
            return True
        if t == MT.REQUEST_PREVOTE_RESP:
            self._stage_row(
                g, k, MSG.REQUEST_PREVOTE_RESP, from_slot=from_slot,
                term=m.term, reject=m.reject,
            )
            return True
        if t == MT.REPLICATE_RESP:
            if m.reject and m.hint < b and from_slot >= 0:
                # the follower's log ends BELOW our device window: the
                # kernel cannot back off past its own first_index, so a
                # clamped hint would loop rejects forever. Serve the gap
                # host-side (log replay or snapshot) and park the device
                # remote until the follower crosses the window base.
                self._below_window_reject(lane, from_slot, m)
                return False
            cu = lane.catchup.get(from_slot)
            if cu is not None and not m.reject and cu[2] < m.log_index <= b:
                # an ack at or below the window base, where the device keeps
                # no match: the host catch-up notes the follower's progress
                cu[2], cu[3] = m.log_index, self.clock.tick
            self._stage_row(
                g, k, MSG.REPLICATE_RESP, from_slot=from_slot, term=m.term,
                log_index=m.log_index - b, reject=m.reject,
                hint=max(m.hint - b, 0),
            )
            return True
        if t == MT.HEARTBEAT_RESP:
            self._stage_row(
                g, k, MSG.HEARTBEAT_RESP, from_slot=from_slot, term=m.term,
                # echoed lease round tag, raw (see MT.HEARTBEAT above)
                log_index=m.log_index,
                hint=m.hint, hint_high=m.hint_high,
            )
            return True
        if t == MT.READ_INDEX:
            self._stage_row(
                g, k, MSG.READ_INDEX, from_slot=from_slot, term=m.term,
                hint=m.hint, hint_high=m.hint_high,
            )
            return True
        if t == MT.READ_INDEX_RESP:
            self._stage_row(
                g, k, MSG.READ_INDEX_RESP, from_slot=from_slot, term=m.term,
                log_index=m.log_index - b, hint=m.hint,
                hint_high=m.hint_high,
            )
            return True
        if t == MT.TIMEOUT_NOW:
            self._stage_row(
                g, k, MSG.TIMEOUT_NOW, from_slot=from_slot, term=m.term
            )
            return True
        if t == MT.UNREACHABLE:
            self._stage_row(g, k, MSG.UNREACHABLE, from_slot=from_slot)
            return True
        if t == MT.SNAPSHOT_STATUS:
            self._stage_row(
                g, k, MSG.SNAPSHOT_STATUS, from_slot=from_slot, reject=m.reject
            )
            return True
        if t == MT.NOOP:
            self._stage_row(g, k, MSG.NOOP, from_slot=from_slot, term=m.term)
            return True
        return False

    def _handle_install_snapshot(self, lane: _Lane, m: Message) -> None:
        ss = m.snapshot
        node = lane.node
        if ss is None or ss.is_empty():
            return
        applied = node.sm.last_applied_index()
        if ss.index <= applied:
            # stale snapshot: ACK it (etcd TestRestoreIgnores semantics —
            # the scalar core does the same). A silent drop wedges the
            # sender: its remote stays parked in SNAPSHOT state waiting for
            # match >= snapshot index, it resends the same snapshot on the
            # feedback retry, and we'd drop that too, forever.
            node._send_message(
                Message(
                    type=MT.REPLICATE_RESP,
                    cluster_id=node.cluster_id,
                    to=m.from_,
                    from_=node.node_id(),
                    term=max(m.term, int(self._m_term[lane.g]),
                             lane.adopted_term),
                    log_index=applied,
                )
            )
            return
        if lane.recovering:
            return  # a restore is already in flight; the retry re-delivers
        lane.recovering = True
        # multi-step: a recovering lane leaves the on-device routing
        # table — routed traffic would advance kernel state the restore
        # is about to overwrite; the host path holds its messages instead
        self._routes_dirty = True
        # the restore ack must carry a term the sender will not drop as
        # stale; the kernel never sees this message (it is consumed host-
        # side), so remember the sender's term for the ack path
        # (cf. raft.go:1415-1449 term preamble)
        lane.adopted_term = max(lane.adopted_term, m.term)
        # the snapshot record is persisted (fsync) on the snapshot worker
        # right before recovery, NOT here: this is the engine loop thread,
        # and a monolithic install must not stall every other lane's
        # super-step cadence (the streamed-install watchdog bound)
        node._vec_install_record = ss
        lane.node._push_install_snapshot(ss)

    # --------------------------------------------------------------- decode
    def _decode(self, worked: Set[_Lane], packs, o: dict) -> None:
        """One engine step's host fan-out (the K=1 path): the decode
        phases run in the reference ordering over a single StepOutput.
        The phase bodies live in the _decode_* subfunctions so the
        multi-step super-step (_decode_super) can orchestrate the same
        code with its masked, per-inner-step inputs."""
        # the last decoded step for diagnostics: views of the pinned fetch
        # slot, valid until the slot's reuse two dispatches later
        self.last_output = o
        note_engine_steps(1)
        prof = self.profiler
        prof.start()
        self._decode_place(o, packs)
        self._refresh_mirrors(o)
        prof.end("place")
        # ---- phase 1: Replicate messages leave BEFORE the fsync ----------
        prof.start()
        self._decode_send_rep(o)
        prof.end("send_rep")
        # ---- phase 2: one batched fsynced write for every lane -----------
        prof.start()
        updates, lane_saves = build_save_updates(
            o, self._m_base, self._lane_by_g
        )
        self._commit_saves(updates, lane_saves)
        prof.end("save")
        # ---- phase 3: post-fsync sends (votes, responses, heartbeats) ----
        prof.start()
        self._decode_send_post(o)
        prof.end("send_resp")
        # ---- phase 4: hand committed entries to the RSM ------------------
        prof.start()
        self._decode_apply(o)
        prof.end("apply")
        # ---- phase 5: confirmed reads ------------------------------------
        prof.start()
        self._decode_reads(o)
        prof.end("reads")
        # ---- phase 6: maintenance ----------------------------------------
        prof.start()
        self._maintain(o)
        prof.end("maintain")

    def _decode_super(self, worked: Set[_Lane], packs, o: dict, pl: dict) -> None:
        """Decode one K-step super-step (the multi-step path): the
        host-only residue of every inner step, with device-routed
        traffic masked out of the send/response planes and its
        Replicate payload bytes replayed into the destination arenas.

        Phase ordering across the window:
          * place + phase-1 Replicates run per inner step IN ORDER (a
            cross-host Replicate of step t materializes its payload
            BEFORE step t+1's placements can conflict-truncate it);
          * the WAL save is ONE merged wave: every inner step's updates
            land in step order inside a single batched write + barrier,
            so responses of EVERY inner step leave only after the
            window's final — maximal — hard state is durable (the
            persist-before-ack invariant holds against a state at least
            as new as what each response reflects);
          * post-fsync sends, RSM apply and confirmed reads then run per
            inner step in order.
        """
        K = self._multi
        steps = []
        for t in range(K):
            ot = {k: v[t] for k, v in o.items()}
            plt = {k: v[t] for k, v in pl.items()}
            steps.append((ot, plt))
        self.last_output = steps[-1][0]
        note_engine_steps(K)
        prof = self.profiler
        st = self._sstats
        base = self._m_base
        lane_by_g = self._lane_by_g
        # ---- place + phase 1, per inner step in order --------------------
        for t, (ot, plt) in enumerate(steps):
            prof.start()
            # routed Replicates consumed by THIS inner step: acceptance
            # (rep_base) is in ot; the candidate plan was staged by the
            # previous inner step (or the previous super-step's last one)
            self._place_routed_reps(ot)
            self._decode_place(ot, packs if t == 0 else None)
            self._pending_rep_copies = self._routed_rep_plan(ot, plt)
            for kind in ("rep", "vote", "hb", "tn", "resp", "rir"):
                st["msgs_routed_device"] += int(plt[kind].sum())
            self._mask_routed(ot, plt)
            prof.end("place")
            prof.start()
            self._decode_send_rep(ot)
            prof.end("send_rep")
        self._refresh_mirrors(steps[-1][0])
        # ---- phase 2: ONE merged save wave for the whole window ----------
        prof.start()
        updates: List[Update] = []
        lane_saves: List[Tuple[_Lane, List[Entry], State]] = []
        for ot, _plt in steps:
            u, ls = build_save_updates(ot, base, lane_by_g)
            updates.extend(u)
            lane_saves.extend(ls)
        self._commit_saves(updates, lane_saves)
        prof.end("save")
        # ---- phases 3-5 per inner step in order --------------------------
        prof.start()
        for ot, _plt in steps:
            self._decode_send_post(ot)
        prof.end("send_resp")
        prof.start()
        for ot, _plt in steps:
            self._decode_apply(ot)
        prof.end("apply")
        prof.start()
        for ot, plt in steps:
            self._decode_reads(ot, skip_routed=plt["rir"])
        prof.end("reads")
        # ---- phase 6: maintenance on the window's final state ------------
        prof.start()
        self._maintain(steps[-1][0])
        prof.end("maintain")

    # ------------------------------------------------ multi-step routing
    def _rebuild_routes(self) -> None:
        """Recompute the on-device routing table (multi-step engine):
        for every active lane and peer slot, the co-hosted destination
        lane index and the window-base delta the kernel adds to
        index-valued fields. Conservative by construction — any
        condition the host delivery path special-cases (chaos drop
        hook, partitioned host, stopped node, in-flight snapshot
        restore, unknown peer) routes -1, so that traffic falls back to
        the host path and its exact semantics."""
        self._routes_dirty = False
        if self._multi <= 1:
            return
        route = self._np_route
        rdelta = self._np_rdelta
        route.fill(-1)
        rdelta.fill(0)
        if self._local_drop_hook is not None:
            return  # every co-hosted message must pass the chaos hook
        P = self.kcfg.peers
        base = self._m_base
        blocked = self._blocked_hosts
        with self._lanes_mu:
            lanes = list(self._lanes.values())
            rt = dict(self._route)
        for lane in lanes:
            if not lane.active or lane.node.stopped:
                continue
            if lane.key[0] in blocked:
                continue  # partitioned host: neither sends nor receives
            g = lane.g
            self_slot = lane.self_slot()
            for p, nid in lane.rev.items():
                if p == self_slot or p < 0 or p >= P:
                    continue
                if p in lane.wit_slots:
                    # witness peers stay on the host path: its senders
                    # strip payloads to METADATA (the zero-payload
                    # witness contract); the device route would copy
                    # full entries into the witness arena
                    continue
                dst = rt.get((lane.node.cluster_id, nid))
                if (
                    dst is None
                    or not dst.active
                    or dst.recovering
                    or dst.node.stopped
                    or dst.key[0] in blocked
                    # the router stamps a message with its sender's own
                    # slot: route only where the destination keeps the
                    # sender at that slot. A replica that joined as an
                    # empty member knows no peer until it applies the
                    # membership; the host path parks the sender on a
                    # free slot for it (`slot_of`), and a routed message
                    # would reach it from a slot it cannot answer
                    or dst.slots.get(lane.node.node_id()) != self_slot
                ):
                    continue
                route[g, p] = dst.g
                rdelta[g, p] = int(base[g] - base[dst.g])

    def _routed_rep_plan(self, o: dict, plan: dict) -> list:
        """Replay the kernel's deterministic inbox-slot assignment for
        this step's device-routed Replicates: [(dst_g, slot, src_lane,
        dst_lane, lo_real, hi_real)]. Replicate candidates come FIRST in
        the kernel's kind-major candidate order, so their per-destination
        slots are simply their rank among routed Replicates to the same
        destination in row-major (g, p) order — exactly what np.nonzero
        yields. The payload copy waits for the CONSUMING step's
        acceptance report (_place_routed_reps)."""
        rep = plan["rep"]
        gs, ps = np.nonzero(rep)
        if not gs.size:
            return []
        route = self._np_route
        base = self._m_base
        lane_by_g = self._lane_by_g
        out = []
        counts: Dict[int, int] = {}
        cols = zip(
            gs.tolist(),
            route[gs, ps].tolist(),
            base[gs].tolist(),
            o["send_prev_index"][gs, ps].tolist(),
            o["send_n_entries"][gs, ps].tolist(),
        )
        for g, d, b, prev, n in cols:
            slot = counts.get(d, 0)
            counts[d] = slot + 1
            if n <= 0:
                continue  # empty commit-refresh Replicate: no payload
            src = lane_by_g[g]
            dst = lane_by_g[d]
            if src is None or dst is None:
                continue
            lo = b + prev + 1
            out.append((d, slot, src, dst, lo, lo + n - 1))
        return out

    def _place_routed_reps(self, o: dict) -> None:
        """Payload placement for device-routed Replicates consumed by
        this inner step: the destination ACCEPTED the entries iff its
        rep_base for the (lane, slot) the kernel routed them into is
        nonzero — the same acceptance gate the host wire path applies
        before placing a Replicate's entries into the arena."""
        pend, self._pending_rep_copies = self._pending_rep_copies, []
        if not pend:
            return
        lane_by_g = self._lane_by_g
        rep_base = o["rep_base"]
        for d, slot, src, dst, lo, hi in pend:
            if lane_by_g[d] is not dst or not dst.active:
                continue  # lane recycled between super-steps
            if rep_base[d, slot] <= 0:
                continue  # rejected (or consumed by a stale-term drop)
            arena = dst.arena
            sa = src.arena
            for i in range(lo, hi + 1):
                e = sa.get(i)
                if e is not None:
                    arena[e.index] = e

    def _mask_routed(self, o: dict, plan: dict) -> None:
        """Clear device-routed candidates out of the send/response
        planes so the host fan-out only materializes Messages for
        traffic the kernel could NOT route (cross-host, overflowed,
        below-window). Builds new arrays — the fetched planes are views
        of the pinned fetch slot."""
        clr = (
            np.where(plan["rep"], SEND_REPLICATE, 0)
            | np.where(plan["vote"], SEND_VOTE_REQ, 0)
            | np.where(plan["hb"], SEND_HEARTBEAT, 0)
            | np.where(plan["tn"], SEND_TIMEOUT_NOW, 0)
        )
        o["send_flags"] = o["send_flags"] & ~clr
        o["resp_type"] = np.where(
            plan["resp"], np.int32(MSG.NONE), o["resp_type"]
        )

    # ----------------------------------------------------- decode phases
    def _decode_place(self, o: dict, packs) -> None:
        """Phase 0: payloads at device-assigned indexes (host-packed
        rows when ``packs`` is given, plus new-leader noop entries) and
        the per-step stats base count."""
        lane_by_g = self._lane_by_g
        base = self._m_base
        # lease read counters: per-step deltas from the kernel, folded
        # into the engine totals (numpy sums over planes the decode
        # already fetched — zero extra device syncs)
        self._lease_local += int(o["lease_served"].sum())
        self._lease_fb += int(o["lease_fallback"].sum())
        # on-device event-counter plane: one (G, CTR.COUNT) u32 delta
        # block per protocol step, accumulated where the events happened
        # (inside step_batch / the K-step super-step) and folded here into the
        # cumulative per-lane totals — the K>1 / device-routed regime
        # counts exactly like K=1 because the kernel counted it, not the
        # host decode
        self._ctr += o["counters"]
        # a copy: the fetched planes are views of a pinned slot that a
        # later fetch overwrites
        self._m_lease_ok = np.array(o["lease_ok"])
        # ---- phase 0: place payloads at device-assigned indexes ----------
        # columnar: ONE gather per StepOutput plane over every packed row,
        # then plain-python iteration (no per-element device reads)
        if packs:
            pk_lanes: List[_Lane] = []
            pk_ks: List[int] = []
            pk_infos: List[tuple] = []
            for lane, pack_info in packs.items():
                for k, info in pack_info.items():
                    pk_lanes.append(lane)
                    pk_ks.append(k)
                    pk_infos.append(info)
            pk_gs = [lane.g for lane in pk_lanes]
            place_cols = zip(
                pk_lanes,
                pk_infos,
                base[pk_gs].tolist(),
                o["prop_base"][pk_gs, pk_ks].tolist(),
                o["rep_base"][pk_gs, pk_ks].tolist(),
                o["resp_term"][pk_gs, pk_ks].tolist(),
                o["dropped_cc"][pk_gs].tolist(),
            )
            for lane, info, b, pbase, rbase, rterm, dcc in place_cols:
                kind = info[0]
                if kind == "prop":
                    ents = info[1]
                    if pbase > 0:
                        arena = lane.arena
                        for i, e in enumerate(ents):
                            e.index = b + pbase + i
                            e.term = rterm
                            arena[e.index] = e
                    else:
                        node = lane.node
                        for e in ents:
                            node.proposal_dropped(e)
                    lane.packed_pending = max(
                        0, lane.packed_pending - len(ents)
                    )
                elif kind == "cc":
                    ce, key = info[1], info[2]
                    if pbase > 0 and not dcc:
                        ce.index = b + pbase
                        ce.term = rterm
                        lane.arena[ce.index] = ce
                    else:
                        if pbase > 0:
                            # the kernel appended the entry with its cc bit
                            # stripped (single-pending invariant): it lives
                            # on as an empty noop entry (raft.go:1587-1606)
                            lane.arena[b + pbase] = Entry(
                                type=EntryType.APPLICATION,
                                index=b + pbase,
                                term=rterm,
                            )
                        lane.cc_inflight = False
                        lane.node.pending_config_change.apply(
                            key, rejected=True
                        )
                    lane.packed_pending = max(0, lane.packed_pending - 1)
                elif kind == "rep":
                    if rbase > 0:
                        arena = lane.arena
                        for e in info[1]:
                            arena[e.index] = e
        # new-leader noop entries can appear on ANY lane (tick elections)
        noop_gs = np.nonzero(o["noop_appended"])[0]
        if noop_gs.size:
            for g, noop_at, noop_term, b in zip(
                noop_gs.tolist(),
                o["noop_appended"][noop_gs].tolist(),
                o["noop_term"][noop_gs].tolist(),
                base[noop_gs].tolist(),
            ):
                lane = lane_by_g[g]
                if lane is None:
                    continue
                lane.arena[b + noop_at] = Entry(
                    type=EntryType.APPLICATION,
                    term=noop_term,
                    index=b + noop_at,
                )
        # ---- per-step stats: steps counter (the rest accumulates inline
        # on objects each phase already materializes — len() of the send
        # batches, counts inside loops that already run — so the stats
        # plane adds ZERO numpy reductions to the step)
        st = self._sstats
        st["steps"] += 1

    def _refresh_mirrors(self, o: dict) -> None:
        """Rebind the whole-G numpy protocol mirrors from a StepOutput
        and emit leader-change events for lanes whose (leader, term)
        moved. The multi-step path calls this ONCE per super-step with
        the window's final state: intermediate transitions inside the
        window collapse into one observed change (the mirrors are a
        per-sync snapshot plane, not a per-protocol-step event log)."""
        lane_by_g = self._lane_by_g
        st = self._sstats
        # ---- mirror refresh + leader-change events -----------------------
        new_leader = o["leader"]
        new_term = o["term"]
        changed = np.nonzero(
            ((new_leader != self._m_leader) | (new_term != self._m_term))
            & self._m_active
        )[0]
        # old leader column for the changed lanes, captured before the
        # rebind: distinguishes true LEADER transitions (which arm the
        # ticks_since_leader_change gauge) from term-only churn
        old_leader_changed = self._m_leader[changed]
        # the fetched arrays are views of a pinned slot that a later fetch
        # overwrites, and the mirrors are mutated by the activation/
        # reconcile paths: copy on rebind
        self._m_leader = np.array(new_leader)
        self._m_term = np.array(new_term)
        self._m_role = np.array(o["role"])
        self._m_quiesced = np.array(o["quiesced"])
        self._m_commit = o["commit_index"].astype(np.int64)
        self._m_last = o["last_index"].astype(np.int64)
        if changed.size:
            lead_n = elect_n = 0
            chg_tick = self.clock.tick
            for g, lslot, old_lslot, term in zip(
                changed.tolist(),
                new_leader[changed].tolist(),
                old_leader_changed.tolist(),
                new_term[changed].tolist(),
            ):
                lane = lane_by_g[g]
                if lane is None or not lane.active:
                    continue
                lead_n += 1
                if lslot != old_lslot:
                    # real leader transition (not term-only churn)
                    self._m_leader_change_tick[g] = chg_tick
                if lslot == 0:
                    # lane went leaderless: an election is underway
                    elect_n += 1
                lane.node._leader_event(lane.rev.get(lslot - 1, 0), term)
            st["leader_changes"] += lead_n
            st["elections_started"] += elect_n

    def _decode_send_rep(self, o: dict) -> None:
        """Phase 1: Replicate messages leave BEFORE the fsync."""
        st = self._sstats
        base = self._m_base
        lane_by_g = self._lane_by_g
        rep_sends = gather_replicate_sends(
            o, base, lane_by_g, self._fetch_from_log
        )
        st["msgs_replicate"] += len(rep_sends)
        self._dispatch_sends(rep_sends)

    def _commit_saves(self, updates, lane_saves) -> None:
        """Phase 2: one batched fsynced write wave + log-reader mirror
        append, in update order (a multi-step window passes every inner
        step's updates through ONE call, so conflict-truncation rewrites
        apply sequentially inside a single barrier)."""
        if updates:
            self._save_updates(updates, lane_saves)
        for lane, ents, state in lane_saves:
            if ents:
                lane.node.log_reader.append(ents)
                lane.arena.mark_saved(ents[-1].index)
            lane.node.log_reader.set_state(state)

    def _decode_send_post(self, o: dict) -> None:
        """Phase 3: post-fsync sends (votes, responses, heartbeats) plus
        the snapshot path for peers that fell behind the device window."""
        st = self._sstats
        base = self._m_base
        lane_by_g = self._lane_by_g
        post = gather_post_sends(o, base, lane_by_g)
        st["msgs_broadcast"] += len(post)
        resp_sends = gather_resp_sends(o, base, lane_by_g)
        st["msgs_resp"] += len(resp_sends)
        post.extend(resp_sends)
        self._dispatch_sends(post)
        # snapshot path for peers that fell behind the device window
        snap_gs, snap_ps = np.nonzero(o["send_flags"] & NEED_SNAPSHOT)
        if snap_gs.size:
            for g, p in zip(snap_gs.tolist(), snap_ps.tolist()):
                lane = lane_by_g[g]
                if lane is not None:
                    self._start_catchup(lane, p, o)

    def _decode_apply(self, o: dict) -> None:
        """Phase 4: hand committed entries to the RSM task workers."""
        st = self._sstats
        base = self._m_base
        lane_by_g = self._lane_by_g
        from ..rsm import Task

        apply_gs = np.nonzero(o["apply_from"])[0]
        if apply_gs.size:
            applied_n = lanes_n = 0
            t_commit = time.monotonic()  # one clock read for the step
            for g, b, af, at in zip(
                apply_gs.tolist(),
                base[apply_gs].tolist(),
                o["apply_from"][apply_gs].tolist(),
                o["apply_to"][apply_gs].tolist(),
            ):
                lane = lane_by_g[g]
                if lane is None or not lane.active:
                    continue
                ents, missing_at = lane.arena.get_run(b + af, b + at)
                if ents is None:
                    # the ring only spans the device window; a restart
                    # replays the WHOLE committed log through the SM, whose
                    # early entries live in the host log alone
                    ents = self._fetch_from_log(lane, b + af, b + at)
                    if ents is None:
                        _plog.errorf(
                            "%s missing entry %d for apply (arena+log)",
                            lane.node.describe(), missing_at,
                        )
                        continue
                if not ents:
                    continue
                lane.node.sm.task_queue.add(
                    Task(
                        cluster_id=lane.node.cluster_id,
                        node_id=lane.node.node_id(),
                        entries=ents,
                    )
                )
                self._m_applied_since[g] += len(ents)
                applied_n += len(ents)
                lanes_n += 1  # this lane really handed work to the RSM
                # committed + dispatched to the RSM: no longer mem pressure
                lane.arena.mark_applied(b + at)
                has_cc = False
                for e in ents:
                    if e.type == EntryType.CONFIG_CHANGE:
                        has_cc = True
                    lt = e.lat
                    if lt is not None and lt.t_commit == 0.0:
                        # sampled proposal reached quorum commit this step
                        lt.t_commit = t_commit
                        if lt.trace_id:
                            flight_recorder().record(
                                "quorum_commit",
                                cluster=lane.node.cluster_id,
                                node=lane.node.node_id(),
                                trace=lt.trace_id, index=e.index,
                            )
                if has_cc:
                    lane.cc_inflight = False
                self.set_task_ready(lane.key)
            st["entries_applied"] += applied_n
            st["lanes_commit_advanced"] += lanes_n

    def _decode_reads(self, o: dict, skip_routed=None) -> None:
        """Phase 5: confirmed reads. ``skip_routed`` (multi-step) marks
        ready-queue slots whose READ_INDEX_RESP the kernel already
        routed to the forwarding origin's co-hosted lane — the host
        must not send a duplicate."""
        base = self._m_base
        lane_by_g = self._lane_by_g
        rc = o["ready_count"]
        ready_gs = np.nonzero(rc)[0]
        if ready_gs.size:
            # flatten the (lane, slot<count) pairs, then gather columns
            ridx = np.arange(o["ready_ctx"].shape[1])
            rrow, ris = np.nonzero(ridx[None, :] < rc[ready_gs, None])
            sel = ready_gs[rrow]
            read_sends: List[Tuple[_Lane, Message]] = []
            applied_lanes: Dict[_Lane, None] = {}
            for g, _slot, b, enc_lo, enc_hi, dev_idx, term in zip(
                sel.tolist(),
                ris.tolist(),
                base[sel].tolist(),
                o["ready_ctx"][sel, ris].tolist(),
                o["ready_ctx2"][sel, ris].tolist(),
                o["ready_index"][sel, ris].tolist(),
                # the confirming lane's own end-of-step term (== the
                # refreshed _m_term mirror on the K=1 path)
                o["term"][sel].tolist(),
            ):
                lane = lane_by_g[g]
                if lane is None or not lane.active:
                    continue
                node = lane.node
                applied_lanes[lane] = None
                if skip_routed is not None and skip_routed[g, _slot]:
                    continue  # kernel already routed this response
                enc = (enc_lo, enc_hi)
                idx = b + dev_idx
                origin = _ctx_origin(enc_lo)
                if origin == lane.self_slot():
                    ctx = lane.ri_pending.pop(enc, None)
                    if ctx is not None:
                        node.pending_read_indexes.add_ready_to_read(
                            [ReadyToRead(index=idx, system_ctx=ctx)]
                        )
                else:
                    to_nid = lane.rev.get(origin)
                    if to_nid is not None:
                        read_sends.append(
                            (
                                lane,
                                Message(
                                    type=MT.READ_INDEX_RESP,
                                    cluster_id=node.cluster_id,
                                    to=to_nid,
                                    from_=node.node_id(),
                                    term=term,
                                    log_index=idx,
                                    hint=enc_lo,
                                    hint_high=enc_hi,
                                ),
                            )
                        )
            self._dispatch_sends(read_sends)
            for lane in applied_lanes:
                lane.node.pending_read_indexes.applied(
                    lane.node.sm.last_applied_index()
                )

    def _dispatch_sends(self, sends: List[Tuple["_Lane", Message]]) -> None:
        """Hand a decode phase's (lane, Message) batch to each owning
        node's bulk send path: one co-hosted delivery pass plus one grouped
        wire send per node, instead of a queue hop per message. Relative
        order within the batch is preserved per destination."""
        if not sends:
            return
        # "deliver" sub-span: the bulk send/deliver seam's share of the
        # enclosing send/apply/reads phase (sampled iterations only — the
        # off path pays no clock reads)
        prof = self.profiler
        t0 = time.monotonic() if prof.sampling else 0.0
        by_node: Dict[object, List[Message]] = {}
        for lane, m in sends:
            node = lane.node
            lst = by_node.get(node)
            if lst is None:
                lst = by_node[node] = []
            lst.append(m)
        for node, msgs in by_node.items():
            many = node._send_messages
            if many is not None:
                many(msgs)
            else:
                send = node._send_message
                for m in msgs:
                    send(m)
        if prof.sampling:
            prof.add("deliver", time.monotonic() - t0)

    def _save_updates(self, updates: List[Update], lane_saves) -> None:
        """One multi-group write wave per step: a single write-batch per
        touched logdb shard with the durability barrier deferred, then one
        parallel sync over every touched WAL — group commit across shards
        AND across co-hosted NodeHosts' logdbs (a shared core hosts lanes
        from several hosts, each with its own WAL)."""
        if self._next_host <= 1:
            self._logdb.save_raft_state(updates)
            return
        if len(lane_saves) == 1:
            lane_saves[0][0].node.logdb.save_raft_state(updates)
            return
        by_db: Dict[int, tuple] = {}
        for (lane, _e, _s), ud in zip(lane_saves, updates):
            db = lane.node.logdb
            ent = by_db.get(id(db))
            if ent is None:
                ent = by_db[id(db)] = (db, [])
            ent[1].append(ud)
        pending = []
        for db, uds in by_db.values():
            deferred = getattr(db, "save_raft_state_deferred", None)
            if deferred is not None:
                pending.extend(deferred(uds))
            else:
                db.save_raft_state(uds)
        _kv_sync_all(pending)

    def _fetch_from_log(self, lane: _Lane, lo: int, hi: int):
        """Contiguous [lo, hi] from the host log (the arena ring's backing
        tier); None if the log cannot serve the whole range."""
        try:
            ents = lane.node.log_reader.entries(lo, hi + 1, 1 << 30)
        except Exception:
            return None
        if (
            len(ents) != hi - lo + 1
            or (ents and (ents[0].index != lo or ents[-1].index != hi))
        ):
            return None
        return ents
    # ------------------------------------------------------ catchup path
    def _below_window_reject(self, lane: _Lane, p: int, m: Message) -> None:
        """A reject whose hint is below the device window base: replicate
        the gap from the host log (or ship a snapshot), with the device
        remote parked so it stops probing indexes the follower cannot
        match. The park watermark is base+1: the first ack at or above the
        window base un-parks it and device replication takes over."""
        g = lane.g
        cu = lane.catchup.get(p)
        if cu is not None:
            # a catch-up Replicate met a log that ends below it (a message
            # lost on the way, or a suffix that does not match): resume
            # from the follower's last index, as the reject's hint says
            cu[0], cu[2] = m.hint + 1, m.hint
            return
        if p in lane.snap_inflight:
            return  # recovery already running for this peer
        if int(self._m_role[g]) != ROLE.LEADER:
            return
        b = int(self._m_base[g])
        s, _resid, row, ctx = self._lane_rows(g)
        with ctx:
            s.rstate[row, p] = RSTATE.SNAPSHOT
            s.snap_sent[row, p] = 1
        start = m.hint + 1
        goal = self._last_real(g)
        first, last = lane.node.log_reader.get_range()
        if start >= first and start <= last + 1:
            lane.catchup[p] = [start, goal, m.hint, self.clock.tick]
            self._catchups.add(lane)
        else:
            self._send_snapshot(lane, p)

    def _start_catchup(self, lane: _Lane, p: int, o) -> None:
        """A peer's next index fell behind the device window. If the host
        log still has the entries, replicate them host-side (the device has
        parked the peer in SNAPSHOT state; ReplicateResps move match and the
        kernel un-parks it once caught). Otherwise stream a real snapshot
        (cf. raft.go:774-785)."""
        if p in lane.catchup:
            return
        g = lane.g
        b = int(self._m_base[g])
        goal = b + int(o["last_index"][g])
        match = b + int(o["match"][g, p])
        start = match + 1
        first, last = lane.node.log_reader.get_range()
        if start >= first and start <= last + 1:
            # [next_to_send, goal, the follower's match as the host knows
            #  it, tick of the last send or progress]
            lane.catchup[p] = [start, goal, match, self.clock.tick]
            self._catchups.add(lane)
        else:
            # the follower needs entries the host log no longer has
            # (compacted behind a snapshot): only a snapshot can help
            self._send_snapshot(lane, p)

    def _send_snapshot(self, lane: _Lane, p: int) -> None:
        to_nid = lane.rev.get(p)
        if to_nid is None:
            return
        ss = lane.node.snapshotter.get_most_recent_snapshot()
        if ss is None or ss.is_empty():
            ss = lane.node.log_reader.snapshot()
        if ss is None or ss.is_empty():
            _plog.warningf(
                "%s peer %d needs a snapshot but none exists",
                lane.node.describe(), to_nid,
            )
            # still arm the feedback timer: the synthetic reject will
            # un-park the peer so host-log replication retries instead of
            # wedging it in SNAPSHOT state
            lane.snap_inflight[p] = (self.clock.tick, 0)
            self._snapfb.add(lane)
            return
        if p in lane.wit_slots:
            # witnesses get a real (non-dummy) snapshot record with the
            # data payload stripped (cf. raft.go:699-707)
            ss = _make_witness_snapshot(ss)
        lane.node._send_message(
            Message(
                type=MT.INSTALL_SNAPSHOT,
                cluster_id=lane.node.cluster_id,
                to=to_nid,
                from_=lane.node.node_id(),
                term=int(self._m_term[lane.g]),
                snapshot=ss,
            )
        )
        # reconcile the device's parked-peer watermark to the snapshot
        # ACTUALLY sent (the kernel parked it at the leader's last index):
        # the remote un-parks once match >= snap_sent (remote.go:62-69,
        # 145-153), so the watermark must be reachable by restoring this
        # snapshot or the peer wedges in SNAPSHOT state forever
        g = lane.g
        dev_idx = max(int(ss.index - self._m_base[g]), 0)
        s, _resid, row, ctx = self._lane_rows(g)
        with ctx:
            s.snap_sent[row, p] = dev_idx
        lane.snap_inflight[p] = (self.clock.tick, ss.index)
        self._snapfb.add(lane)

    def _run_catchups(self, lane: _Lane, o) -> None:
        if not lane.catchup:
            self._catchups.discard(lane)
            return
        g = lane.g
        b = int(self._m_base[g])
        # a catch-up Replicate lost on the way (a drop, a partition) is
        # resent from the follower's match once two heartbeats pass with
        # neither a send nor an ack, as the device path re-probes on a
        # HeartbeatResp; only a host log that no longer holds the
        # follower's next entry calls for a snapshot (falling back to one
        # after a silence instead asked for a snapshot that need not
        # exist, then waited out the snapshot feedback's retry)
        resend_ticks = max(2 * lane.cfg.heartbeat_rtt, 4)
        tick = self.clock.tick
        done = []
        for p, cu in lane.catchup.items():
            nxt, goal, known, quiet_since = cu
            # the device keeps no match below the window base (0 there):
            # what the host knows of the follower stands in for it
            dm = int(o["match"][g, p])
            match = b + dm if dm > 0 else known
            if match >= goal or int(self._m_role[g]) != ROLE.LEADER:
                done.append(p)
                continue
            if match > known:
                cu[2], cu[3] = match, tick
            elif tick - quiet_since > resend_ticks:
                nxt = match + 1
            if match + 1 > nxt:
                nxt = match + 1
            first, last = lane.node.log_reader.get_range()
            if nxt < first:
                done.append(p)
                self._send_snapshot(lane, p)
                continue
            if nxt > last:
                continue  # wait for the follower to ack what's in flight
            hi = min(nxt + self.kcfg.max_entries_per_msg - 1, last, goal)
            try:
                ents = lane.node.log_reader.entries(nxt, hi + 1, 1 << 20)
                prev = nxt - 1
                prev_term = (
                    lane.node.log_reader.term(prev) if prev > 0 else 0
                )
            except Exception:
                done.append(p)
                self._send_snapshot(lane, p)
                continue
            if not ents:
                done.append(p)
                continue
            to_nid = lane.rev.get(p)
            if to_nid is None:
                done.append(p)
                continue
            if p in lane.wit_slots:
                # host catchup honors the witness shape too
                ents = _make_metadata_entries(ents)
            lane.node._send_message(
                Message(
                    type=MT.REPLICATE,
                    cluster_id=lane.node.cluster_id,
                    to=to_nid,
                    from_=lane.node.node_id(),
                    term=int(self._m_term[g]),
                    log_index=prev,
                    log_term=prev_term,
                    commit=min(self._committed_real(g), ents[-1].index),
                    entries=ents,
                )
            )
            cu[0], cu[3] = ents[-1].index + 1, tick
        for p in done:
            lane.catchup.pop(p, None)
        if not lane.catchup:
            self._catchups.discard(lane)

    def _run_snapshot_feedback(self, lane: _Lane, o) -> None:
        """Delayed snapshot-status retry (cf. feedback.go:38-128): an
        InstallSnapshot that is not acked within the retry window gets a
        synthetic SNAPSHOT_STATUS reject queued to the local lane. The
        kernel then moves the remote SNAPSHOT->WAIT (next=match+1); the
        following HeartbeatResp probes it, and replication — or another
        snapshot — retries. Without this, a snapshot lost to a partition
        wedges the remote in SNAPSHOT state forever."""
        if not lane.snap_inflight:
            self._snapfb.discard(lane)
            return
        g = lane.g
        b = int(self._m_base[g])
        retry_ticks = max(4 * lane.cfg.election_rtt, 16)
        is_leader = int(self._m_role[g]) == ROLE.LEADER
        done = []
        for p, (sent_tick, ss_index) in lane.snap_inflight.items():
            match = b + int(o["match"][g, p])
            if not is_leader or (ss_index > 0 and match >= ss_index):
                done.append(p)  # acked (or leadership moved on)
                continue
            if self.clock.tick - sent_tick > retry_ticks:
                done.append(p)
                from_nid = lane.rev.get(p)
                if from_nid is not None:
                    lane.node.mq.add(
                        Message(
                            type=MT.SNAPSHOT_STATUS,
                            cluster_id=lane.node.cluster_id,
                            to=lane.node.node_id(),
                            from_=from_nid,
                            reject=True,
                        )
                    )
                    self.set_node_ready(lane.key)
        for p in done:
            lane.snap_inflight.pop(p, None)
        if not lane.snap_inflight:
            self._snapfb.discard(lane)

    # --------------------------------------------------------- maintenance
    def _maintain(self, o) -> None:
        W = self.kcfg.log_window
        lane_by_g = self._lane_by_g
        for lane in list(self._catchups):
            self._run_catchups(lane, o)
        for lane in list(self._snapfb):
            self._run_snapshot_feedback(lane, o)
        # parked-peer watchdog: a remote in SNAPSHOT state whose host-side
        # recovery (catchup or snapshot feedback) is no longer tracked is
        # permanently wedged — the kernel only reports NEED_SNAPSHOT for
        # UNpaused peers, so nothing would ever re-arm it. Leadership races
        # (a catchup exiting on a stale goal, a feedback entry fast-acked
        # against an older snapshot watermark) can drop the tracker; this
        # sweep re-enters the recovery path. (cf. the reference's
        # unconditional snapshot-status feedback loop, feedback.go:38-128)
        parked = (o["rstate"] == RSTATE.SNAPSHOT) & (
            (o["role"] == ROLE.LEADER)[:, None]
        )
        for g, p in zip(*np.nonzero(parked)):
            lane = lane_by_g[g]
            if (
                lane is None
                or not lane.active
                or p in lane.catchup
                or p in lane.snap_inflight
            ):
                continue
            self._start_catchup(lane, int(p), o)
        # periodic snapshot by applied-entry count (node.go:585-601); a
        # wedged window forces one regardless of config. Candidates are
        # found vectorized; only triggering lanes cost Python.
        log_full = o["log_full"]
        snap_due = (
            self._m_active
            & ~self._m_snap_pending
            & (
                log_full
                | (
                    (self._m_snap_every > 0)
                    & (self._m_applied_since >= self._m_snap_every)
                )
            )
        )
        for g in np.nonzero(snap_due)[0].tolist():
            lane = lane_by_g[g]
            if lane is None or lane.node.snapshotter is None:
                continue
            applied, _ = lane.node.sm.get_last_applied()
            if applied > 0 and not lane.cfg.is_witness:
                self._m_snap_pending[g] = True
                self._m_applied_since[g] = 0
                from ..rsm import SSRequest

                lane.node.push_take_snapshot_request(SSRequest())
        # device window compaction: advance first_index once the window is
        # half full; applied entries are recoverable from the host log
        # (catchup path) or a snapshot, so the device needs neither
        used = o["last_index"].astype(np.int64) - self._m_devfirst + 1
        compact_due = self._m_active & ((used > W // 2) | log_full)
        adv_mask = np.zeros(self.kcfg.groups, bool)
        adv_first = np.zeros(self.kcfg.groups, np.int32)
        adv_term = np.zeros(self.kcfg.groups, np.int32)
        for g in np.nonzero(compact_due)[0].tolist():
            lane = lane_by_g[g]
            if lane is None:
                continue
            b = int(self._m_base[g])
            applied, applied_term = lane.node.sm.get_last_applied()
            target = min(applied, self._committed_real(g))
            if target + 1 > b + int(self._m_devfirst[g]):
                first_new = target - b + 1
                self._m_devfirst[g] = first_new
                adv_mask[g] = True
                adv_first[g] = first_new
                adv_term[g] = applied_term
        if adv_mask.any():
            # whole-G masked update in place: one shape whatever the number
            # of advancing lanes, shipped in one host->device copy (per
            # shard with advancing lanes when sharded)
            for sh, ctx, (m, f, t) in self._blocks(adv_mask, adv_first, adv_term):
                if not m.any():
                    continue
                with ctx:
                    adv = self._h2d(np.stack([m, f, t]).astype(np.int32), sh)
                    advance_compaction(sh.state, adv[0].bool(), adv[1], adv[2])
        if bool(np.any(o["last_index"] > _REBASE_THRESHOLD)):
            # never rebase under an in-flight step: the mirrors and the
            # pending output would disagree by the rebase delta. The
            # threshold leaves orders of magnitude more headroom than the
            # one extra step this defers by.
            self._rebase_due = True

    def _do_rebase(self) -> None:
        """Shift device indexes down so they never near 2**31. The delta is
        a multiple of W (ring-slot invariant, cf. ops/state.rebase)."""
        W = self.kcfg.log_window
        G = self.kcfg.groups
        delta = np.zeros((G,), np.int32)
        with self._lanes_mu:
            lanes = [ln for ln in self._lanes.values() if ln.active]
        for lane in lanes:
            g = lane.g
            d = int((self._m_devfirst[g] - 1) // W) * W
            if d > 0:
                delta[g] = d
                self._m_base[g] += d
                self._m_devfirst[g] -= d
                self._m_commit[g] -= d
                self._m_last[g] -= d
        if delta.any():
            # window bases moved: the routing table's per-peer base
            # deltas must be recomputed before the next dispatch
            self._routes_dirty = True
            for sh, ctx, (d, parked) in self._blocks(delta, self._m_resid):
                if not d.any():
                    continue
                with ctx:
                    # the device-resident residual inbox carries indexes
                    # in DESTINATION units: with parked messages, the same
                    # launch shifts the index-valued fields of each by its
                    # destination lane's delta (type-aware, mirroring
                    # which fields _pack_wire stages per message type)
                    resid = sh.resid if self._multi > 1 and parked.any() else None
                    sh.state = rebase_lanes(sh.state, self._h2d(d, sh), resid)

    # ----------------------------------------------------------- reconciles
    def _apply_reconciles(self) -> None:
        batch: List[_Lane] = []
        cc_clear: List[int] = []
        while True:
            try:
                op = self._reconq.popleft()
            except IndexError:
                break
            if op[0] == "activate":
                batch.append(op[1])
                continue
            if op[0] == "cc_done":
                # batched below: one fixed-shape mask op instead of a
                # per-lane scatter (bootstrap emits one per cluster)
                lane = self._lane_of(op[1])
                if lane is not None and lane.active:
                    cc_clear.append(lane.g)
                    lane.cc_inflight = False
                continue
            if batch:
                self._activate_batch(batch)
                batch = []
            try:
                kind = op[0]
                if kind == "barrier":
                    op[1].set()
                elif kind == "deactivate":
                    self._deactivate(op[1])
                elif kind == "membership":
                    self._reconcile_membership(op[1])
                elif kind == "restore":
                    self._reconcile_restore(op[1], op[2])
                elif kind == "recover_done":
                    lane = self._lane_of(op[1])
                    if lane is not None:
                        lane.recovering = False
                        self._routes_dirty = True
            except Exception:
                import traceback

                traceback.print_exc()
        if batch:
            self._activate_batch(batch)
        if cc_clear:
            mask = np.zeros((self.kcfg.groups,), bool)
            mask[cc_clear] = True
            for sh, ctx, (m,) in self._blocks(mask):
                if m.any():
                    with ctx:
                        clear_pending_cc(sh.state, self._h2d(m, sh))

    def _lane_of(self, node) -> Optional[_Lane]:
        lane = node._vec_lane
        if lane is None:
            return None
        with self._lanes_mu:
            return lane if self._lanes.get(lane.key) is lane else None

    def _compute_activation(self, lane: _Lane) -> Optional[dict]:
        """Host-side half of lane bring-up: bootstrap (initial start),
        restart replay, or join-as-empty. Mirrors Peer.launch +
        node.replayLog (cf. core/peer.py:75-94, node.go:553-583). Returns
        the per-field device values for the batched scatter."""
        node = lane.node
        node.recover_initial_snapshot()
        cfg = lane.cfg
        g = lane.g
        W = self.kcfg.log_window
        P = self.kcfg.peers
        # membership sources: SM image (restart w/ snapshot) else bootstrap
        mem = node.sm.get_membership()
        member_ids = set(mem.addresses) | set(mem.observers) | set(mem.witnesses)
        if not member_ids:
            member_ids = {a.node_id for a in node._vec_addresses}
        bootstrap = node._vec_initial and node._vec_new_node
        lane.set_slots(member_ids)
        self_slot = lane.self_slot()
        if self_slot < 0 and node.node_id() not in lane.slots:
            # join path: self not yet in membership; park on a free slot
            self_slot = lane.slot_of(node.node_id(), provisional=True)
        obs_ids = set(mem.observers)
        wit_ids = set(mem.witnesses)
        if not mem.addresses and bootstrap:
            obs_ids, wit_ids = set(), set()
        lane.mem_sig = (
            frozenset(member_ids), frozenset(obs_ids), frozenset(wit_ids)
        )
        # persisted protocol state
        st = self._logdb_state(node)
        snap = node.snapshotter.get_most_recent_snapshot() if node.snapshotter else None
        snap_index = snap.index if snap is not None and not snap.is_empty() else 0
        first, last = node.log_reader.get_range()
        ents: List[Entry] = []
        if last >= first and last > 0:
            try:
                ents = node.log_reader.entries(first, last + 1, 1 << 30)
            except Exception:
                ents = []
        term = st.term
        vote_nid = st.vote
        committed = st.commit
        if bootstrap and not ents:
            # initial start: membership enters the log as config-change
            # entries at term 1, committed immediately (core/peer.py:273-294)
            addrs = sorted(node._vec_addresses, key=lambda a: a.node_id)
            from ..types import ConfigChange, ConfigChangeType

            for i, pa in enumerate(addrs):
                cc = ConfigChange(
                    type=ConfigChangeType.ADD_NODE,
                    node_id=pa.node_id,
                    initialize=True,
                    address=pa.address,
                )
                ents.append(
                    Entry(
                        type=EntryType.CONFIG_CHANGE,
                        term=1,
                        index=i + 1,
                        cmd=encode_config_change(cc),
                    )
                )
            committed = len(ents)
            term = max(term, 1)
        elif node._vec_new_node and not cfg.is_observer and not cfg.is_witness:
            term = max(term, 1)
        b = snap_index
        last_real = ents[-1].index if ents else max(snap_index, last if last else 0)
        dev_last = max(last_real - b, 0)
        dev_first = max(dev_last - W + 1, 1)
        committed = max(committed, snap_index)
        # ring metadata from the replayed entries
        ring_terms = np.zeros((W,), np.int32)
        ring_cc = np.zeros((W,), bool)
        for e in ents:
            lane.arena[e.index] = e
            di = e.index - b
            if dev_first <= di <= dev_last:
                ring_terms[di % W] = e.term
                ring_cc[di % W] = e.type == EntryType.CONFIG_CHANGE
        # the replayed entries come from the log: all saved
        lane.arena.mark_saved(ents[-1].index if ents else 0)
        # arena holds nothing at or below the snapshot: seed the applied
        # watermark there directly (no entries below it to discount) so
        # the first phase-4 mark_applied walks the window, not the whole
        # history from zero
        lane.arena.applied = max(snap_index, lane.arena.applied)
        marker = dev_first - 1
        if marker == 0:
            marker_term = snap.term if snap_index and b == snap_index else 0
        else:
            try:
                marker_term = node.log_reader.term(b + marker)
            except Exception:
                marker_term = 0
        member = np.zeros((P,), bool)
        voting = np.zeros((P,), bool)
        observer = np.zeros((P,), bool)
        witness = np.zeros((P,), bool)
        for nid, slot in lane.slots.items():
            if slot >= P or nid not in member_ids:
                # provisional parkings (the join path parks self and
                # learned senders on free slots) are NOT members: marking
                # them voting would let an empty-membership join lane
                # self-elect as a one-node group and poison its log
                continue
            member[slot] = True
            if nid in obs_ids:
                observer[slot] = True
            elif nid in wit_ids:
                witness[slot] = True
                voting[slot] = True
            else:
                voting[slot] = True
        lane.wit_slots = frozenset(np.nonzero(witness)[0].tolist())
        role = (
            ROLE.OBSERVER if cfg.is_observer
            else ROLE.WITNESS if cfg.is_witness
            else ROLE.FOLLOWER
        )
        vote_slot = lane.slots.get(vote_nid, -1)
        et = max(cfg.election_rtt, 3)
        hb = max(cfg.heartbeat_rtt, 1)
        from ..ops.state import _mix

        rand_to = et + _mix(lane_seed(g), term, max(self_slot, 0)) % et
        # quiesce threshold: 10x the election timeout (cf. quiesce.go:84-86)
        quiesce_on = bool(cfg.quiesce)
        quiesce_threshold = 10 * et
        # ---- numpy mirrors ------------------------------------------------
        self._m_base[g] = b
        self._m_devfirst[g] = dev_first
        self._m_term[g] = term
        self._m_role[g] = role
        self._m_leader[g] = 0
        self._m_commit[g] = committed - b
        self._m_last[g] = dev_last
        # catch-up burst cap: at most this many coalesced ticks apply in
        # one kernel step; the rest of a stall's backlog is shed. The old
        # cap (election RTT) let a single post-stall step add
        # `election_rtt` ticks — every follower lane crossed rand_timeout
        # ∈ [et, 2et) within two steps simultaneously, collapsing the
        # randomized election spread into synchronized split-vote storms
        # (the ROADMAP seed flake). Capping at the heartbeat RTT keeps
        # timers advancing while a live leader's next heartbeat can still
        # land between bursts.
        burst = self._catchup_tick_cap or hb
        self._m_tick_cap[g] = max(1, min(cfg.election_rtt, burst))
        self._m_active[g] = True
        self._m_snap_every[g] = cfg.snapshot_entries
        self._m_applied_since[g] = 0
        self._ctr[g] = 0  # a reused lane must not inherit event counters
        self._m_snap_pending[g] = False
        self._m_quiesced[g] = False  # a reused lane must not inherit this
        self._m_leader_change_tick[g] = self.clock.tick
        return dict(
            self_slot=max(self_slot, 0),
            member=member,
            voting=voting,
            observer=observer,
            witness=witness,
            term=term,
            vote=vote_slot + 1 if vote_slot >= 0 else 0,
            role=role,
            election_timeout=et,
            heartbeat_timeout=hb,
            rand_timeout=rand_to,
            check_quorum=cfg.check_quorum,
            prevote_on=bool(cfg.pre_vote),
            lease_on=bool(cfg.lease_read),
            lease_margin=cfg.lease_margin_ticks() if cfg.lease_read else 0,
            first_index=dev_first,
            marker_term=marker_term,
            last_index=dev_last,
            committed=committed - b,
            processed=max(snap_index - b, 0),
            applied=max(snap_index - b, 0),
            unsaved_from=1 if bootstrap else dev_last + 1,
            log_term=ring_terms,
            log_is_cc=ring_cc,
            next=dev_last + 1,
            quiesce_on=quiesce_on,
            quiesce_threshold=quiesce_threshold,
        )

    # the per-lane value columns and rows of an activation batch
    # (ops/cuda.py:ACT_COLUMNS, ACT_ROWS) with their numpy types: what a
    # batch's values are built from outside the engine (tests, chip_smoke)
    _ACT_COLS = tuple((k, bool if dt == torch.bool else np.int32) for k, dt in ACT_COLUMNS)
    _ACT_MATS = tuple((k, bool if dt == torch.bool else np.int32) for k, dt in ACT_ROWS)

    def _h2d(self, a: np.ndarray, sh: _Shard) -> torch.Tensor:
        """A host array on shard sh's device, under its stream context. On
        the card the bytes are staged in pinned memory and copied
        asynchronously on the current stream (the pinned block is not
        reused before the copy ran), so the rare-path writes never wait for
        the step in flight."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not self._cuda:
            return t.clone()
        return t.pin_memory().to(sh.device, non_blocking=True)

    def _activate_batch(self, lanes: List[_Lane]) -> None:
        """Activate many lanes in ONE batch per shard (_activate_rows: one
        packed copy and one activate_packed) — the engine analogue of
        ops/state.configure_groups_uniform. Batches pad to power-of-4
        buckets, as the JAX package does to bound its compile cache."""
        vals: List[dict] = []
        gs: List[int] = []
        for lane in lanes:
            try:
                v = self._compute_activation(lane)
            except Exception:
                import traceback

                traceback.print_exc()
                continue
            if v is not None:
                vals.append(v)
                gs.append(lane.g)
                lane.active = True
        if not vals:
            return
        # one batch per shard that holds lanes of this one, in its rows
        Gl = self._shards[0].hi
        by_shard: Dict[int, Tuple[list, list]] = {}
        for g, v in zip(gs, vals):
            rows, vs = by_shard.setdefault(g // Gl, ([], []))
            rows.append(g % Gl)
            vs.append(v)
        for i, (rows, vs) in sorted(by_shard.items()):
            self._activate_rows(self._shards[i], rows, vs)
        self._routes_dirty = True
        self._ready.set()

    def _activate_rows(self, sh: _Shard, rows: List[int], vals: List[dict]) -> None:
        """One activation batch into shard sh's state tree (`rows` are lane
        rows of that shard): the rows and values packed into ONE host
        buffer (ops/cuda.py:activation_layout), on the card pinned and
        copied once to the shard's device on its stream, then one
        activate_packed."""
        bucket = activation_bucket(len(vals), sh.hi - sh.lo)
        packed = pack_activation(rows, vals, bucket, self.kcfg.peers, self.kcfg.log_window)
        with sh.on():
            if self._cuda:
                # one pinned copy of the buffer, one async copy to the card;
                # the pinned block is not handed out again before it ran
                packed = packed.pin_memory().to(sh.device, non_blocking=True)
            activate_packed(sh.state, packed, bucket)

    def _logdb_state(self, node) -> State:
        st, _ = node.log_reader.node_state()
        return st if st is not None else State()

    def _deactivate(self, lane: _Lane) -> None:
        g = lane.g
        with self._lanes_mu:
            if self._lane_by_g[g] is not lane:
                # already reaped (a double remove_node, or a crash path
                # racing a graceful stop): freeing g twice would hand the
                # same lane index to two tenants
                return
        state, resid, row, ctx = self._lane_rows(g)
        with ctx:
            write_lane_rows(state, row, {"active": False})
        lane.active = False
        # zero the freed lane's host planes so nothing leaks into the next
        # tenant of g: the inbox staging rows of BOTH buffer sets (the
        # overlap pipeline alternates sets; the next occupant must never
        # see a stale row where _pack left data the kernel has already
        # consumed), the pending-tick row, and every protocol mirror
        # (lane_stats/decode gate on _m_active, but stale bases would
        # corrupt the first reads after a mis-gated access)
        for buf, ticks, _inbox, _host in self._bufsets:
            for name, plane in buf.items():
                plane[g] = MSG.NONE if name == "mtype" else 0
            ticks[g] = 0
        self._m_base[g] = 0
        self._m_devfirst[g] = 1
        self._m_term[g] = 0
        self._m_role[g] = ROLE.FOLLOWER
        self._m_leader[g] = 0
        self._m_commit[g] = 0
        self._m_last[g] = 0
        self._m_tick_cap[g] = 1
        self._m_active[g] = False
        self._m_snap_every[g] = 0
        self._m_applied_since[g] = 0
        self._m_snap_pending[g] = False
        self._m_quiesced[g] = False
        self._m_host[g] = 0
        self._m_leader_change_tick[g] = 0
        self._ctr[g] = 0
        self._carry.discard(lane)
        self._catchups.discard(lane)
        self._snapfb.discard(lane)
        # multi-step: the freed lane must not hand its device-routed
        # residual rows or pending payload copies to the next tenant
        self._m_resid[g] = 0
        if self._multi > 1:
            with self._shard_of(g).on():
                write_lane_rows(resid, row, {"mtype": MSG.NONE})
            self._pending_rep_copies = [
                c
                for c in self._pending_rep_copies
                if c[2] is not lane and c[3] is not lane
            ]
        self._routes_dirty = True
        lane.node._vec_lane = None
        with self._lanes_mu:
            self._lane_by_g[g] = None
            self._free.append(g)

    def _reconcile_membership(self, node) -> None:
        """Recompute the canonical slot mapping from the applied membership
        image and permute the per-peer device state accordingly."""
        lane = self._lane_of(node)
        if lane is None or not lane.active:
            return
        mem = node.sm.get_membership()
        member_ids = set(mem.addresses) | set(mem.observers) | set(mem.witnesses)
        if not member_ids:
            return
        sig = (
            frozenset(member_ids),
            frozenset(mem.observers),
            frozenset(mem.witnesses),
        )
        if sig == lane.mem_sig:
            return  # image unchanged (bootstrap CCs restate membership)
        lane.mem_sig = sig
        P = self.kcfg.peers
        g = lane.g
        perm = lane.set_slots(member_ids)
        # the lane's shard and its row there when sharded: every device op
        # of this reconcile runs on that shard's stream
        s, _resid, r, ctx = self._lane_rows(g)
        # the lane's current per-peer rows and reference scalars in ONE
        # device->host read (a membership change is a rare path)
        i32 = torch.int32
        with ctx:
            host = torch.cat([
                s.match[r], s.next[r], s.rstate[r], s.snap_sent[r],
                s.ract[r].to(i32), s.vresp[r].to(i32), s.vgrant[r].to(i32),
                torch.stack([s.last_index[r], s.leader[r], s.vote[r],
                             s.transfer_to[r]]),
            ]).cpu().numpy()
        cur = {
            name: host[i * P:(i + 1) * P]
            for i, name in enumerate((
                "match", "next", "rstate", "snap_sent", "ract", "vresp",
                "vgrant",
            ))
        }
        for name in ("ract", "vresp", "vgrant"):
            cur[name] = cur[name].astype(bool)
        cur_last, cur_leader, cur_vote, cur_transfer = host[7 * P:].tolist()

        # permute [P]-indexed rows: value at old slot moves to new slot
        def permute_row(row, default):
            vals = np.asarray(row)
            out = np.full_like(vals, default)
            for old, new in perm.items():
                if old < P and new < P:
                    out[new] = vals[old]
            return out

        member = np.zeros((P,), bool)
        voting = np.zeros((P,), bool)
        observer = np.zeros((P,), bool)
        witness = np.zeros((P,), bool)
        for nid, slot in lane.slots.items():
            if slot >= P:
                continue
            member[slot] = True
            if nid in mem.observers:
                observer[slot] = True
            elif nid in mem.witnesses:
                witness[slot] = True
                voting[slot] = True
            else:
                voting[slot] = True
        lane.wit_slots = frozenset(np.nonzero(witness)[0].tolist())
        dev_last = int(cur_last)
        match = permute_row(cur["match"], 0)
        nxt = permute_row(cur["next"], dev_last + 1)
        nxt = np.maximum(nxt, 1)
        rstate = permute_row(cur["rstate"], RSTATE.RETRY)
        ract = permute_row(cur["ract"], False)
        snap_sent = permute_row(cur["snap_sent"], 0)
        vresp = permute_row(cur["vresp"], False)
        vgrant = permute_row(cur["vgrant"], False)

        def remap_ref(v):
            # slot+1 encoded references (leader/vote/transfer)
            v = int(v)
            if v <= 0:
                return 0
            new = perm.get(v - 1)
            return new + 1 if new is not None else 0

        self_slot = lane.self_slot()
        if self_slot < 0:
            self_slot = lane.slot_of(node.node_id(), provisional=True)
        new_leader = remap_ref(cur_leader)
        with self._shard_of(g).on():
            # self-promotion: an observer added as a full member becomes a
            # follower in place, inheriting its replicated log (cf. raft.go
            # addNode / scalar Raft.add_node become_follower path)
            if (
                int(self._m_role[g]) == ROLE.OBSERVER
                and node.node_id() in mem.addresses
            ):
                self._m_role[g] = ROLE.FOLLOWER
                write_lane_rows(s, r, {"role": ROLE.FOLLOWER})
            # the new per-peer rows in ONE host->device copy
            names = ("member", "voting", "observer", "witness", "match", "next",
                     "rstate", "ract", "snap_sent", "vresp", "vgrant")
            vals = (member, voting, observer, witness, match, nxt, rstate, ract,
                    snap_sent, vresp, vgrant)
            dev = self._h2d(np.stack([np.asarray(x, np.int32) for x in vals]),
                            self._shard_of(g))
            rows = {
                name: dev[i].to(getattr(s, name).dtype)
                for i, name in enumerate(names)
            }
            rows.update(
                self_slot=max(self_slot, 0),
                leader=new_leader,
                vote=remap_ref(cur_vote),
                transfer_to=remap_ref(cur_transfer),
                # ack bitmasks are slot-indexed: clear and let heartbeats
                # re-confirm (membership changes are rare)
                ri_acks=0,
            )
            write_lane_rows(s, r, rows)
        self._m_leader[g] = new_leader
        # catchup/snapshot-feedback mirrors use slots: remap
        remapped = {}
        for p, v in lane.catchup.items():
            if p in perm:
                remapped[perm[p]] = v
        lane.catchup = remapped
        if not lane.catchup:
            self._catchups.discard(lane)
        lane.snap_inflight = {
            perm[p]: v for p, v in lane.snap_inflight.items() if p in perm
        }
        if not lane.snap_inflight:
            self._snapfb.discard(lane)
        # the slot mapping changed: rebuild the on-device routing rows
        self._routes_dirty = True

    def _reconcile_restore(self, node, ss: Snapshot) -> None:
        """An InstallSnapshot finished recovering: rebuild the lane at the
        snapshot point (cf. raft.go:439-517 restore + restoreRemotes)."""
        lane = self._lane_of(node)
        if lane is None:
            return
        with node._mu:
            node.log_reader.apply_snapshot(ss)
        g = lane.g
        P = self.kcfg.peers
        mem = ss.membership or node.sm.get_membership()
        member_ids = set(mem.addresses) | set(mem.observers) | set(mem.witnesses)
        lane.set_slots(member_ids)
        lane.mem_sig = (
            frozenset(member_ids),
            frozenset(mem.observers),
            frozenset(mem.witnesses),
        )
        lane.arena = _Arena(self.kcfg.log_window)
        # everything at or below the installed snapshot is applied; seeding
        # the watermark keeps the next phase-4 mark_applied from walking
        # the whole history from zero (same as the activation path)
        lane.arena.applied = max(ss.index, 0)
        lane.arena.saved = max(ss.index, 0)
        lane.catchup = {}
        lane.snap_inflight = {}
        self._catchups.discard(lane)
        self._snapfb.discard(lane)
        member = np.zeros((P,), bool)
        voting = np.zeros((P,), bool)
        observer = np.zeros((P,), bool)
        witness = np.zeros((P,), bool)
        for nid, slot in lane.slots.items():
            if slot >= P:
                continue
            member[slot] = True
            if nid in mem.observers:
                observer[slot] = True
            elif nid in mem.witnesses:
                witness[slot] = True
                voting[slot] = True
            else:
                voting[slot] = True
        lane.wit_slots = frozenset(np.nonzero(witness)[0].tolist())
        self_slot = lane.self_slot()
        if self_slot < 0:
            self_slot = lane.slot_of(node.node_id(), provisional=True)
        s, _resid, r, ctx = self._lane_rows(g)
        with ctx:
            # the lane may carry the snapshot sender's (higher) term, adopted
            # in _handle_install_snapshot; the restore ack must not be
            # droppable as stale by the leader
            term = max(int(s.term[r].item()), ss.term, lane.adopted_term)
            lane.adopted_term = 0
            dev = self._h2d(np.stack([member, voting, observer, witness]),
                            self._shard_of(g))
            write_lane_rows(s, r, dict(
                member=dev[0],
                voting=dev[1],
                observer=dev[2],
                witness=dev[3],
                self_slot=max(self_slot, 0),
                term=term,
                first_index=1,
                marker_term=ss.term,
                last_index=0,
                committed=0,
                processed=0,
                applied=0,
                unsaved_from=1,
                log_term=0,
                log_is_cc=False,
                match=0,
                next=1,
                rstate=RSTATE.RETRY,
                snap_sent=0,
                ri_ctx=0,
                ri_index=0,
                ri_acks=0,
                ri_count=0,
            ))
        # ---- numpy mirrors ------------------------------------------------
        self._m_base[g] = ss.index
        self._m_devfirst[g] = 1
        self._m_term[g] = term
        self._m_commit[g] = 0
        self._m_last[g] = 0
        self._m_quiesced[g] = False
        lane.recovering = False
        # base moved + recovering cleared: recompute routes/base deltas
        self._routes_dirty = True
        # restart/rejoin forensics: a lagging rejoiner whose log was
        # compacted past its index MUST take this path — the longhaul
        # runner and the restart tests assert on this event
        flight_recorder().record(
            "snapshot_installed", cluster=node.cluster_id,
            node=node.node_id(), index=ss.index, term=ss.term,
        )
        # persist the post-restore hard state and ack the leader so its
        # remote leaves the Snapshot state (raft.go handleInstallSnapshot)
        node.logdb.save_raft_state(
            [
                Update(
                    cluster_id=node.cluster_id,
                    node_id=node.node_id(),
                    state=State(term=term, vote=0, commit=ss.index),
                )
            ]
        )
        leader = lane.rev.get(int(self._m_leader[g]) - 1)
        sender = leader if leader and leader != node.node_id() else None
        if sender is None:
            # best effort: ack every voting peer; only the leader cares
            senders = [n for n in lane.slots if n != node.node_id()]
        else:
            senders = [sender]
        for nid in senders:
            node._send_message(
                Message(
                    type=MT.REPLICATE_RESP,
                    cluster_id=node.cluster_id,
                    to=nid,
                    from_=node.node_id(),
                    term=term,
                    log_index=ss.index,
                )
            )

    # --------------------------------------------------------- worker mains
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
                lane = self._lane_of(node)
                if lane is not None:
                    self._m_snap_pending[lane.g] = False

    # --------------------------------------------------------------- control
    def profile_summary(self) -> dict:
        return self.profiler.summary()

    def fairness_stats(self) -> dict:
        """Tick-fairness watchdog snapshot: inter-iteration latency vs the
        tick period, the starvation gauge, burst clamps, enforced yields."""
        return self.watchdog.stats()

    def step_stats(self) -> dict:
        """Cumulative per-step columnar counters (kernel steps, outbound
        messages by plane, lanes with commit advance, elections started,
        entries handed to the RSM) — derived host-side from the decoded
        StepOutput, so reading them costs nothing on the device."""
        return dict(self._sstats)

    def lease_stats(self) -> dict:
        """Cumulative lease read counters across all lanes: 'local' =
        linearizable reads served straight off a live leader lease (no
        quorum round), 'fallback' = lease-enabled reads that degraded to
        the ReadIndex quorum path (lease expired / revoked / clock
        suspect). Plain int reads of decode-maintained counters."""
        return {"local": self._lease_local, "fallback": self._lease_fb}

    def counter_stats(self) -> Dict[str, int]:
        """Cumulative protocol-event totals across all lanes, keyed by
        the canonical CTR_NAMES vocabulary (elections started/won,
        heartbeats sent, replicate rejects, commit advances IN INDEX
        UNITS, lease served/fallback, read confirmations). The deltas
        were counted ON DEVICE inside step_batch — including K>1 inner
        steps and device-routed co-hosted traffic — and folded by the
        decode phase; reading them is a plain numpy sum over the
        cumulative mirror, zero device syncs."""
        totals = self._ctr.sum(axis=0)
        return {name: int(totals[i]) for i, name in enumerate(CTR_NAMES)}

    def lane_counters(self, host: Optional[int] = None) -> Dict[tuple, Dict[str, int]]:
        """Per-lane cumulative event counters (lane key -> CTR_NAMES
        dict), same sourcing as counter_stats. Joined with lane_stats on
        the lane key by tools.top's heat ranking. With `host`, only that
        co-hosted NodeHost's lanes, in one gather (as lane_stats)."""
        lanes, gs = self._active_lanes(host)
        return {
            lane.key: dict(zip(CTR_NAMES, row))
            for lane, row in zip(lanes, self._ctr[gs].tolist())
        }

    def device_census(self) -> dict:
        """Device memory census snapshot: static plane bytes (reported once at
        allocation) + per-lane logical log fill folded from the decode-
        maintained mirrors — zero device syncs, like lane_stats. The
        ROADMAP paged-arena item's measured baseline."""
        return self.census.snapshot(
            last=self._m_last,
            devfirst=self._m_devfirst,
            active=self._m_active,
        )

    def pressure_stats(self) -> dict:
        """Serving-front backpressure probe (serving.backpressure.
        SaturationMonitor): inbox-row occupancy of the last packed step
        (fraction of the worked lanes' K-row capacity actually filled)
        and the staged-row backlog carried between steps. Plain reads of
        the pack-maintained counters — lock-free, zero device syncs."""
        lanes = self._p_inbox_lanes
        if not lanes:
            return {"inbox_occupancy": 0.0, "staged_backlog": 0}
        return {
            "inbox_occupancy": self._p_inbox_rows
            / (lanes * self.kcfg.inbox_depth),
            "staged_backlog": self._p_staged_backlog,
        }

    def _active_lanes(self, host: Optional[int] = None):
        """The active lanes (of one co-hosted NodeHost when `host` is
        given) and their lane indexes as an int64 array."""
        with self._lanes_mu:
            lanes = [
                lane
                for lane in self._lanes.values()
                if lane.active and (host is None or lane.key[0] == host)
            ]
        return lanes, np.fromiter((lane.g for lane in lanes), np.int64, len(lanes))

    def lane_stats(self, host: Optional[int] = None) -> Dict[tuple, dict]:
        """Per-lane introspection derived ENTIRELY from the numpy mirrors
        the decode phase already maintains — zero device syncs: lane key ->
        {node_id, leader_id, term, commit_gap, ticks_since_leader_change}.
        commit_gap is last_index - commit_index in device units (how far
        the lane's accepted log runs ahead of its quorum commit — a
        persistently large gap flags a lane that cannot reach quorum).
        Exported ~1/s by NodeHost._export_health_gauges as cluster_id-
        labelled engine_lane_* gauges and folded into bench.py's JSON.
        With `host`, only that co-hosted NodeHost's lanes: every host of a
        shared core exports once a second, so each folds its own lanes
        (one gather per mirror) rather than the whole core's."""
        lanes, gs = self._active_lanes(host)
        last = self._m_last[gs]
        cols = zip(
            lanes,
            self._m_leader[gs].tolist(),
            self._m_term[gs].tolist(),
            np.maximum(last - self._m_commit[gs], 0).tolist(),
            last.tolist(),
            np.maximum(
                self.clock.tick - self._m_leader_change_tick[gs], 0
            ).tolist(),
            self._m_role[gs].tolist(),
        )
        out: Dict[tuple, dict] = {}
        for lane, leader, term, gap, last_i, since, role in cols:
            out[lane.key] = {
                "node_id": lane.node.node_id(),
                "leader_id": lane.rev.get(leader - 1, 0),
                "term": term,
                "commit_gap": gap,
                # monotonic append high-water mark in device units: the
                # placement plane's ingest-rate signal is the DELTA of
                # this between two load folds (serving/placement.py) —
                # still a pure mirror read, zero device syncs
                "last_index": last_i,
                "ticks_since_leader_change": since,
                # lane-variant probes: the replica's role (observer/witness
                # lanes included) and resident client-payload bytes — a
                # witness lane must report payload_bytes == 0 (the
                # observer_witness_churn verdict and tests assert on it)
                "role": role,
                "payload_bytes": lane.arena.payload_bytes,
            }
        return out

    def hot_lane_stats(
        self, k: int, host: Optional[int] = None
    ) -> Tuple[Dict[tuple, dict], int]:
        """The k hottest active lanes by commit gap (optionally filtered
        to one co-hosted NodeHost), plus the total count the cap hides:
        (lane key -> lane_stats row + heat-relevant counter columns,
        total_active). Selection is one numpy gather + argpartition over
        the decode-maintained mirrors — a 50k-lane host pays the
        per-lane dict cost only for the k lanes somebody will look at
        (the history sampler's slot-bounded lane table, tools.top's
        default ranking input). Counter columns (HOT_LANE_COUNTERS) come
        off the same cumulative host mirror as counter_stats — zero
        device syncs, like everything on this surface."""
        lanes, gs = self._active_lanes(host)
        total = len(lanes)
        out: Dict[tuple, dict] = {}
        if not lanes:
            return out, 0
        k = max(1, int(k))
        gaps = np.maximum(self._m_last[gs] - self._m_commit[gs], 0)
        if total > k:
            pick = np.argpartition(gaps, total - k)[total - k:]
            # hottest-first order inside the cap (stable for renderers)
            pick = pick[np.argsort(-gaps[pick], kind="stable")]
        else:
            pick = np.argsort(-gaps, kind="stable")
        leader = self._m_leader
        term = self._m_term
        last = self._m_last
        role = self._m_role
        chg = self._m_leader_change_tick
        tick = self.clock.tick
        ctr = self._ctr
        ctr_cols = [
            (name, CTR_NAMES.index(name)) for name in HOT_LANE_COUNTERS
        ]
        for i in pick:
            lane = lanes[int(i)]
            g = lane.g
            row = ctr[g]
            out[lane.key] = {
                "node_id": lane.node.node_id(),
                "leader_id": lane.rev.get(int(leader[g]) - 1, 0),
                "term": int(term[g]),
                "commit_gap": int(gaps[int(i)]),
                "last_index": int(last[g]),
                "ticks_since_leader_change": max(int(tick - chg[g]), 0),
                "role": int(role[g]),
                "payload_bytes": lane.arena.payload_bytes,
                "counters": {n: int(row[ci]) for n, ci in ctr_cols},
            }
        return out, total

    def leader_snapshot(self, host: Optional[int] = None) -> Dict[tuple, Tuple[int, int]]:
        """One vectorized pass over the numpy mirrors: lane key ->
        (leader_node_id, term) for every active lane (of one co-hosted
        NodeHost with `host`). Replaces per-group get_leader_id polling at
        fleet bring-up (50k lanes = one call)."""
        lanes, gs = self._active_lanes(host)
        return {
            lane.key: (lane.rev.get(leader - 1, 0), term)
            for lane, leader, term in zip(
                lanes, self._m_leader[gs].tolist(), self._m_term[gs].tolist()
            )
        }

    def attach_host(self) -> int:
        with self._hosts_mu:
            host = self._next_host
            self._next_host += 1
            self._host_refs.add(host)
        return host

    def release(self, host: int, flush: bool = True) -> None:
        """Detach one NodeHost handle; the core stops when the last handle
        releases (a shared core outlives any single host). The last-ref
        check and the registry removal happen under _shared_mu so a
        concurrent get_vector_engine() can never attach to a core that is
        about to stop. A non-last release drains the loop once so the
        departing host's lanes are fully deactivated before its NodeHost
        closes the logdb under them.

        flush=False is the CRASH path (NodeHost.crash): a sole-tenant core
        discards its un-decoded in-flight step instead of landing it — a
        SIGKILL'd process would never have decoded or saved that output.
        On a shared core the in-flight step belongs to the surviving
        hosts too, so crash granularity there is the lane teardown and
        the shared step still decodes."""
        with _shared_mu:
            with self._hosts_mu:
                self._host_refs.discard(host)
                self._blocked_hosts.discard(host)
                last = not self._host_refs
            if last:
                _forget_shared_core_locked(self)
        if last:
            self.stop(flush=flush)
        else:
            self.drain()

    def drain(self, timeout: float = 30.0) -> None:
        """Block until the loop has applied every queued reconcile (incl.
        deactivations) and finished its in-flight iteration. The restart
        plane's ordering barrier: after NodeHost.stop_cluster /
        crash_cluster drain, the freed lane is on the free list and a
        restart_cluster can reuse it immediately."""
        if self._stopped.is_set() or self.fault is not None:
            return
        ev = threading.Event()
        self._reconq.append(("barrier", ev))
        self._ready.set()
        ev.wait(timeout)

    def stop(self, flush: bool = True) -> None:
        rep = self.profiler.report()
        if rep:
            _plog.infof("vector engine stage profile:\n%s", rep)
        self.watchdog.close()
        if not flush:
            self._discard_pending = True
        self._stopped.set()
        self._ready.set()
        self.task_ready.wake_all()
        self.snapshot_ready.wake_all()
        # the step thread must fully drain its in-flight iteration before
        # the caller closes the logdb under it; a short join here would let
        # a slow device step race the close (observed as "write to closed
        # file" + a C++ abort at interpreter teardown)
        for t in self._threads:
            t.join(timeout=30 if t.name == "vec-step" else 2)
        if not any(t.is_alive() for t in self._threads if t.name == "vec-step"):
            self._release_tensors()

    def _release_tensors(self) -> None:
        """Drop every tensor of the stopped engine: the shards' state trees,
        residual inboxes and device planes, the host staging and fetch
        slots (pinned on the card), and the step in flight. The core sits
        in reference cycles (its threads, lanes and nodes point back at
        it), so without this its device memory would wait for a full
        collection of the cycle collector (ROADMAP §3 fault 13). The host
        mirrors stay: a stopped core still answers lane_stats and the
        census from them."""
        for sh in self._shards:
            sh.state = sh.resid = sh.dev_in = sh.dev_inbox = None
            sh.dev_out = sh.outs = sh.plans = sh.host_ins = None
        self._bufsets, self._out_slots, self._pending = [], [], None
        self._buf = self._ticks = self._host_inbox = self._host_in = None
        self._np_route = self._np_rdelta = None


class VectorEngineHandle:
    """Per-NodeHost facade over a (possibly shared) VectorEngine core.

    Lanes inside the core are keyed (host, cluster_id); the handle carries
    the host id so the Node/NodeHost side keeps addressing the engine by
    bare cluster_id. Attribute access falls through to the core, so the
    VectorNode status mirrors (_m_leader etc.) and the reconcile bridges
    work unchanged."""

    __slots__ = ("core", "host", "kcfg", "clock")

    def __init__(self, core: VectorEngine, host: int) -> None:
        self.core = core
        self.host = host
        self.kcfg = core.kcfg
        self.clock = core.clock

    def add_node(self, node) -> None:
        self.core.add_node(node, self.host)

    def remove_node(self, cluster_id: int) -> None:
        self.core.remove_node((self.host, cluster_id))

    def get_node(self, cluster_id: int):
        return self.core.get_node((self.host, cluster_id))

    def set_node_ready(self, cluster_id: int) -> None:
        self.core.set_node_ready((self.host, cluster_id))

    def set_task_ready(self, cluster_id: int) -> None:
        self.core.set_task_ready((self.host, cluster_id))

    def set_snapshot_ready(self, cluster_id: int) -> None:
        self.core.set_snapshot_ready((self.host, cluster_id))

    def global_tick(self) -> None:
        self.core.global_tick(self.host)

    def try_local_deliver(self, m: Message) -> bool:
        return self.core.try_local_deliver(m)

    def set_host_partitioned(self, partitioned: bool) -> None:
        self.core.set_host_partitioned(self.host, partitioned)

    def set_clock_suspect(self, hold_s: float) -> None:
        """Clock-anomaly report scoped to THIS host's lanes (a shared
        core serves several NodeHosts, each with its own tick worker)."""
        self.core.set_clock_suspect(self.host, hold_s)

    def lease_valid(self, cluster_id: int) -> bool:
        return self.core.lease_valid((self.host, cluster_id))

    def leader_snapshot(self) -> Dict[int, Tuple[int, int]]:
        """cluster_id -> (leader_node_id, term) for this host's lanes."""
        return {
            key[1]: v
            for key, v in self.core.leader_snapshot(self.host).items()
        }

    def lane_stats(self) -> Dict[int, dict]:
        """cluster_id -> per-lane introspection for this host's lanes."""
        return {
            key[1]: v for key, v in self.core.lane_stats(self.host).items()
        }

    def lane_counters(self) -> Dict[int, Dict[str, int]]:
        """cluster_id -> cumulative event counters for this host's
        lanes (see VectorEngine.lane_counters)."""
        return {
            key[1]: v for key, v in self.core.lane_counters(self.host).items()
        }

    def hot_lane_stats(self, k: int) -> Tuple[Dict[int, dict], int]:
        """This host's k hottest lanes by commit gap + its total active
        lane count (see VectorEngine.hot_lane_stats). Host filtering
        happens BEFORE the cap so a co-hosted fleet's noisy neighbour
        can never crowd this host's lanes out of its own sample."""
        rows, total = self.core.hot_lane_stats(k, host=self.host)
        return {key[1]: v for key, v in rows.items()}, total

    def stop(self) -> None:
        self.core.release(self.host)

    def crash(self) -> None:
        """SIGKILL-equivalent detach (NodeHost.crash): a sole-tenant core
        discards its un-decoded in-flight step; a shared core keeps
        serving its surviving hosts (see VectorEngine.release)."""
        self.core.release(self.host, flush=False)

    def __getattr__(self, name):
        return getattr(self.core, name)


# process-global registry of shared cores (EngineConfig.share_scope)
_shared_mu = threading.Lock()
_shared_cores: Dict[str, VectorEngine] = {}


def get_vector_engine(logdb, nh_config: NodeHostConfig) -> VectorEngineHandle:
    """Engine factory for NodeHost: returns a handle on a fresh core, or on
    the process-shared core named by EngineConfig.share_scope (co-hosted
    replicas then advance in ONE kernel step and exchange messages without
    touching the transport)."""
    scope = getattr(nh_config.engine, "share_scope", None)
    if scope is None:
        core = VectorEngine(logdb, nh_config=nh_config)
        return VectorEngineHandle(core, core.attach_host())
    with _shared_mu:
        core = _shared_cores.get(scope)
        if core is None:
            core = _shared_cores[scope] = VectorEngine(
                logdb, nh_config=nh_config
            )
        else:
            want = nh_config.engine
            mismatches = [
                name
                for name, got, exp in (
                    # requested, not kcfg.groups: the sharded round-up
                    # pads the kernel shape, not the declared capacity
                    ("max_groups", core._groups_requested, want.max_groups),
                    ("max_peers", core.kcfg.peers, want.max_peers),
                    ("log_window", core.kcfg.log_window, want.log_window),
                    ("inbox_depth", core.kcfg.inbox_depth, want.inbox_depth),
                    (
                        "max_entries_per_msg",
                        core.kcfg.max_entries_per_msg,
                        getattr(want, "max_entries_per_msg", 8),
                    ),
                    (
                        "readindex_depth",
                        core.kcfg.readindex_depth,
                        want.readindex_depth,
                    ),
                    # the super-step length sizes the shared core's
                    # stacked outputs: every co-hosted host runs at the
                    # same K by construction
                    (
                        "steps_per_sync",
                        core._multi,
                        max(1, int(getattr(want, "steps_per_sync", 1) or 1)),
                    ),
                    # one core, one device: its state lives in one place
                    (
                        "device",
                        core.device,
                        _engine_device(getattr(want, "device", "cuda")),
                    ),
                )
                if got != exp
            ]
            if mismatches:
                raise ValueError(
                    f"share_scope {scope!r}: engine shape mismatch on "
                    f"{mismatches} (every co-hosted NodeHost must declare "
                    f"the same EngineConfig shapes)"
                )
        host = core.attach_host()
    return VectorEngineHandle(core, host)


def _forget_shared_core_locked(core: VectorEngine) -> None:
    """Caller holds _shared_mu."""
    for k, v in list(_shared_cores.items()):
        if v is core:
            del _shared_cores[k]


__all__ = [
    "VectorEngine",
    "VectorEngineHandle",
    "VectorNode",
    "get_vector_engine",
]
