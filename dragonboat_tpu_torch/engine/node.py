"""Per-group node runtime: binds one Raft group's Peer + state machine +
request queues and pumps events between them.

cf. node.go:53-1399 — the node is the unit the execution engine schedules.
All protocol work happens inside step_node() on a step worker; all apply
work inside handle_task() on a task worker; the public request methods only
enqueue and wake the engine.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from ..client import Session
from ..config import Config
from ..core.peer import Peer, PeerAddress, encode_config_change
from ..core.remote import RemoteState
from ..core.logentry import ErrCompacted
from ..requests import (
    BATCH_KEY_BIT,
    BatchRequestState,
    ErrClusterClosed,
    ErrInvalidSession,
    ErrPayloadTooBig,
    ErrSnapshotStreamAborted,
    ErrSystemBusy,
    ErrTimeoutTooSmall,
    LogicalClock,
    PendingConfigChange,
    PendingLeaderTransfer,
    PendingProposal,
    PendingReadIndex,
    PendingSnapshot,
    RequestState,
    batch_id_of,
    make_batch_id,
    make_batch_key,
)
from ..rsm.encoded import maybe_encode_entry
from ..rsm import (
    SSRequest,
    SS_REQ_EXPORTED,
    SS_REQ_USER,
    StateMachineManager,
    Task,
    wrap_state_machine,
)
from ..settings import soft
from ..statemachine import Result
from ..types import (
    ConfigChange,
    Entry,
    EntryType,
    Membership,
    Message,
    MessageType,
    Snapshot,
    Update,
)
from ..trace import LatencyTrace, flight_recorder, mint_trace_id
from .quiesce import QuiesceManager
from .queue import EntryQueue, MessageQueue, ReadIndexQueue
from .snapshotstate import SnapshotState


class Node:
    def __init__(
        self,
        cfg: Config,
        peer_addresses: List[PeerAddress],
        initial: bool,
        new_node: bool,
        sm_factory: Callable,
        log_reader,
        logdb,
        snapshotter,
        send_message: Callable[[Message], None],
        engine,
        event_listener=None,
        rng: Optional[random.Random] = None,
        send_messages: Optional[Callable[[List[Message]], None]] = None,
        register_peer: Optional[Callable[[int, int, str], None]] = None,
    ) -> None:
        self.config = cfg
        self.cluster_id = cfg.cluster_id
        self._node_id = cfg.node_id
        self.log_reader = log_reader
        self.logdb = logdb
        self.snapshotter = snapshotter
        self._send_message = send_message
        # optional bulk path (one co-hosted delivery pass + one grouped
        # wire send per batch); None falls back to per-message sends
        self._send_messages = send_messages
        # host transport registrar: a committed ADD_* config change (and
        # a snapshot-restored membership) carries the member's address in
        # REPLICATED state, so every applying replica can register it —
        # without this, only the host that REQUESTED the change can route
        # to the new member, and a migrated-in replica strands the moment
        # leadership leaves that host (cf. nodes.go: the reference gets
        # the same cluster-wide knowledge from its nodehost registry)
        self._register_peer = register_peer
        self.engine = engine
        self.events = event_listener
        self.clock = self._make_clock(engine)
        self.pending_proposals = PendingProposal(self.clock)
        self.pending_read_indexes = PendingReadIndex(self.clock)
        self.pending_config_change = PendingConfigChange(self.clock)
        self.pending_snapshot = PendingSnapshot(self.clock)
        self.pending_leader_transfer = PendingLeaderTransfer()
        self.incoming_proposals = EntryQueue(soft.incoming_proposal_queue_length)
        self.incoming_reads = ReadIndexQueue(soft.incoming_read_index_queue_length)
        # batch-tracked proposals (propose_batch_async): ONE handle per
        # submission, completion routed by the key's (batch_id, seq)
        self._batch_mu = threading.Lock()
        self._batches: dict = {}  # batch_id -> BatchRequestState
        self._batch_seq = 0
        self.mq = MessageQueue(soft.received_message_queue_length)
        # sampled request-latency seam (see trace.LatencySampler): the
        # engine owns the sampler so every group on it shares one ratio
        # (EngineConfig.profile_sample_ratio); unsampled requests pay one
        # increment and allocate nothing
        self._req_sampler = getattr(engine, "request_sampler", None)
        self.quiesce_mgr = QuiesceManager(
            enabled=cfg.quiesce, election_tick=cfg.election_rtt
        )
        self.stopped = False
        self._mu = threading.Lock()
        self._init_mu = threading.Lock()
        # config-change requests handed from API to step worker
        self._cc_queue: List = []
        self._leader_id = 0
        self._current_term = 0
        # logical-clock stamp of the last observed leader transition:
        # ExecEngine.lane_stats() derives ticks_since_leader_change from it
        # (parity with the vector engine's _m_leader_change_tick mirror)
        self._leader_change_tick = 0
        self._rate_limited = False  # refreshed each step (cf. node.go:1095)
        # ticks each peer has spent parked in RemoteState.SNAPSHOT, for
        # the delayed snapshot-status retry (_snapshot_feedback)
        self._snap_parked: dict = {}
        # aborted inbound snapshot-install stream window: while fresh, ops
        # that gate on the install fail FAST with the typed
        # ErrSnapshotStreamAborted instead of a generic timeout. Plain
        # GIL-atomic stamps — written from the chunk sink's notify, read
        # on the API paths; cleared when a restore completes.
        self._install_abort_deadline = 0.0
        self._install_abort_hint = 0.0
        self._confirmed_applied = 0  # applied index confirmed into an Update
        self.initialized = threading.Event()
        # rsm manager
        managed = wrap_state_machine(
            sm_factory(cfg.cluster_id, cfg.node_id), cfg.cluster_id, cfg.node_id
        )
        self.sm = StateMachineManager(snapshotter, managed, self, cfg)
        if snapshotter is not None:
            snapshotter.bind_sm(self.sm)
        if self.sm.on_disk_state_machine():
            # open the user's on-disk state BEFORE the protocol core (and
            # any snapshot recovery / log replay) runs: the returned index
            # seeds the manager's skip-until cursor so already-persisted
            # entries are not re-applied, and step_node's applied-cursor
            # notifications start from it (cf. statemachine.go:374-389
            # OpenOnDiskStateMachine; node.go:553-583)
            self.sm.open()
        # snapshot FSM: flags + one req/completed slot per kind
        # (cf. snapshotstate.go:64-214)
        self.ss = SnapshotState()
        self._applied_since_snapshot = 0
        # launch the protocol core (VectorNode overrides: its protocol state
        # lives in the shared device tensors, not a per-group Peer)
        self.peer = self._launch_core(
            cfg, log_reader, peer_addresses, initial, new_node, rng
        )
        if not self._has_snapshot_to_recover():
            self.initialized.set()

    def _make_clock(self, engine):
        """Per-node logical clock; the VectorEngine overrides this with one
        clock shared by every lane so deadlines stay comparable."""
        return LogicalClock()

    def _launch_core(self, cfg, log_reader, peer_addresses, initial, new_node, rng):
        return Peer.launch(
            cfg,
            log_reader,
            events=self._make_raft_event_adapter(),
            addresses=peer_addresses,
            initial=initial,
            new_node=new_node,
            rng=rng,
        )

    # ----------------------------------------------------------------- naming
    def node_id(self) -> int:
        return self._node_id

    def describe(self) -> str:
        return f"[{self.cluster_id:05d}:{self._node_id:05d}]"

    # ----------------------------------------------------- INodeProxy methods
    def node_ready(self) -> None:
        self.engine.set_node_ready(self.cluster_id)

    # -------------------------------------------------- latency observation
    def _metrics_registry(self):
        ev = self.events
        return getattr(ev, "metrics", None) if ev is not None else None

    def _observe_entry_latency(self, lt: LatencyTrace) -> None:
        """A sampled proposal finished its apply: fold the lifecycle into
        the proposing node's latency histograms. Owner-pinned (co-hosted
        replicas apply the identical Entry objects) and once-only."""
        if lt.owner is not self or lt.done:
            return
        lt.done = True
        if lt.trace_id:
            # final causal stage: the sampled proposal applied + notified
            # on its proposing node
            flight_recorder().record(
                "proposal_applied", cluster=self.cluster_id,
                node=self._node_id, trace=lt.trace_id,
            )
        m = self._metrics_registry()
        if m is None:
            return
        now = time.monotonic()
        key = (self.cluster_id, self._node_id)
        # a missing commit stamp (engine variant without one) degrades to
        # commit==apply rather than dropping the sample
        commit_t = lt.t_commit or now
        m.observe(
            "proposal_commit_latency_seconds", key, max(commit_t - lt.t0, 0.0)
        )
        m.observe(
            "proposal_apply_latency_seconds", key, max(now - lt.t0, 0.0)
        )

    def _read_latency_done(self, rs: RequestState) -> None:
        t0 = rs.lat
        r = rs.result
        if t0 is None or r is None or not r.completed:
            return  # timed-out/dropped reads are not read latencies
        m = self._metrics_registry()
        if m is not None:
            m.observe(
                "readindex_latency_seconds",
                (self.cluster_id, self._node_id),
                max(time.monotonic() - t0, 0.0),
            )

    def apply_update(self, entry, result, rejected, ignored, notify_read) -> None:
        if entry.lat is not None:
            self._observe_entry_latency(entry.lat)
        if entry.key & BATCH_KEY_BIT:
            self._batch_applied(batch_id_of(entry.key), 1)
        else:
            self.pending_proposals.applied(
                entry.key, entry.client_id, entry.series_id, result, rejected
            )
        if notify_read:
            self.pending_read_indexes.applied(entry.index)

    def apply_update_run(self, entries, results=None) -> None:
        """Run-level completion for a contiguous batch of plain applied
        entries (the RSM manager's fast path): batch-tracked proposals
        complete per (batch_id, count) instead of per entry. `results`
        aligns with `entries`; None means no per-request keys exist in the
        run (the manager skips result realignment for pure batch runs)."""
        counts: dict = {}
        if results is None and not self._batches:
            return  # replica apply with no locally-tracked batches
        if results is None:
            for e in entries:
                if e.lat is not None:
                    self._observe_entry_latency(e.lat)
                if e.key & BATCH_KEY_BIT:
                    bid = batch_id_of(e.key)
                    counts[bid] = counts.get(bid, 0) + 1
        else:
            for e, r in zip(entries, results):
                if e.lat is not None:
                    self._observe_entry_latency(e.lat)
                if e.key & BATCH_KEY_BIT:
                    bid = batch_id_of(e.key)
                    counts[bid] = counts.get(bid, 0) + 1
                elif e.key:
                    self.pending_proposals.applied(
                        e.key, e.client_id, e.series_id, r, False
                    )
        for bid, n in counts.items():
            self._batch_applied(bid, n)

    def _batch_applied(self, batch_id: int, n: int) -> None:
        with self._batch_mu:
            h = self._batches.get(batch_id)
        if h is None:
            return  # submitted elsewhere (replica apply) or already expired
        h.add_done(completed=n)
        if h.finished:
            with self._batch_mu:
                self._batches.pop(batch_id, None)

    def proposal_dropped(self, entry) -> None:
        """Drop notification that understands batch-tracked keys (the
        engine calls this instead of pending_proposals.dropped directly)."""
        if entry.key & BATCH_KEY_BIT:
            with self._batch_mu:
                h = self._batches.get(batch_id_of(entry.key))
            if h is not None:
                h.add_done(dropped=1)
        else:
            self.pending_proposals.dropped(entry.key)

    def apply_config_change(self, cc: ConfigChange) -> None:
        """Called by the RSM when a config change commits; updates the
        protocol-core membership (cf. node.go applyConfigChange)."""
        self._register_cc_address(cc)
        with self._mu:
            self.peer.apply_config_change(cc)
        if cc.node_id == self._node_id and cc.type.name == "REMOVE_NODE":
            pass  # node removal handled by nodehost monitor

    def _register_cc_address(self, cc: ConfigChange) -> None:
        """Every replica applying an ADD_* change registers the new
        member's address with its host transport: the address rides the
        replicated entry, so routing knowledge is cluster-wide, not
        request-host-local (a live migration's swapped-in member must
        stay reachable after leadership leaves the host that added it)."""
        if self._register_peer is not None and cc.address:
            self._register_peer(self.cluster_id, cc.node_id, cc.address)

    def membership_loaded(self, membership) -> None:
        """A snapshot restore installed a full membership image: register
        every member's address (the joiner's ONLY source of its peers'
        addresses — its bootstrap is empty by definition of join)."""
        if self._register_peer is None:
            return
        for table in (
            membership.addresses,
            getattr(membership, "observers", None) or {},
            getattr(membership, "witnesses", None) or {},
        ):
            for nid, addr in table.items():
                if addr:
                    self._register_peer(self.cluster_id, nid, addr)

    def config_change_processed(self, key: int, accepted: bool) -> None:
        if accepted:
            self.pending_config_change.apply(key, rejected=False)
        else:
            self.peer.reject_config_change()
            self.pending_config_change.apply(key, rejected=True)

    def should_stop(self) -> bool:
        return self.stopped

    # ------------------------------------------------------------ public API
    def propose(
        self, session: Session, cmd: bytes, timeout_ticks: int
    ) -> RequestState:
        if len(cmd) > soft.max_proposal_payload_size:
            raise ErrPayloadTooBig()
        if self._rate_limited:
            # some replica's in-mem log is over Config.max_in_mem_log_size;
            # refuse new work until the fleet drains (cf. node.go:1094-1105
            # handleProposals + requests.go ErrSystemBusy)
            raise ErrSystemBusy()
        rs, entry = self.pending_proposals.propose(session, cmd, timeout_ticks)
        s = self._req_sampler
        if s is not None and s.sample():
            # propose-enqueue timestamp; the trace rides the Entry through
            # arena -> commit -> apply and back to the histograms. The
            # trace id additionally rides the wire (Entry/Message codec)
            # so remote hops stamp the same causal key.
            entry.lat = LatencyTrace(
                self, time.monotonic(), trace_id=mint_trace_id()
            )
            entry.trace_id = entry.lat.trace_id
            flight_recorder().record(
                "propose_enqueue", cluster=self.cluster_id,
                node=self._node_id, trace=entry.trace_id,
            )
        # optional payload compression at the propose boundary: the wire,
        # logdb and apply queue all carry the compressed form; replicas
        # decompress once at apply time (cf. rsm/encoded.go:47-176)
        maybe_encode_entry(self.config.entry_compression_type, entry)
        if not self.incoming_proposals.add(entry):
            self.pending_proposals.dropped(rs.key)
            raise ErrSystemBusy()
        self.engine.set_node_ready(self.cluster_id)
        return rs

    def propose_batch(
        self, session: Session, cmds, timeout_ticks: int
    ) -> List[RequestState]:
        """Submit many proposals with one registry lock, one queue lock
        and one engine wake-up. The per-proposal Python round-trip is the
        submission ceiling on a pipelined client; batching amortizes it
        (the engines already ingest and persist in batches). Only no-op
        sessions may batch: a registered session's at-most-once bookkeeping
        is strictly sequential (cf. client session semantics,
        requests.go:141-166). Overflow past the queue capacity completes
        those requests as DROPPED rather than failing the whole batch."""
        cmds = list(cmds)  # one-shot iterables must survive the pre-checks
        if not session.is_noop_session() and len(cmds) > 1:
            raise ErrInvalidSession()
        for cmd in cmds:
            if len(cmd) > soft.max_proposal_payload_size:
                raise ErrPayloadTooBig()
        if self._rate_limited:
            raise ErrSystemBusy()
        rss, entries = self.pending_proposals.propose_batch(
            session, cmds, timeout_ticks
        )
        s = self._req_sampler
        if entries and s is not None and s.sample():
            # one sampled entry per batch keeps the sampler's 1-in-N
            # meaning "1-in-N submissions", not "N samples per wave"
            e = entries[-1]
            e.lat = LatencyTrace(
                self, time.monotonic(), trace_id=mint_trace_id()
            )
            e.trace_id = e.lat.trace_id
            flight_recorder().record(
                "propose_enqueue", cluster=self.cluster_id,
                node=self._node_id, trace=e.trace_id, batch=len(entries),
            )
        for entry in entries:
            maybe_encode_entry(self.config.entry_compression_type, entry)
        accepted = self.incoming_proposals.add_many(entries)
        for entry in entries[accepted:]:
            self.pending_proposals.dropped(entry.key)
        if accepted:
            self.engine.set_node_ready(self.cluster_id)
        return rss

    def propose_batch_async(
        self, session: Session, cmds, timeout_ticks: int
    ) -> BatchRequestState:
        """Fire-and-collect batch submission: ONE handle, ONE completion
        event for the whole batch; per-proposal results are not retained
        (use propose/propose_batch when they matter). No-op sessions only.
        The entries carry (batch_id, seq) in their key, so completion
        survives host-side forwarding and leader changes."""
        cmds = list(cmds)
        if not session.is_noop_session():
            raise ErrInvalidSession()
        if timeout_ticks < 1:
            raise ErrTimeoutTooSmall()
        for cmd in cmds:
            if len(cmd) > soft.max_proposal_payload_size:
                raise ErrPayloadTooBig()
        if self._rate_limited:
            raise ErrSystemBusy()
        with self._batch_mu:
            if self.stopped:
                raise ErrClusterClosed()
            self._batch_seq += 1
            bid = make_batch_id(self._node_id, self._batch_seq)
            h = BatchRequestState(
                bid, len(cmds), self.clock.tick + timeout_ticks
            )
            self._batches[bid] = h
        if not cmds:
            h.expire()
            return h
        key0 = make_batch_key(bid, 0)
        entries = [
            Entry(
                key=key0 + i,
                client_id=session.client_id,
                series_id=session.series_id,
                responded_to=session.responded_to,
                cmd=cmd,
            )
            for i, cmd in enumerate(cmds)
        ]
        s = self._req_sampler
        if entries and s is not None and s.sample():
            e = entries[-1]
            e.lat = LatencyTrace(
                self, time.monotonic(), trace_id=mint_trace_id()
            )
            e.trace_id = e.lat.trace_id
            flight_recorder().record(
                "propose_enqueue", cluster=self.cluster_id,
                node=self._node_id, trace=e.trace_id, batch=len(entries),
            )
        if self.config.entry_compression_type:
            for entry in entries:
                maybe_encode_entry(self.config.entry_compression_type, entry)
        accepted = self.incoming_proposals.add_many(entries)
        if accepted < len(entries):
            h.add_done(dropped=len(entries) - accepted)
        if accepted:
            self.engine.set_node_ready(self.cluster_id)
        return h

    def gc_batches(self) -> None:
        """Expire timed-out batch handles (called from the tick/gc pass)."""
        if not self._batches:
            return
        now = self.clock.tick
        with self._batch_mu:
            dead = [
                bid for bid, h in self._batches.items() if h.deadline < now
            ]
            handles = [self._batches.pop(bid) for bid in dead]
        for h in handles:
            h.expire()

    # -------------------------------------------- snapshot-stream aborts
    def notify_install_aborted(self, retry_after_s: float) -> None:
        """An inbound snapshot-install stream for this replica aborted
        (receiver crash / sender failure / chunk gap): open the fail-fast
        window. `retry_after_s` is both the window length and the hint
        clients receive — sized by the caller to the raft snapshot-status
        retry cadence (when a re-streamed install should have landed)."""
        self._install_abort_hint = retry_after_s
        self._install_abort_deadline = time.monotonic() + retry_after_s

    def clear_install_aborted(self) -> None:
        """A snapshot restore completed: the lag the aborted stream left
        behind is gone, stop failing fast."""
        self._install_abort_deadline = 0.0

    def _check_install_aborted(self) -> None:
        # the window opened because a stream this replica NEEDED died
        # (retry restarts are filtered out at the chunk tracker); until a
        # restore completes (clear_install_aborted) or the re-stream
        # window passes, ops gated on the install fail fast with the
        # typed, retry-hinted error — a retried op lands after the hint
        # and succeeds whether the node recovered via the re-streamed
        # install or via leader log replay
        dl = self._install_abort_deadline
        if dl and time.monotonic() < dl:
            raise ErrSnapshotStreamAborted(self._install_abort_hint)

    def notify_admission(self) -> bool:
        """Serving-front first-admit wake (engine/quiesce.py contract):
        an idle quiesced group resumes ticking immediately instead of
        waiting for the admitted op to reach the step loop. Returns True
        when the group was actually quiesced. Called from API threads;
        the quiesce fields are GIL-atomic scalars and a racing step-side
        tick at worst re-enters quiesce one threshold later — the same
        tolerance record_activity already has."""
        woke = self.quiesce_mgr.wake_on_admit()
        if woke:
            self.engine.set_node_ready(self.cluster_id)
        return woke

    def read(self, timeout_ticks: int) -> RequestState:
        # a linearizable read on a lagging replica gates on the applied
        # index catching up to the read index — exactly what a snapshot
        # install advances. With the install stream freshly aborted the
        # read would burn its whole budget into ErrTimeout; fail fast
        # with the typed, retry-hinted error instead.
        self._check_install_aborted()
        rs = self.pending_read_indexes.read(timeout_ticks)
        s = self._req_sampler
        if s is not None and s.sample():
            rs.lat = time.monotonic()
            rs.on_complete(self._read_latency_done)
        if not self.incoming_reads.add(rs):
            raise ErrSystemBusy()
        self.engine.set_node_ready(self.cluster_id)
        return rs

    def request_config_change(
        self, cc: ConfigChange, timeout_ticks: int
    ) -> RequestState:
        rs, cc, key = self.pending_config_change.request(cc, timeout_ticks)
        with self._mu:
            self._cc_queue.append((cc, key))
        self.engine.set_node_ready(self.cluster_id)
        return rs

    def request_snapshot(self, req: SSRequest, timeout_ticks: int) -> RequestState:
        rs, req = self.pending_snapshot.request(req, timeout_ticks)
        if self.ss.taking_snapshot():
            # a save is already in flight (possibly an automatic one that
            # registered no pending request): ignore rather than stack a
            # second save behind it (cf. node.go reportIgnored path)
            self.pending_snapshot.apply(0, ignored=True)
            return rs
        last_applied = self.sm.last_applied_index()
        if not req.is_exported() and (
            last_applied == self.ss.get_req_snapshot_index()
        ):
            # nothing applied since the last requested snapshot: ignore
            # instead of writing an identical image (cf. node.go:1085-1091)
            self.pending_snapshot.apply(0, ignored=True)
            return rs
        self.ss.set_req_snapshot_index(last_applied)
        self.push_take_snapshot_request(req)
        return rs

    def request_leader_transfer(self, target_id: int) -> None:
        self.pending_leader_transfer.request(target_id)
        self.engine.set_node_ready(self.cluster_id)

    # -------------------------------------------------------- engine: stepping
    def step_node(self) -> Optional[Update]:
        """One protocol step (cf. node.go:1016-1067 stepNode/handleEvents).
        Runs on a step worker; returns an Update to process or None."""
        if self.stopped:
            return None
        with self._mu:
            # finalize any completed snapshot save first: it may install a
            # snapshot record / compact the log the step below reads
            self._process_snapshot_status()
            last_applied = self.sm.last_applied_index()
            # applied cursor feeds campaign eligibility + entry pagination
            # (cf. node.go stepNode -> p.NotifyRaftLastApplied)
            self.peer.notify_raft_last_applied(last_applied)
            self._rate_limited = self.peer.rate_limited()
            # an applied-cursor advance not yet confirmed into an Update is
            # itself an event: without it, the LAST applies of a burst never
            # produce the update whose commit trims them out of the in-mem
            # log (cf. node.go:908-921 getUpdate confirmedIndex,
            # node.go:1030-1034 handleEvents)
            applied_advanced = last_applied != self._confirmed_applied
            has_event = self._handle_events() or applied_advanced
            if not has_event:
                return None
            if not (self.peer.has_update(True) or applied_advanced):
                # still commit the logical clock work
                return None
            ud = self.peer.get_update(True, last_applied)
            self._confirmed_applied = last_applied
            return ud

    def _handle_events(self) -> bool:
        had = False
        had |= self._handle_read_index_requests()
        had |= self._handle_received_messages()
        had |= self._handle_config_change_requests()
        had |= self._handle_proposals()
        had |= self._handle_leader_transfer()
        # always step if the peer accumulated output (e.g. from ticks)
        return had or self.peer.has_update(True) or self.peer.has_entry_to_apply()

    def _handle_proposals(self) -> bool:
        entries = self.incoming_proposals.get()
        if not entries:
            return False
        self.quiesce_mgr.record_activity()
        self.peer.propose_entries(entries)
        return True

    def _handle_read_index_requests(self) -> bool:
        reqs = self.incoming_reads.get()
        if not reqs:
            return False
        self.quiesce_mgr.record_activity()
        ctx = self.pending_read_indexes.next_ctx()
        if self.pending_read_indexes.bind_queued_states(reqs, ctx):
            self.peer.read_index(ctx)
        return True

    def _handle_config_change_requests(self) -> bool:
        if not self._cc_queue:
            return False
        ccs, self._cc_queue = self._cc_queue, []
        for cc, key in ccs:
            self.quiesce_mgr.record_activity()
            self.peer.propose_config_change(cc, key)
        return True

    def _handle_leader_transfer(self) -> bool:
        target = self.pending_leader_transfer.get()
        if target is None:
            return False
        self.peer.request_leader_transfer(target)
        return True

    def _handle_received_messages(self) -> bool:
        msgs, ticks = self.mq.get()
        if ticks > 0:
            # coalesced ticks capped at election timeout (node.go:1152-1159)
            for _ in range(min(ticks, self.config.election_rtt)):
                self._tick()
        had = ticks > 0
        for m in msgs:
            had = True
            if m.type == MessageType.INSTALL_SNAPSHOT:
                self._handle_install_snapshot(m)
            elif m.type == MessageType.REPLICATE and self._snapshot_busy():
                continue  # drop Replicate while snapshotting (node.go:1199)
            elif m.type == MessageType.QUIESCE:
                self.quiesce_mgr.try_enter_quiesce()
            else:
                if not m.type == MessageType.LOCAL_TICK:
                    self.quiesce_mgr.record_activity()
                self.peer.handle(m)
        return had

    def _handle_install_snapshot(self, m: Message) -> None:
        self.quiesce_mgr.record_activity()
        self.peer.handle(m)

    def _tick(self) -> None:
        self.clock.increase_tick()
        # one gate for ALL pendings sharing this clock: should_gc consumes
        # the window, so gating inside each gc() would let the first
        # starve the rest (reads/cc/snapshots would never time out)
        if self.clock.should_gc():
            self.pending_proposals.gc()
            self.pending_read_indexes.gc()
            self.pending_config_change.gc()
            self.pending_snapshot.gc()
            self.gc_batches()
        if self.quiesce_mgr.tick():
            self.peer.quiesced_tick()
        else:
            self.peer.tick()
        self._snapshot_feedback()

    def _snapshot_feedback(self) -> None:
        """Scalar twin of the vector engine's _run_snapshot_feedback (and
        dragonboat's snapshotstatus push delay): a streamed install whose
        receiver dies after the chunks leave the sender produces neither a
        transport failure nor a SNAPSHOT_RECEIVED ack, so the leader's
        remote would sit in RemoteState.SNAPSHOT forever — is_paused()
        blocks replication and no heartbeat response can move it. Count
        how long each remote has been parked in SNAPSHOT; past the retry
        window, feed the core a synthetic rejected SNAPSHOT_STATUS so the
        remote un-parks (-> WAIT) and normal probing resumes."""
        r = getattr(self.peer, "raft", None)
        if r is None or not r.is_leader():
            if self._snap_parked:
                self._snap_parked.clear()
            return
        retry_ticks = max(4 * self.config.election_rtt, 16)
        parked = self._snap_parked
        seen = []
        for group in (r.remotes, r.observers, r.witnesses):
            for nid, rm in group.items():
                if rm.state != RemoteState.SNAPSHOT:
                    continue
                held = parked.get(nid, 0) + 1
                if held > retry_ticks:
                    parked.pop(nid, None)
                    self.mq.add(
                        Message(
                            type=MessageType.SNAPSHOT_STATUS,
                            cluster_id=self.cluster_id,
                            from_=nid,
                            reject=True,
                        )
                    )
                    self.engine.set_node_ready(self.cluster_id)
                else:
                    parked[nid] = held
                    seen.append(nid)
        for nid in list(parked):
            if nid not in seen:
                del parked[nid]

    # ----------------------------------------------- engine: update processing
    def process_dropped(self, ud: Update) -> None:
        for e in ud.dropped_entries:
            self.proposal_dropped(e)
        for ctx in ud.dropped_read_indexes:
            self.pending_read_indexes.dropped(ctx)

    def send_replicate_messages(self, ud: Update) -> None:
        """Replicate messages leave before the local fsync — Raft thesis
        §10.2.1 pipelining (cf. execengine.go:508-516)."""
        for m in ud.messages:
            if m.type == MessageType.REPLICATE:
                m.cluster_id = self.cluster_id
                self._send_message(m)

    def process_raft_update(self, ud: Update) -> None:
        """Post-fsync processing (cf. node.go:975-1000)."""
        if ud.snapshot is not None and not ud.snapshot.is_empty():
            self.log_reader.apply_snapshot(ud.snapshot)
        self.log_reader.append(ud.entries_to_save)
        for m in ud.messages:
            if m.type == MessageType.REPLICATE:
                continue
            m.cluster_id = self.cluster_id
            self._send_message(m)
        if ud.state is not None and not ud.state.is_empty():
            self.log_reader.set_state(ud.state)
        if ud.ready_to_reads:
            # confirmed read contexts release once the SM catches up
            # (cf. node.go:943-948 processReadyToRead)
            self.pending_read_indexes.add_ready_to_read(ud.ready_to_reads)
        self.pending_read_indexes.applied(self.sm.last_applied_index())
        self._save_snapshot_required(ud)

    def apply_raft_update(self, ud: Update) -> None:
        """Queue committed entries for the task workers
        (cf. node.go:967-973 + pushEntries node.go:505-515)."""
        if ud.snapshot is not None and not ud.snapshot.is_empty():
            self._push_install_snapshot(ud.snapshot)
        if not ud.committed_entries:
            return
        now = 0.0
        for e in ud.committed_entries:
            lt = e.lat
            if lt is not None and lt.t_commit == 0.0:
                if not now:
                    now = time.monotonic()
                lt.t_commit = now  # quorum commit observed (sampled entry)
                if lt.trace_id:
                    flight_recorder().record(
                        "quorum_commit", cluster=self.cluster_id,
                        node=self._node_id, trace=lt.trace_id,
                        index=e.index,
                    )
        self.sm.task_queue.add(
            Task(
                cluster_id=self.cluster_id,
                node_id=self._node_id,
                entries=ud.committed_entries,
            )
        )
        self._applied_since_snapshot += len(ud.committed_entries)
        self.engine.set_task_ready(self.cluster_id)

    def commit_raft_update(self, ud: Update) -> None:
        with self._mu:
            self.peer.commit(ud)

    # ------------------------------------------------------- engine: applying
    def handle_task(self, batch, apply) -> bool:
        """Drain apply work on a task worker; returns True if a snapshot
        task needs a snapshot worker (cf. node.go:795). Snapshot tasks land
        in the FSM's per-kind request slots (snapshotstate.go:143-161); a
        task racing an occupied slot goes back to the task queue and
        retries once the worker drains the slot."""
        st = self.sm.handle(batch, apply)
        if st is not None:
            if st.snapshot_requested:
                deposited = self.ss.save_req.set(st)
            else:
                deposited = self.ss.recover_req.set(st)
                if deposited:
                    # Replicate traffic is dropped while the SM rebuilds
                    # (node.go:1199); flag from deposit, not worker pickup
                    self.ss.set_recovering_from_snapshot()
            if not deposited:
                # requeue WITHOUT signalling: run_snapshot_work re-signals
                # task_ready after draining the slot — self-signalling here
                # would hot-spin the task worker for the whole in-flight
                # snapshot
                self.sm.task_queue.add(st)
                return False
            self.engine.set_snapshot_ready(self.cluster_id)
            return True
        return False

    # ------------------------------------------------------- snapshot drivers
    def _has_snapshot_to_recover(self) -> bool:
        if self.snapshotter is None:
            return False
        ss = self.snapshotter.get_most_recent_snapshot()
        return ss is not None and not ss.is_empty()

    def recover_initial_snapshot(self) -> None:
        """Engine init path: install the newest snapshot before stepping
        (cf. getUninitializedNodeTask node.go:1318-1328). Idempotent under
        racing callers (start_cluster thread + step worker)."""
        with self._init_mu:
            if self.initialized.is_set():
                return
            self._recover_initial_snapshot_locked()
            self.initialized.set()

    def _recover_initial_snapshot_locked(self) -> None:
        t = Task(
            cluster_id=self.cluster_id,
            node_id=self._node_id,
            snapshot_available=True,
        )
        idx = self.sm.recover_from_snapshot(t)
        if idx > 0:
            self.peer.notify_raft_last_applied(self.sm.last_applied_index())

    def _push_install_snapshot(self, ss: Snapshot) -> None:
        """A snapshot arrived through the protocol (InstallSnapshot path):
        recover the SM from it (cf. node.go:950-965 processSnapshot)."""
        t = Task(
            cluster_id=self.cluster_id,
            node_id=self._node_id,
            index=ss.index,
            snapshot_available=True,
            init_done=True,
        )
        self.sm.task_queue.add(t)
        self.engine.set_task_ready(self.cluster_id)

    def push_take_snapshot_request(self, req: SSRequest) -> None:
        t = Task(
            cluster_id=self.cluster_id,
            node_id=self._node_id,
            snapshot_requested=True,
            ss_request=req,
        )
        self.sm.task_queue.add(t)
        self.engine.set_task_ready(self.cluster_id)

    def _snapshot_busy(self) -> bool:
        # taking OR recovering: both make concurrent Replicate application
        # unsafe/worthless (cf. node.go:1199)
        return self.ss.busy()

    def _save_snapshot_required(self, ud: Update) -> None:
        """Periodic snapshot trigger by applied-entry count
        (cf. node.go:585-601 saveSnapshotRequired)."""
        se = self.config.snapshot_entries
        if se == 0 or self.snapshotter is None:
            return
        if self._applied_since_snapshot < se:
            return
        if self.ss.taking_snapshot():
            return
        self.ss.set_taking_snapshot()
        self._applied_since_snapshot = 0
        self.push_take_snapshot_request(SSRequest())

    def run_snapshot_work(self) -> None:
        """Executed on a snapshot worker: drain the FSM's request slots and
        any deferred log compaction (cf. execengine.go:227-335 snapshot
        worker mains + snapshotstate.go req slots)."""
        did = False
        task, had = self.ss.save_req.take()
        if had:
            did = True
            self._do_save_snapshot(task.ss_request or SSRequest())
        task, had = self.ss.recover_req.take()
        if had:
            did = True
            self._do_recover_snapshot(task)
        if did:
            # a snapshot task that raced the occupied slot sits requeued in
            # the task queue; wake the task worker now that the slot drained
            self.engine.set_task_ready(self.cluster_id)
        compact_to = self.ss.get_compact_log_to()
        if compact_to > 0:
            # persistent-log compaction is disk IO: it runs HERE, not under
            # the protocol lock where finalization queued it
            # (cf. snapshotstate.go compactLogTo + node.go:849-867)
            self.logdb.remove_entries_to(
                self.cluster_id, self._node_id, compact_to
            )

    def _do_save_snapshot(self, req: SSRequest) -> None:
        """IO half of a save, on the snapshot worker; the result lands in
        the save_completed slot and the step loop finalizes it under the
        protocol lock (_process_snapshot_status) — log-reader mutations
        from this thread would race concurrent steps."""
        self.ss.set_taking_snapshot()
        ss = None
        failed = ignored = False
        try:
            if self.snapshotter is None:
                ignored = True
            else:
                ss, env = self.sm.save_snapshot(req)
                self.snapshotter.commit(ss, req)
        except Exception:
            failed = True
        self.ss.save_completed.put((ss, req, failed, ignored))
        self._notify_snapshot_status()

    def _notify_snapshot_status(self) -> None:
        """Route completed snapshot work back to whichever loop owns this
        node's protocol state (scalar: the step worker; vector override:
        the engine loop)."""
        self.engine.set_node_ready(self.cluster_id)

    def _process_snapshot_status(self) -> None:
        """Finalize completed snapshot work; caller holds the protocol
        lock (cf. node.go processSaveStatus)."""
        for t in self.ss.save_completed.take_all():
            ss, req, failed, ignored = t
            try:
                if ignored or failed:
                    self.pending_snapshot.apply(
                        0, ignored=ignored, failed=failed
                    )
                    continue
                if not req.is_exported():
                    # exported snapshots leave the node's own history
                    # alone: no logdb record was written, so advancing the
                    # log reader / compacting here would delete entries
                    # the node still needs to replay (cf. nodehost.go
                    # exported path)
                    self.log_reader.create_snapshot(ss)
                    self._compact_log(ss, req)
                self.ss.set_snapshot_index(ss.index)
                self.pending_snapshot.apply(ss.index, ignored=False)
            except Exception:
                # a finalization fault (logdb/log-reader IO) must surface
                # as a failed request, not a silent timeout
                self.pending_snapshot.apply(0, ignored=False, failed=True)
            finally:
                self.ss.clear_taking_snapshot()

    def _do_recover_snapshot(self, task: Task) -> None:
        try:
            idx = self.sm.recover_from_snapshot(task)
            if idx > 0:
                ss = self.snapshotter.get_most_recent_snapshot()
                if ss is not None and not ss.is_empty():
                    # the log window moved to the snapshot on the step
                    # thread that installed it (process_raft_update); moving
                    # it again here would drop the entries that thread has
                    # appended above the snapshot since, and its next
                    # append would leave a log hole
                    with self._mu:
                        self.peer.restore_remotes(ss)
                        self.peer.notify_raft_last_applied(
                            self.sm.last_applied_index()
                        )
                self.clear_install_aborted()
        finally:
            self.ss.clear_recovering_from_snapshot()

    def _compact_log(self, ss: Snapshot, req: SSRequest) -> None:
        """Keep compaction_overhead entries behind the snapshot
        (cf. node.go:680-693 + 849-867). Caller holds _mu — the in-memory
        log-reader mutation must be exclusive with protocol steps; the
        persistent-log removal is disk IO and is deferred to a snapshot
        worker through compact_log_to."""
        overhead = (
            req.compaction_overhead
            if req is not None and req.override_compaction
            else self.config.compaction_overhead
        )
        if overhead == 0:
            return
        if ss.index <= overhead:
            return
        compact_to = ss.index - overhead
        try:
            self.log_reader.compact(compact_to)
        except ErrCompacted:
            return  # already compacted past this point: benign
        self.ss.set_compact_log_to(compact_to)
        self.engine.set_snapshot_ready(self.cluster_id)

    # ---------------------------------------------------------------- events
    def _make_raft_event_adapter(self):
        node = self

        class _Adapter:
            def leader_updated(self, cluster_id, node_id, leader_id, term):
                if leader_id != node._leader_id:
                    node._leader_change_tick = node.clock.tick
                node._leader_id = leader_id
                node._current_term = term
                if node.events is not None:
                    node.events.leader_updated(cluster_id, node_id, leader_id, term)

            def __getattr__(self, name):
                # forward the full event vocabulary (campaign_launched,
                # proposal_dropped, ... cf. internal/server/event.go:75-83)
                if node.events is not None:
                    return getattr(node.events, name)

                def noop(*a, **k):
                    return None

                return noop

        return _Adapter()

    def get_leader_id(self):
        with self._mu:
            st = self.peer.local_status()
        return st["leader_id"]

    def local_status(self):
        with self._mu:
            return self.peer.local_status()

    # -------------------------------------------------------------- shutdown
    def close(self) -> None:
        self.stopped = True
        self.incoming_proposals.close()
        self.incoming_reads.close()
        self.mq.close()
        self.pending_proposals.close()
        self.pending_read_indexes.close()
        self.pending_config_change.close()
        self.pending_snapshot.close()
        with self._batch_mu:
            handles = list(self._batches.values())
            self._batches.clear()
        for h in handles:
            h.expire()
        self.sm.offloaded()


__all__ = ["Node"]
