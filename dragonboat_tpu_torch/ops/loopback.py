"""In-process multi-replica simulation over the vectorized kernel.

Runs N kernel instances (one per simulated NodeHost; replica h owns peer
slot h of every group) and routes StepOutput send-descriptors/responses into
the peers' inboxes each round: the template for the real engine's message
routing, and the harness that drives the kernel end to end.

Routing is host-side numpy. Each replica's StepOutput is fetched once per
round, one copy per plane, and only the messages that exist are visited;
the per-(replica, group) message order is the JAX package's LoopbackCluster
order, so a seeded run here matches one there step for step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .state import (
    CTR,
    MSG,
    NEED_SNAPSHOT,
    ROLE,
    SEND_HEARTBEAT,
    SEND_REPLICATE,
    SEND_TIMEOUT_NOW,
    SEND_VOTE_REQ,
    Inbox,
    KernelConfig,
    RaftTensors,
    configure_group,
    init_state,
    resolve_device,
)
from .kernel import make_step_fn


@dataclass
class Msg:
    """Host-side message record (the loopback 'wire' format)."""

    mtype: int
    from_slot: int
    term: int = 0
    log_index: int = 0
    log_term: int = 0
    commit: int = 0
    reject: bool = False
    hint: int = 0
    hint_high: int = 0
    n_entries: int = 0
    entry_terms: Tuple[int, ...] = ()
    entry_cc: Tuple[bool, ...] = ()


_INBOX_INT_FIELDS = (
    "from_slot", "term", "log_index", "log_term", "commit", "hint",
    "hint_high", "n_entries",
)
_OUT_PLANES = (
    "send_flags", "send_prev_index", "send_prev_term", "send_n_entries",
    "send_commit", "send_hb_commit", "send_hint", "send_hint2",
    "vote_last_index", "vote_last_term", "resp_type", "resp_to", "resp_term",
    "resp_log_index", "resp_reject", "resp_hint", "resp_hint2", "ready_ctx",
    "ready_ctx2", "ready_index", "ready_count", "lease_round", "counters",
)


class LoopbackCluster:
    def __init__(
        self,
        n_replicas: int = 3,
        n_groups: int = 2,
        cfg: Optional[KernelConfig] = None,
        election: int = 10,
        heartbeat: int = 2,
        check_quorum: bool = False,
        witnesses: Tuple[int, ...] = (),
        observers: Tuple[int, ...] = (),
        seed: int = 1,
        prevote: bool = False,
        lease_read: bool = False,
        lease_margin: int = 0,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or KernelConfig(
            groups=n_groups, peers=max(n_replicas, 2), inbox_depth=8
        )
        assert n_replicas <= self.cfg.peers
        self.n_replicas = n_replicas
        self.n_groups = n_groups
        self.step_fn = make_step_fn(self.cfg, donate=False)
        voting = [r for r in range(n_replicas) if r not in observers]
        self.states: List[RaftTensors] = []
        for h in range(n_replicas):
            st = init_state(self.cfg, device=self.device)
            offset = (seed * 7919) & 0xFFFFFFFF
            seeds = (st.seed.to(torch.int64) + offset) & 0xFFFFFFFF
            st = st._replace(seed=seeds.to(torch.uint32))
            for g in range(n_groups):
                st = configure_group(
                    st,
                    g,
                    self_slot=h,
                    voting_slots=[v for v in voting if v not in witnesses],
                    observer_slots=list(observers),
                    witness_slots=list(witnesses),
                    election_timeout=election,
                    heartbeat_timeout=heartbeat,
                    check_quorum=check_quorum,
                    is_observer=h in observers,
                    is_witness=h in witnesses,
                    prevote=prevote,
                    lease_read=lease_read,
                    lease_margin=lease_margin,
                )
            self.states.append(st)
        # pending[replica][group] = list of Msg
        self.pending: List[List[List[Msg]]] = [
            [[] for _ in range(n_groups)] for _ in range(n_replicas)
        ]
        self.dropped_links: set = set()  # (from_replica, to_replica)
        self.isolated: set = set()
        self.last_outputs = [None] * n_replicas
        self.ready_reads: List[List[Tuple[int, int, int, int]]] = [
            [] for _ in range(n_replicas)
        ]
        self.snapshot_requests: List[Tuple[int, int, int]] = []
        # cumulative event-counter plane per replica
        self.counters: List[np.ndarray] = [
            np.zeros((self.cfg.groups, CTR.COUNT), np.uint64)
            for _ in range(n_replicas)
        ]

    # ------------------------------------------------------------ injection
    def propose(self, replica: int, group: int, n: int = 1, cc_first: bool = False):
        assert not (cc_first and n != 1), "config change must be a lone entry"
        cc = tuple(cc_first if i == 0 else False for i in range(n))
        self.pending[replica][group].append(
            Msg(MSG.PROPOSE, from_slot=replica, n_entries=n, entry_cc=cc)
        )

    def read_index(self, replica: int, group: int, ctx: int, ctx_high: int = 0):
        self.pending[replica][group].append(
            Msg(MSG.READ_INDEX, from_slot=replica, hint=ctx, hint_high=ctx_high)
        )

    def transfer_leader(self, replica: int, group: int, target_slot: int):
        self.pending[replica][group].append(
            Msg(MSG.LEADER_TRANSFER, from_slot=replica, hint=target_slot + 1)
        )

    # ------------------------------------------------------------ stepping
    def _pack_inbox(self, replica: int) -> Inbox:
        cfg = self.cfg
        G, K, E = cfg.groups, cfg.inbox_depth, cfg.max_entries_per_msg
        mtype = np.full((G, K), MSG.NONE, np.int32)
        arr = {f: np.zeros((G, K), np.int32) for f in _INBOX_INT_FIELDS}
        reject = np.zeros((G, K), bool)
        eterms = np.zeros((G, K, E), np.int32)
        ecc = np.zeros((G, K, E), bool)
        queues = self.pending[replica]
        for g in range(self.n_groups):
            q = queues[g]
            if not q:
                continue
            take = q[:K]
            queues[g] = q[K:]
            for k, m in enumerate(take):
                mtype[g, k] = m.mtype
                for f in _INBOX_INT_FIELDS:
                    v = getattr(m, f)
                    if v:
                        arr[f][g, k] = v
                reject[g, k] = m.reject
                if m.entry_terms:
                    t = m.entry_terms[:E]
                    eterms[g, k, : len(t)] = t
                if m.entry_cc:
                    c = m.entry_cc[:E]
                    ecc[g, k, : len(c)] = c
        dev = self.device
        put = lambda a: torch.from_numpy(a).to(dev)
        return Inbox(
            mtype=put(mtype), reject=put(reject), entry_terms=put(eterms),
            entry_cc=put(ecc), **{f: put(arr[f]) for f in _INBOX_INT_FIELDS},
        )

    def _route(self, h: int, o: Dict[str, np.ndarray], st: Dict[str, np.ndarray]) -> None:
        """Convert replica h's StepOutput (numpy planes) into peer inbox
        messages, in the order a per-group, per-peer walk would give."""
        W = self.cfg.log_window
        term, role = st["term"], st["role"]
        ring, ring_cc = st["log_term"], st["log_is_cc"]
        flags = o["send_flags"]
        n = self.n_replicas
        for g in np.nonzero(o["ready_count"][: self.n_groups] > 0)[0]:
            for j in range(int(o["ready_count"][g])):
                self.ready_reads[h].append(
                    (int(g), int(o["ready_ctx"][g, j]), int(o["ready_index"][g, j]),
                     int(o["ready_ctx2"][g, j]))
                )
        # the destination queue (p, g) receives at most one descriptor of
        # each kind from h, so a kind-major walk keeps the per-queue order
        live = flags[: self.n_groups, :n].copy()
        live[:, h] = 0
        for bit in (SEND_REPLICATE, SEND_HEARTBEAT, SEND_VOTE_REQ,
                    SEND_TIMEOUT_NOW, NEED_SNAPSHOT):
            gs, ps = np.nonzero(live & bit)
            for g, p in zip(gs.tolist(), ps.tolist()):
                if bit == SEND_REPLICATE:
                    k = int(o["send_n_entries"][g, p])
                    base = int(o["send_prev_index"][g, p]) + 1
                    slots = [(base + e) % W for e in range(k)]
                    m = Msg(
                        MSG.REPLICATE, from_slot=h, term=int(term[g]),
                        log_index=base - 1, log_term=int(o["send_prev_term"][g, p]),
                        commit=int(o["send_commit"][g, p]), n_entries=k,
                        entry_terms=tuple(int(x) for x in ring[g, slots]),
                        entry_cc=tuple(bool(x) for x in ring_cc[g, slots]),
                    )
                elif bit == SEND_HEARTBEAT:
                    m = Msg(
                        MSG.HEARTBEAT, from_slot=h, term=int(term[g]),
                        log_index=int(o["lease_round"][g]),
                        commit=int(o["send_hb_commit"][g, p]),
                        hint=int(o["send_hint"][g, p]),
                        hint_high=int(o["send_hint2"][g, p]),
                    )
                elif bit == SEND_VOTE_REQ:
                    pre = int(role[g]) == ROLE.PRE_CANDIDATE
                    m = Msg(
                        MSG.REQUEST_PREVOTE if pre else MSG.REQUEST_VOTE,
                        from_slot=h,
                        term=int(term[g]) + 1 if pre else int(term[g]),
                        log_index=int(o["vote_last_index"][g]),
                        log_term=int(o["vote_last_term"][g]),
                        hint=int(o["send_hint"][g, p]),
                    )
                elif bit == SEND_TIMEOUT_NOW:
                    m = Msg(MSG.TIMEOUT_NOW, from_slot=h, term=int(term[g]))
                else:
                    self.snapshot_requests.append((h, g, p))
                    continue
                self._deliver(h, p, g, m)
        gs, ks = np.nonzero(o["resp_type"][: self.n_groups] != MSG.NONE)
        for g, k in zip(gs.tolist(), ks.tolist()):
            self._deliver(
                h, int(o["resp_to"][g, k]), g,
                Msg(
                    int(o["resp_type"][g, k]), from_slot=h,
                    term=int(o["resp_term"][g, k]),
                    log_index=int(o["resp_log_index"][g, k]),
                    reject=bool(o["resp_reject"][g, k]),
                    hint=int(o["resp_hint"][g, k]),
                    hint_high=int(o["resp_hint2"][g, k]),
                ),
            )

    def _deliver(self, frm: int, to: int, g: int, m: Msg) -> None:
        if to >= self.n_replicas:
            return
        if (frm, to) in self.dropped_links:
            return
        if frm in self.isolated or to in self.isolated:
            return
        self.pending[to][g].append(m)

    def step(self, tick: bool = True) -> None:
        """One simulation round: every replica consumes its inbox (+optional
        tick), then outputs are routed."""
        fetched = []
        for h in range(self.n_replicas):
            inbox = self._pack_inbox(h)
            ticks = torch.full(
                (self.cfg.groups,), 1 if tick else 0, dtype=torch.int32,
                device=self.device,
            )
            st, out = self.step_fn(self.states[h], inbox, ticks)
            self.states[h] = st
            self.last_outputs[h] = out
            o = {f: getattr(out, f).cpu().numpy() for f in _OUT_PLANES}
            s = {f: getattr(st, f).cpu().numpy()
                 for f in ("term", "role", "log_term", "log_is_cc")}
            self.counters[h] += o["counters"].astype(np.uint64)
            fetched.append((o, s))
        for h in range(self.n_replicas):
            self._route(h, *fetched[h])

    def settle(self, rounds: int = 20) -> None:
        """Drain message queues without ticking."""
        for _ in range(rounds):
            if not any(q for per in self.pending for q in per):
                return
            self.step(tick=False)

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.step(tick=True)
            self.settle()

    # ------------------------------------------------------------ inspection
    def roles(self, g: int = 0) -> List[int]:
        return [int(st.role[g]) for st in self.states]

    def leader_of(self, g: int = 0) -> Optional[int]:
        ls = [h for h, st in enumerate(self.states) if int(st.role[g]) == ROLE.LEADER]
        return ls[0] if len(ls) == 1 else None

    def field(self, name: str, g: int = 0) -> List[int]:
        return [int(getattr(st, name)[g]) for st in self.states]

    def ring_terms(self, h: int, g: int, lo: int, hi: int) -> List[int]:
        W = self.cfg.log_window
        ring = self.states[h].log_term[g].cpu().numpy()
        return [int(ring[i % W]) for i in range(lo, hi + 1)]
