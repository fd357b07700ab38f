"""Device state layout for the vectorized Raft kernel (PyTorch).

All protocol state lives in int32/bool struct-of-arrays over a fixed
(G groups, P peers) shape. Node identity on device is the *peer slot*
(0..P-1); the host keeps the slot <-> 64-bit node-id mapping per group.
Vote/leader fields store slot+1 with 0 meaning "none".

Log entries never carry payloads on device: the ring buffer log_term[G, W]
holds per-entry term metadata only (slot = index % W). Indexes are int32
*rebased* values: the host owns a 64-bit base per group and calls `rebase`
before any index nears 2**31.

The tensors are torch tensors on an explicit device. Field order and dtypes
match the JAX package's `dragonboat_tpu.ops.state` one for one: int32 for
i32 fields, torch.bool for bool fields, torch.uint32 for `seed` and
`counters`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ROLE:
    """Replica roles (PRE_CANDIDATE extends the table for pre-vote)."""

    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2
    OBSERVER = 3
    WITNESS = 4
    PRE_CANDIDATE = 5


class RSTATE:
    """Per-follower flow control FSM."""

    RETRY = 0
    WAIT = 1
    REPLICATE = 2
    SNAPSHOT = 3


class MSG:
    """Kernel message types; the numbering is the wire MessageType's."""

    NONE = -1  # empty inbox slot
    LOCAL_TICK = 0
    ELECTION = 1
    LEADER_HEARTBEAT = 2
    NOOP = 4
    PROPOSE = 7
    SNAPSHOT_STATUS = 8
    UNREACHABLE = 9
    CHECK_QUORUM = 10
    REPLICATE = 12
    REPLICATE_RESP = 13
    REQUEST_VOTE = 14
    REQUEST_VOTE_RESP = 15
    INSTALL_SNAPSHOT = 16
    HEARTBEAT = 17
    HEARTBEAT_RESP = 18
    READ_INDEX = 19
    READ_INDEX_RESP = 20
    LEADER_TRANSFER = 23
    TIMEOUT_NOW = 24
    REQUEST_PREVOTE = 26
    REQUEST_PREVOTE_RESP = 27


# send_flags bits in StepOutput
SEND_REPLICATE = 1
SEND_HEARTBEAT = 2
SEND_VOTE_REQ = 4
SEND_TIMEOUT_NOW = 8
NEED_SNAPSHOT = 16


class CTR:
    """Slots of the per-lane event-counter plane (StepOutput.counters
    [:, CTR.*], u32 per-step deltas)."""

    ELECTIONS_STARTED = 0  # real campaigns (pre-vote polls excluded)
    ELECTIONS_WON = 1  # become-leader transitions
    HEARTBEATS_SENT = 2  # per-target heartbeat sends (tick + readindex)
    REPLICATE_REJECTS = 3  # Replicate messages rejected (log mismatch)
    COMMIT_ADVANCES = 4  # commit index units advanced (leader + follower)
    LEASE_SERVED = 5  # reads served locally off a live lease
    LEASE_FALLBACK = 6  # lease-on reads that fell back to quorum
    READ_CONFIRMED = 7  # readindex confirmations delivered (ready pops)
    COUNT = 8


#: stats key per CTR slot, in slot order
CTR_NAMES = (
    "elections_started",
    "elections_won",
    "heartbeats_sent",
    "replicate_rejects",
    "commit_advances",
    "lease_served",
    "lease_fallback",
    "read_confirmations",
)


class KernelConfig(NamedTuple):
    """Static shape configuration of the kernel."""

    groups: int = 1024  # G
    peers: int = 8  # P (max replicas per group incl. observers/witnesses)
    log_window: int = 512  # W (device-resident per-group log metadata window)
    inbox_depth: int = 8  # K (messages consumed per group per step)
    max_entries_per_msg: int = 8  # E (entries attached to one Replicate)
    readindex_depth: int = 4  # R (outstanding ReadIndex ctx per group)


class RaftTensors(NamedTuple):
    """The complete protocol state of G groups as tensors."""

    # identity / membership
    active: torch.Tensor  # bool[G] lane holds a live replica
    self_slot: torch.Tensor  # i32[G] this replica's peer slot
    member: torch.Tensor  # bool[G,P] slot holds any member
    voting: torch.Tensor  # bool[G,P] slot is a voting member (full or witness)
    observer: torch.Tensor  # bool[G,P]
    witness: torch.Tensor  # bool[G,P]
    # durable raft state
    term: torch.Tensor  # i32[G]
    vote: torch.Tensor  # i32[G] slot+1, 0=none
    # volatile role state
    role: torch.Tensor  # i32[G] ROLE.*
    leader: torch.Tensor  # i32[G] slot+1, 0=none
    # timers (ticks)
    tick_count: torch.Tensor  # i32[G]
    election_tick: torch.Tensor  # i32[G]
    heartbeat_tick: torch.Tensor  # i32[G]
    rand_timeout: torch.Tensor  # i32[G] randomized election timeout
    election_timeout: torch.Tensor  # i32[G] per-group config
    heartbeat_timeout: torch.Tensor  # i32[G]
    check_quorum: torch.Tensor  # bool[G]
    prevote_on: torch.Tensor  # bool[G] pre-vote gate
    # leader-lease read gate; tick-denominated, untouched by rebase
    lease_on: torch.Tensor  # bool[G]
    lease_margin: torch.Tensor  # i32[G] clock-skew margin (ticks)
    lease_until: torch.Tensor  # i32[G] lease live while tick_count < this
    hb_round_tick: torch.Tensor  # i32[G] tick tag of the open heartbeat round
    hb_ack_bits: torch.Tensor  # i32[G] bitmask of peer slots acking that round
    clock_ok: torch.Tensor  # bool[G] host clears while the tick clock is suspect
    # log metadata (rebased int32 indexes)
    first_index: torch.Tensor  # i32[G] lowest index with term in the ring
    marker_term: torch.Tensor  # i32[G] term at first_index-1
    last_index: torch.Tensor  # i32[G]
    committed: torch.Tensor  # i32[G]
    processed: torch.Tensor  # i32[G] committed entries already handed to engine
    applied: torch.Tensor  # i32[G] applied index confirmed by the RSM
    unsaved_from: torch.Tensor  # i32[G] first index not yet persisted by engine
    log_term: torch.Tensor  # i32[G,W] ring: term of entry at index i in slot i%W
    log_is_cc: torch.Tensor  # bool[G,W] ring: entry is a config change
    # leader replication bookkeeping
    match: torch.Tensor  # i32[G,P]
    next: torch.Tensor  # i32[G,P]
    rstate: torch.Tensor  # i32[G,P] RSTATE.*
    ract: torch.Tensor  # bool[G,P] active flag for check-quorum
    snap_sent: torch.Tensor  # i32[G,P] pending snapshot index per peer
    # election bookkeeping
    vresp: torch.Tensor  # bool[G,P] peer responded to vote request
    vgrant: torch.Tensor  # bool[G,P] peer granted vote
    # leadership transfer
    transfer_to: torch.Tensor  # i32[G] slot+1, 0=none
    transfer_flag: torch.Tensor  # bool[G] this node is a sanctioned transfer target
    # membership change guard
    pending_cc: torch.Tensor  # bool[G] uncommitted config change in flight
    # quiesce
    quiesce_on: torch.Tensor  # bool[G] per-lane config enable
    quiesce_threshold: torch.Tensor  # i32[G] idle ticks before entering
    quiesced: torch.Tensor  # bool[G]
    idle_ticks: torch.Tensor  # i32[G] ticks since last non-heartbeat activity
    # read index queue (FIFO of R slots, ctx 0 = empty)
    ri_ctx: torch.Tensor  # i32[G,R]
    ri_ctx2: torch.Tensor  # i32[G,R]
    ri_index: torch.Tensor  # i32[G,R]
    ri_acks: torch.Tensor  # i32[G,R] bitmask of peer slots that acked
    ri_count: torch.Tensor  # i32[G] live queue length
    # randomness
    seed: torch.Tensor  # u32[G]


class Inbox(NamedTuple):
    """K inbound messages per group per step; empty slots have mtype NONE."""

    mtype: torch.Tensor  # i32[G,K]
    from_slot: torch.Tensor  # i32[G,K]
    term: torch.Tensor  # i32[G,K]
    log_index: torch.Tensor  # i32[G,K]
    log_term: torch.Tensor  # i32[G,K]
    commit: torch.Tensor  # i32[G,K]
    reject: torch.Tensor  # bool[G,K]
    hint: torch.Tensor  # i32[G,K]
    hint_high: torch.Tensor  # i32[G,K] upper half of a readindex ctx
    n_entries: torch.Tensor  # i32[G,K]
    entry_terms: torch.Tensor  # i32[G,K,E]
    entry_cc: torch.Tensor  # bool[G,K,E]


class StepOutput(NamedTuple):
    """Per-step engine directives (same planes as the JAX package)."""

    send_flags: torch.Tensor  # i32[G,P] bitmask SEND_*
    send_prev_index: torch.Tensor  # i32[G,P]
    send_prev_term: torch.Tensor  # i32[G,P]
    send_n_entries: torch.Tensor  # i32[G,P]
    send_commit: torch.Tensor  # i32[G,P]
    send_hb_commit: torch.Tensor  # i32[G,P]
    send_hint: torch.Tensor  # i32[G,P]
    send_hint2: torch.Tensor  # i32[G,P]
    vote_last_index: torch.Tensor  # i32[G]
    vote_last_term: torch.Tensor  # i32[G]
    resp_type: torch.Tensor  # i32[G,K]
    resp_to: torch.Tensor  # i32[G,K]
    resp_term: torch.Tensor  # i32[G,K]
    resp_log_index: torch.Tensor  # i32[G,K]
    resp_reject: torch.Tensor  # bool[G,K]
    resp_hint: torch.Tensor  # i32[G,K]
    resp_hint2: torch.Tensor  # i32[G,K]
    save_from: torch.Tensor  # i32[G]
    save_to: torch.Tensor  # i32[G]
    apply_from: torch.Tensor  # i32[G]
    apply_to: torch.Tensor  # i32[G]
    commit_index: torch.Tensor  # i32[G]
    hard_changed: torch.Tensor  # bool[G]
    ready_ctx: torch.Tensor  # i32[G,R]
    ready_ctx2: torch.Tensor  # i32[G,R]
    ready_index: torch.Tensor  # i32[G,R]
    ready_count: torch.Tensor  # i32[G]
    dropped_propose: torch.Tensor  # i32[G]
    dropped_cc: torch.Tensor  # bool[G]
    fwd_leader: torch.Tensor  # i32[G]
    noop_appended: torch.Tensor  # i32[G]
    noop_term: torch.Tensor  # i32[G]
    log_full: torch.Tensor  # bool[G]
    prop_base: torch.Tensor  # i32[G,K]
    rep_base: torch.Tensor  # i32[G,K]
    leader: torch.Tensor  # i32[G]
    term: torch.Tensor  # i32[G]
    vote: torch.Tensor  # i32[G]
    role: torch.Tensor  # i32[G]
    match: torch.Tensor  # i32[G,P]
    rstate: torch.Tensor  # i32[G,P]
    last_index: torch.Tensor  # i32[G]
    quiesced: torch.Tensor  # bool[G]
    lease_round: torch.Tensor  # i32[G]
    lease_served: torch.Tensor  # i32[G]
    lease_fallback: torch.Tensor  # i32[G]
    lease_ok: torch.Tensor  # bool[G]
    counters: torch.Tensor  # u32[G, CTR.COUNT]


class RoutePlan(NamedTuple):
    """Which of a step's outbound messages the on-device router placed into
    a co-hosted destination lane's next-step inbox (multi_step_batch). A
    candidate that could not route (no co-hosted lane, inbox overflow,
    below-window reject) stays False and falls back to the host path."""

    rep: torch.Tensor  # bool[G,P] SEND_REPLICATE routed
    vote: torch.Tensor  # bool[G,P] SEND_VOTE_REQ routed
    hb: torch.Tensor  # bool[G,P] SEND_HEARTBEAT routed
    tn: torch.Tensor  # bool[G,P] SEND_TIMEOUT_NOW routed
    resp: torch.Tensor  # bool[G,K] response-plane slot routed
    rir: torch.Tensor  # bool[G,R] confirmed forwarded-read resp routed


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. It is the card unless the caller
    names the CPU; asking for the card where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU"
        )
    return dev


def init_state(cfg: KernelConfig, device="cuda") -> RaftTensors:
    dev = resolve_device(device)
    G, P, W, R = cfg.groups, cfg.peers, cfg.log_window, cfg.readindex_depth
    i32 = torch.int32
    z_g = lambda: torch.zeros((G,), dtype=i32, device=dev)
    z_gp = lambda: torch.zeros((G, P), dtype=i32, device=dev)
    f_g = lambda: torch.zeros((G,), dtype=torch.bool, device=dev)
    f_gp = lambda: torch.zeros((G, P), dtype=torch.bool, device=dev)
    full_g = lambda v: torch.full((G,), v, dtype=i32, device=dev)
    seed = (torch.arange(1, G + 1, dtype=torch.int64) * 2654435761) & 0xFFFFFFFF
    return RaftTensors(
        active=f_g(),
        self_slot=z_g(),
        member=f_gp(),
        voting=f_gp(),
        observer=f_gp(),
        witness=f_gp(),
        term=z_g(),
        vote=z_g(),
        role=z_g(),
        leader=z_g(),
        tick_count=z_g(),
        election_tick=z_g(),
        heartbeat_tick=z_g(),
        rand_timeout=full_g(10),
        election_timeout=full_g(10),
        heartbeat_timeout=full_g(1),
        check_quorum=f_g(),
        prevote_on=f_g(),
        lease_on=f_g(),
        lease_margin=z_g(),
        lease_until=z_g(),
        hb_round_tick=z_g(),
        hb_ack_bits=z_g(),
        clock_ok=torch.ones((G,), dtype=torch.bool, device=dev),
        first_index=full_g(1),
        marker_term=z_g(),
        last_index=z_g(),
        committed=z_g(),
        processed=z_g(),
        applied=z_g(),
        unsaved_from=full_g(1),
        log_term=torch.zeros((G, W), dtype=i32, device=dev),
        log_is_cc=torch.zeros((G, W), dtype=torch.bool, device=dev),
        match=z_gp(),
        next=torch.ones((G, P), dtype=i32, device=dev),
        rstate=z_gp(),
        ract=f_gp(),
        snap_sent=z_gp(),
        vresp=f_gp(),
        vgrant=f_gp(),
        transfer_to=z_g(),
        transfer_flag=f_g(),
        pending_cc=f_g(),
        quiesce_on=f_g(),
        quiesce_threshold=full_g(100),
        quiesced=f_g(),
        idle_ticks=z_g(),
        ri_ctx=torch.zeros((G, R), dtype=i32, device=dev),
        ri_ctx2=torch.zeros((G, R), dtype=i32, device=dev),
        ri_index=torch.zeros((G, R), dtype=i32, device=dev),
        ri_acks=torch.zeros((G, R), dtype=i32, device=dev),
        ri_count=z_g(),
        seed=seed.to(torch.uint32).to(dev),
    )


def make_empty_inbox(cfg: KernelConfig, device="cuda") -> Inbox:
    dev = resolve_device(device)
    G, K, E = cfg.groups, cfg.inbox_depth, cfg.max_entries_per_msg
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return Inbox(
        mtype=torch.full((G, K), MSG.NONE, dtype=torch.int32, device=dev),
        from_slot=z(G, K),
        term=z(G, K),
        log_index=z(G, K),
        log_term=z(G, K),
        commit=z(G, K),
        reject=torch.zeros((G, K), dtype=torch.bool, device=dev),
        hint=z(G, K),
        hint_high=z(G, K),
        n_entries=z(G, K),
        entry_terms=z(G, K, E),
        entry_cc=torch.zeros((G, K, E), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------- host side


def configure_group(
    state: RaftTensors,
    g: int,
    self_slot: int,
    voting_slots,
    observer_slots=(),
    witness_slots=(),
    election_timeout: int = 10,
    heartbeat_timeout: int = 1,
    check_quorum: bool = False,
    is_observer: bool = False,
    is_witness: bool = False,
    prevote: bool = False,
    lease_read: bool = False,
    lease_margin: int = 0,
) -> RaftTensors:
    """Activate lane g with the given membership (StartCluster / config
    change). The lane's rows are written in place with device-side indexing
    and the randomized timeout is mixed on the device, so nothing is read
    back to the host. Returns the same state, updated."""
    P = state.member.shape[1]
    member = np.zeros((P,), bool)
    voting = np.zeros((P,), bool)
    observer = np.zeros((P,), bool)
    witness = np.zeros((P,), bool)
    for s in voting_slots:
        member[s] = voting[s] = True
    for s in observer_slots:
        member[s] = observer[s] = True
    for s in witness_slots:
        member[s] = voting[s] = witness[s] = True
    role = (
        ROLE.OBSERVER if is_observer else ROLE.WITNESS if is_witness else ROLE.FOLLOWER
    )
    dev = state.member.device
    rows = torch.from_numpy(np.stack([member, voting, observer, witness])).to(dev)
    state.member[g] = rows[0]
    state.voting[g] = rows[1]
    state.observer[g] = rows[2]
    state.witness[g] = rows[3]
    x = _mix_t(state.seed[g : g + 1].to(torch.int64), 0, self_slot)
    state.rand_timeout[g : g + 1] = (election_timeout + x % election_timeout).to(
        torch.int32
    )
    for name, v in (
        ("active", True),
        ("self_slot", self_slot),
        ("role", role),
        ("election_timeout", election_timeout),
        ("heartbeat_timeout", heartbeat_timeout),
        ("check_quorum", check_quorum),
        ("prevote_on", prevote),
        ("lease_on", lease_read),
        ("lease_margin", lease_margin),
    ):
        getattr(state, name)[g] = v
    return state


def configure_groups_uniform(
    state: RaftTensors,
    self_slot: int,
    voting_slots,
    election_timeout: int = 10,
    heartbeat_timeout: int = 1,
    check_quorum: bool = False,
    prevote: bool = False,
    lease_read: bool = False,
    lease_margin: int = 0,
) -> RaftTensors:
    """Configure ALL lanes with identical membership shape in whole-plane
    writes (the bulk path benchmarks and fleet bring-up use)."""
    G, P = state.member.shape
    dev = state.member.device
    member = torch.zeros((P,), dtype=torch.bool)
    for s in voting_slots:
        member[s] = True
    member = member.to(dev)
    x = _mix_t(state.seed.to(torch.int64), 0, self_slot)
    rand_to = (election_timeout + x % election_timeout).to(torch.int32)
    full = lambda v, dt: torch.full((G,), v, dtype=dt, device=dev)
    return state._replace(
        active=full(True, torch.bool),
        self_slot=full(self_slot, torch.int32),
        member=member.expand(G, P).clone(),
        voting=member.expand(G, P).clone(),
        observer=torch.zeros((G, P), dtype=torch.bool, device=dev),
        witness=torch.zeros((G, P), dtype=torch.bool, device=dev),
        role=full(ROLE.FOLLOWER, torch.int32),
        election_timeout=full(election_timeout, torch.int32),
        heartbeat_timeout=full(heartbeat_timeout, torch.int32),
        rand_timeout=rand_to,
        check_quorum=full(check_quorum, torch.bool),
        prevote_on=full(prevote, torch.bool),
        lease_on=full(lease_read, torch.bool),
        lease_margin=full(lease_margin, torch.int32),
    )


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) (a tensor or an int):
    the product is split at 16 bits so no partial product leaves the int64
    range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _mix_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """_mix on int64 tensors holding u32 values (b and c may be ints or
    tensors of any sign: they are taken modulo 2**32 first)."""
    M = 0xFFFFFFFF
    x = _mul32(a & M, 2654435761) ^ _mul32(b & M, 40503) ^ _mul32(c & M, 2246822519)
    x = x ^ (x >> 15)
    x = _mul32(x, 2246822519)
    return x ^ (x >> 13)


def lane_seed(g: int) -> int:
    """Host-side replica of init_state's per-lane PRNG seed."""
    return ((g + 1) * 2654435761) & 0xFFFFFFFF


def _mix(a, b, c):
    """Cheap deterministic integer mix (xorshift-multiply), used for
    randomized election timeouts; u32 wraparound in Python ints."""
    M = 0xFFFFFFFF
    x = ((int(a) * 2654435761) ^ (int(b) * 40503) ^ (int(c) * 2246822519)) & M
    x ^= x >> 15
    x = (x * 2246822519) & M
    x ^= x >> 13
    return x


def rebase(state: RaftTensors, delta) -> RaftTensors:
    """Subtract delta[G] from every index-valued tensor; ring slots are
    invariant when delta % W == 0."""
    d = torch.as_tensor(delta, dtype=torch.int32, device=state.first_index.device)
    dp = d[:, None]
    return state._replace(
        first_index=state.first_index - d,
        last_index=state.last_index - d,
        committed=state.committed - d,
        processed=state.processed - d,
        applied=state.applied - d,
        unsaved_from=state.unsaved_from - d,
        match=torch.clamp(state.match - dp, min=0),
        next=torch.clamp(state.next - dp, min=1),
        snap_sent=torch.clamp(state.snap_sent - dp, min=0),
        ri_index=torch.clamp(state.ri_index - dp, min=0),
    )
