"""Bare-kernel benchmark: the device ceiling of the protocol step.

The counterpart of the JAX package's `bench.py:kernel_step`/`bench_kernel`:
one voting replica per group, so every proposal commits at once, and every
inbox slot of every group carries a full E-entry PROPOSE. Quorum, transport
and fsync are excluded by design; this measures the step kernel alone.

Times come from CUDA events around each step after a warm-up. The module
also carries the byte count of one step (for its bound on the card) and a
seeded random inbox generator used to hold the kernel against its plain
version.

It also builds the config-6 super-step cluster (`superstep_cluster`,
`host_window`, `compact`): config 2's 1024 groups x 3 replicas co-hosted in
one state of 3072 lanes, driven K=8 inner steps per super-step, with the
byte counts of the router and gather kernels (`route_columns_bytes`,
`route_scatter_bytes`, `ring_gather_bytes`) and a seeded random router case
(`random_route_case`).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .ops.kernel import _term_at, step_batch
from .ops.state import (
    MSG,
    ROLE,
    SEND_HEARTBEAT,
    SEND_REPLICATE,
    SEND_TIMEOUT_NOW,
    SEND_VOTE_REQ,
    Inbox,
    KernelConfig,
    RaftTensors,
    StepOutput,
    _mix_t,
    configure_groups_uniform,
    init_state,
    make_empty_inbox,
    resolve_device,
)

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12


def kernel_step(state: RaftTensors, inbox, ticks, cfg: KernelConfig):
    state, out = step_batch(state, inbox, ticks, cfg)
    # engine-side compaction: applied entries leave the device window
    state = state._replace(
        marker_term=_term_at(state, state.applied),
        first_index=state.applied + 1,
    )
    return state, out.commit_index


def bench_config(groups: int, log_window: int) -> KernelConfig:
    return KernelConfig(
        groups=groups, peers=8, log_window=log_window,
        inbox_depth=8, max_entries_per_msg=8, readindex_depth=4,
    )


def propose_inbox(cfg: KernelConfig, device) -> Inbox:
    inbox = make_empty_inbox(cfg, device=device)
    return inbox._replace(
        mtype=torch.full_like(inbox.mtype, MSG.PROPOSE),
        n_entries=torch.full_like(inbox.n_entries, cfg.max_entries_per_msg),
    )


def elected_state(cfg: KernelConfig, device) -> RaftTensors:
    """Every lane a single-voter group whose replica has won its election."""
    state = configure_groups_uniform(init_state(cfg, device=device), self_slot=0,
                                     voting_slots=(0,))
    elect = make_empty_inbox(cfg, device=device)
    elect.mtype[:, 0] = MSG.ELECTION
    ticks = torch.zeros((cfg.groups,), dtype=torch.int32, device=device)
    state, _ = kernel_step(state, elect, ticks, cfg)
    return state


def run_kernel_bench(groups: int, steps: int, warmup: int, log_window: int,
                     device="cuda") -> Dict:
    """Run the propose loop; return the rate, the per-step kernel time (CUDA
    events around each step on the card) and the final state."""
    dev = resolve_device(device)
    cfg = bench_config(groups, log_window)
    G, K, E = cfg.groups, cfg.inbox_depth, cfg.max_entries_per_msg
    state = elected_state(cfg, dev)
    inbox = propose_inbox(cfg, dev)
    ticks = torch.zeros((G,), dtype=torch.int32, device=dev)
    for _ in range(warmup):
        state, commit = kernel_step(state, inbox, ticks, cfg)
    cuda = dev.type == "cuda"
    events = []
    if cuda:
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t0.record()
    w0 = time.perf_counter()
    for _ in range(steps):
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        state, commit = kernel_step(state, inbox, ticks, cfg)
        if cuda:
            e1.record()
            events.append((e0, e1))
    if cuda:
        t1 = torch.cuda.Event(enable_timing=True)
        t1.record()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - w0
    expected = (warmup + steps) * K * E + 1  # +1 leader noop
    final_commit = int(commit.min())
    assert final_commit == expected, (final_commit, expected)
    res = {
        "cfg": cfg, "state": state, "inbox": inbox, "ticks": ticks,
        "proposals": steps * G * K * E, "final_commit": final_commit,
        "wall_s": wall,
    }
    if cuda:
        loop_ms = t0.elapsed_time(t1)
        res["loop_ms_per_step"] = loop_ms / steps
        res["step_ms"] = [a.elapsed_time(b) for a, b in events]
        res["kernel_proposals_per_sec"] = res["proposals"] / (loop_ms / 1e3)
    return res


def bench_kernel(groups: int, steps: int, warmup: int, log_window: int,
                 device="cuda") -> float:
    """Proposals per second of the step kernel (device clock on the card)."""
    res = run_kernel_bench(groups, steps, warmup, log_window, device=device)
    if "kernel_proposals_per_sec" in res:
        return res["kernel_proposals_per_sec"]
    return res["proposals"] / res["wall_s"]


def step_bytes(before: RaftTensors, inbox: Inbox, ticks, out, after: RaftTensors) -> int:
    """The least bytes one step must move, counted from this step's data:
    the inbox's per-slot planes and the ticks read once; of the entry
    planes only what a handler reads (term and cc flag, 5 B, per entry of a
    REPLICATE; the cc flag, 1 B, per entry of a PROPOSE); the state without
    its ring read once, and written back only where an element changed; the
    StepOutput written once; and the ring slots this step touches: each
    newly appended entry written (term + cc, 5 B) and one 4-byte term
    lookup per lane for each of last_index, committed and the quorum index."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    entry = {"entry_terms", "entry_cc"}
    slot_b = nbytes(getattr(inbox, f) for f in Inbox._fields if f not in entry)
    nent = inbox.n_entries.clamp(0, inbox.entry_terms.shape[-1]).to(torch.int64)
    entry_b = (5 * int(nent[inbox.mtype == MSG.REPLICATE].sum())
               + int(nent[inbox.mtype == MSG.PROPOSE].sum()))
    as_i32 = lambda t: t.view(torch.int32) if t.dtype == torch.uint32 else t
    read_b = written_b = 0
    for f in RaftTensors._fields:
        if f in ("log_term", "log_is_cc"):
            continue
        a, b = getattr(before, f), getattr(after, f)
        read_b += a.numel() * a.element_size()
        written_b += int((as_i32(a) != as_i32(b)).sum()) * a.element_size()
    appended = int(torch.clamp(after.last_index - before.last_index, min=0).sum())
    G = before.term.shape[0]
    return (slot_b + entry_b + nbytes([ticks]) + read_b + written_b + nbytes(out)
            + appended * 5 + 3 * 4 * G)


def random_inbox(rng: np.random.Generator, st: Dict[str, np.ndarray],
                 cfg: KernelConfig) -> Dict[str, np.ndarray]:
    """A seeded random inbox for the state `st` (numpy planes) that reaches
    the handlers' edge cases: every message type and empty slots, peer slots
    outside the membership, lower/higher/local terms, log indexes around
    and far outside the window, n_entries up to E, ReadIndex contexts that
    match queued ones, and lease tags echoing the open round."""
    G, P, K, E, R, W = (cfg.groups, cfg.peers, cfg.inbox_depth,
                        cfg.max_entries_per_msg, cfg.readindex_depth, cfg.log_window)
    types = [v for k, v in vars(MSG).items() if k.isupper()]
    term = st["term"][:, None].astype(np.int64)
    last = st["last_index"][:, None].astype(np.int64)
    i32 = lambda a: np.asarray(a).astype(np.int32)
    mtype = i32(rng.choice(types, size=(G, K)))
    mterm = term + rng.integers(-2, 3, size=(G, K))
    mterm[rng.random((G, K)) < 0.2] = 0
    li = last + rng.integers(-4, 4, size=(G, K))
    far = rng.random((G, K)) < 0.1
    li[far] = (last + rng.integers(W, 3 * W, size=(G, K)))[far]
    pick = rng.integers(0, R, size=(G, K))
    use_ctx = rng.random((G, K)) < 0.4
    hint = np.where(use_ctx, np.take_along_axis(st["ri_ctx"], pick, 1),
                    rng.integers(0, P + 2, size=(G, K)))
    hint_high = np.where(use_ctx, np.take_along_axis(st["ri_ctx2"], pick, 1),
                         rng.integers(0, 3, size=(G, K)))
    tag = (rng.random((G, K)) < 0.3) & (mtype == MSG.HEARTBEAT_RESP)
    li = np.where(tag, st["hb_round_tick"][:, None], li)
    nent = rng.integers(0, E + 1, size=(G, K))
    nent[rng.random((G, K)) < 0.3] = E
    return dict(
        mtype=mtype,
        from_slot=i32(rng.integers(-1, P + 2, size=(G, K))),
        term=i32(mterm),
        log_index=i32(li),
        log_term=i32(term + rng.integers(-2, 2, size=(G, K))),
        commit=i32(last + rng.integers(-3, 4, size=(G, K))),
        reject=rng.random((G, K)) < 0.3,
        hint=i32(hint),
        hint_high=i32(hint_high),
        n_entries=i32(nent),
        entry_terms=i32(term[:, :, None] + rng.integers(-1, 1, size=(G, K, E))),
        entry_cc=rng.random((G, K, E)) < 0.15,
    )


# ---------------------------------------------------------------------------
# the config-6 super-step cluster: config 2's co-hosted fleet at K=8
# ---------------------------------------------------------------------------


def superstep_config(groups: int = 1024, replicas: int = 3) -> KernelConfig:
    """The engine shape of config 6 (bench.py:1149-1157: config 2's
    workload at steps_per_sync=8, bench.py:207-222 widths) with all
    replicas co-hosted in one state, as the shared-scope engine holds them
    (bench.py:309-320)."""
    return KernelConfig(groups=groups * replicas, peers=max(replicas, 4), log_window=256,
                        inbox_depth=4, max_entries_per_msg=64, readindex_depth=4)


def superstep_cluster(groups: int, replicas: int, cfg: KernelConfig, device="cuda",
                      election_timeout: int = 300, heartbeat_timeout: int = 30):
    """groups x replicas lanes in ONE state: lane r*groups + j is replica r
    (self slot r) of group j, with slots 0..replicas-1 voting. Returns
    (state, route, rdelta): route[g, p] is the lane of slot p's replica
    (-1 for the lane's own slot and for unused slots) and rdelta is 0 (one
    window base per group). Timeouts follow config 6 (election_rtt=300,
    heartbeat_rtt=30, bench.py:335-336)."""
    dev = resolve_device(device)
    G, P = cfg.groups, cfg.peers
    if G != groups * replicas or replicas > P:
        raise ValueError(f"cfg must hold {groups} x {replicas} lanes of <= {P} slots")
    s = init_state(cfg, device=dev)
    lane = torch.arange(G, dtype=torch.int64, device=dev)
    self_slot = lane // groups
    slots = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    voting = (slots < replicas).expand(G, P).clone()
    x = _mix_t(s.seed.to(torch.int64), 0, self_slot)
    et = election_timeout
    full = lambda v, dt: torch.full((G,), v, dtype=dt, device=dev)
    s = s._replace(
        active=full(True, torch.bool),
        self_slot=self_slot.to(torch.int32),
        member=voting,
        voting=voting.clone(),
        role=full(ROLE.FOLLOWER, torch.int32),
        election_timeout=full(et, torch.int32),
        heartbeat_timeout=full(heartbeat_timeout, torch.int32),
        rand_timeout=(et + x % et).to(torch.int32),
    )
    peer_lane = slots * groups + (lane % groups)[:, None]
    routed = (slots < replicas) & (slots != self_slot[:, None])
    route = torch.where(routed, peer_lane, torch.full_like(peer_lane, -1)).to(torch.int32)
    return s, route.contiguous(), torch.zeros((G, P), dtype=torch.int32, device=dev)


def compact(state: RaftTensors) -> RaftTensors:
    """Engine-side compaction between super-steps, in place: applied entries
    leave the device window (first_index = applied + 1)."""
    state.marker_term.copy_(_term_at(state, state.applied))
    state.first_index.copy_(state.applied + 1)
    return state


def _enc_ctx(origin_slot, low):
    """The engine's two-plane ReadIndex ctx (engine/vector.py:168-185):
    (origin_slot + 1) << 24 | low[0:24] and low[24:55]."""
    return ((origin_slot + 1) << 24) | (low & 0xFFFFFF), (low >> 24) & 0x7FFFFFFF


def host_window(window: int, resid_count: torch.Tensor, leaders: np.ndarray, groups: int,
                replicas: int, cfg: KernelConfig, rng: np.random.Generator,
                device="cuda"):
    """The host events of one super-step of the config-6 scenario, packed
    at each lane's first free slot after its residual rows (as the engine's
    _pack does and tests/test_multistep.py:437-475 mirror); an event that
    finds no free slot is dropped. Reads `resid_count` back once (the
    engine's one D2H per super-step). `leaders[j]` is the lane the host
    believes leads group j; returns (inbox, leaders after this window).

    Window 0 elects replica 0 of every group. Every later window proposes
    n_entries in [1, E] (16 B payloads on the host) at each leader lane;
    windows 3, 5 and 7 add a READ_INDEX at each leader lane whose ctx names
    a follower slot as origin, so its confirmation routes back as a
    forwarded read; window 4 campaigns replica 1 of a quarter of the groups
    (a leader change mid-window, no proposal there); window 6 asks an
    eighth of the leaders to transfer leadership to the next replica."""
    G, K, E = cfg.groups, cfg.inbox_depth, cfg.max_entries_per_msg
    count = resid_count.cpu().numpy().astype(np.int64)
    planes = {
        "mtype": np.full((G, K), MSG.NONE, np.int32),
        **{f: np.zeros((G, K), np.int32) for f in
           ("from_slot", "term", "log_index", "log_term", "commit", "hint", "hint_high",
            "n_entries")},
        "reject": np.zeros((G, K), bool),
        "entry_terms": np.zeros((G, K, E), np.int32),
        "entry_cc": np.zeros((G, K, E), bool),
    }
    leaders = leaders.copy()
    j = np.arange(groups)

    def put(lanes, mtype, **fields):
        k = count[lanes]
        ok = k < K
        lanes, k = lanes[ok], k[ok]
        planes["mtype"][lanes, k] = mtype
        for name, v in fields.items():
            planes[name][lanes, k] = np.asarray(v)[ok] if np.ndim(v) else v
        count[lanes] += 1

    if window == 0:
        put(j, MSG.ELECTION)
        leaders[:] = j
        return _inbox_of(planes, device), leaders
    propose = np.ones(groups, bool)
    if window == 4:
        moved = j % 4 == 0
        propose &= ~moved
        put(groups + j[moved], MSG.ELECTION)
    if window == 6:
        moving = j % 8 == 1
        slot = leaders[moving] // groups
        target = (slot + 1) % replicas
        put(leaders[moving], MSG.LEADER_TRANSFER, hint=target + 1)
        propose &= ~moving
    put(leaders[propose], MSG.PROPOSE,
        n_entries=rng.integers(1, E + 1, size=int(propose.sum())))
    if window in (3, 5, 7):
        slot = leaders // groups
        origin = (slot + 1 + j % (replicas - 1)) % replicas
        lo, hi = _enc_ctx(origin, window * groups + j + 1)
        put(leaders, MSG.READ_INDEX, hint=lo, hint_high=hi)
    if window == 4:
        leaders[moved] = groups + j[moved]
    if window == 6:
        leaders[moving] = target * groups + j[moving]
    return _inbox_of(planes, device), leaders


def _inbox_of(planes, device) -> Inbox:
    dev = resolve_device(device)
    return Inbox(**{f: torch.from_numpy(planes[f]).to(dev) for f in Inbox._fields})


# ------------------------------------------------------- router / gather bounds


def route_columns_bytes(out, route, cfg: KernelConfig) -> int:
    """The least bytes the columns kernel moves on this data: the StepOutput
    planes it reads, self_slot, route and rdelta read once; the ring entries
    of the wanted Replicates (5 B each); the slab and the plan bits written
    once."""
    from .ops.cuda import _COL_OUT, candidates_per_lane, slab_rows

    G, P = route.shape
    nb = lambda t: t.numel() * t.element_size()
    read = sum(nb(getattr(out, f)) for f in _COL_OUT) + 4 * G + 2 * nb(route)
    want = ((out.send_flags & SEND_REPLICATE) != 0) & (route >= 0)
    ents = int(torch.clamp(out.send_n_entries, 0, cfg.max_entries_per_msg)[want].sum())
    M = G * candidates_per_lane(cfg)
    return read + 5 * ents + 4 * slab_rows(cfg) * M + M


def route_scatter_bytes(n: int, Ml: int, accepted: int, nxt: Inbox, cfg: KernelConfig) -> int:
    """The least bytes one shard's scatter moves on this data: the dest row
    of every shard's slab read once, the other C - 1 rows of each accepted
    candidate read once, this shard's inbox written once and one plan byte
    per accepted candidate."""
    from .ops.cuda import slab_rows

    inbox_b = sum(t.numel() * t.element_size() for t in nxt)
    return 4 * n * Ml + 4 * (slab_rows(cfg) - 1) * accepted + inbox_b + accepted


def ring_gather_bytes(n: int, slab_elems: int) -> int:
    """n slabs read once, n stacks of n slabs written once (i32)."""
    return 4 * n * slab_elems + 4 * n * n * slab_elems


def random_route_case(rng: np.random.Generator, cfg: KernelConfig):
    """A seeded random (state, StepOutput, route, rdelta) draw for the
    router at cfg's shape (numpy planes), in the manner of
    tests/test_multistep.py's generator: every send flag and response type,
    negative rdelta that pushes REPLICATE_RESP rejects below the window,
    forwarded-read ctxs with origins in and out of range, and routes to any
    lane."""
    from .ops.convert import state_to_numpy
    from .ops.cuda import empty_output

    G, P, K, R, E, W = (cfg.groups, cfg.peers, cfg.inbox_depth, cfg.readindex_depth,
                        cfg.max_entries_per_msg, cfg.log_window)
    st = state_to_numpy(init_state(cfg, device="cpu"))
    st["self_slot"] = rng.integers(0, P - 1, size=G).astype(np.int32)
    st["log_term"] = rng.integers(1, 5, size=(G, W)).astype(np.int32)
    st["log_is_cc"] = rng.random((G, W)) < 0.5
    out = {f: np.zeros(t.shape, t.numpy().dtype)
           for f, t in zip(StepOutput._fields, empty_output(cfg, "cpu"))}
    ri = lambda lo, hi, shape: rng.integers(lo, hi, size=shape).astype(np.int32)
    flags = np.array([0, 0, SEND_REPLICATE, SEND_HEARTBEAT, SEND_VOTE_REQ, SEND_TIMEOUT_NOW,
                      SEND_REPLICATE | SEND_HEARTBEAT, SEND_VOTE_REQ | SEND_TIMEOUT_NOW],
                     np.int32)
    resp = np.array([MSG.NONE, MSG.NONE, MSG.REPLICATE_RESP, MSG.REQUEST_VOTE_RESP,
                     MSG.REQUEST_PREVOTE_RESP, MSG.HEARTBEAT_RESP, MSG.NOOP], np.int32)
    ctx = (ri(0, P + 2, (G, R)) << 24) | ri(0, 99, (G, R))
    out.update(
        send_flags=rng.choice(flags, size=(G, P)),
        send_prev_index=ri(-3, W, (G, P)), send_prev_term=ri(0, 5, (G, P)),
        send_n_entries=ri(0, E + 2, (G, P)), send_commit=ri(0, W, (G, P)),
        send_hb_commit=ri(0, W, (G, P)), send_hint=ri(0, 1 << 20, (G, P)),
        send_hint2=ri(0, 1 << 20, (G, P)), vote_last_index=ri(0, W, (G,)),
        vote_last_term=ri(0, 5, (G,)), term=ri(1, 6, (G,)),
        role=rng.choice(np.array([0, 1, 2, 5], np.int32), size=G),
        resp_type=rng.choice(resp, size=(G, K)), resp_to=ri(0, P, (G, K)),
        resp_term=ri(1, 6, (G, K)), resp_log_index=ri(0, W, (G, K)),
        resp_reject=rng.random((G, K)) < 0.5, resp_hint=ri(0, 8, (G, K)),
        resp_hint2=ri(0, 1 << 20, (G, K)), ready_count=ri(0, R + 1, (G,)),
        ready_ctx=np.where(rng.random((G, R)) < 0.3, 0, ctx).astype(np.int32),
        ready_ctx2=ri(0, 1 << 20, (G, R)), ready_index=ri(0, W, (G, R)),
        lease_round=ri(0, 1 << 16, (G,)),
    )
    route = np.where(rng.random((G, P)) < 0.6, ri(0, G, (G, P)), -1).astype(np.int32)
    route[np.arange(G), st["self_slot"]] = -1
    rdelta = rng.choice(np.array([0, 0, 0, 2, -2, -40], np.int32), size=(G, P))
    return st, out, route, rdelta
