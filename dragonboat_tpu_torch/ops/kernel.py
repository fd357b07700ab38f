"""step_batch: advance all Raft groups one protocol step; the K-step
super-step and its router; the sharded super-step.

The counterpart of the JAX package's `ops/kernel.py:step_batch`. The whole
fleet of groups advances at once:

  1. quiesce + tick  — idle-lane freeze, election/heartbeat/check-quorum
                       timers, lease-round open
  2. inbox scan      — K message slots, each applied to every group; the
                       handler table is a fixed sequence of masked updates
  3. quorum commit   — k-th order statistic over match[G,P] with the
                       current-term restriction
  4. replication fan-out, ReadIndex ready-queue pop
  5. output assembly — save/apply ranges and send descriptors for the engine

`step_batch_reference` is the plain PyTorch version. It follows the JAX code
op for op, in the same handler order, and emulates the JAX semantics that
torch does not share: out-of-range `take_along_axis` (INT_MIN fill), out of
range `one_hot` (an all-False row), u32 wraparound with logical shifts, and
shifts by 32 or more (0). The role-change helpers return
early when their lane mask selects no lane, which leaves the result as it
is and keeps the CPU version fast. `step_batch` launches the hand-written
CUDA kernel
(`csrc/step_batch.cu`, via `ops.cuda`) for tensors on the card and runs the
plain version for tensors on the CPU.

`multi_step_batch` runs K protocol steps per call and routes co-hosted
traffic between lanes after each one (`route_step_output`: the counterpart
of the JAX package's scan over step_batch + route_step_output). On the card
the router is two hand-written kernels (`csrc/route.cu`); its plain version
is `route_step_output_reference`. `sharded_multi_step_batch` runs the same
super-step over n lane blocks (logical shards of one device), exchanging
the candidates between blocks after every inner step through
`_gather_candidates` (the hand-written `csrc/ring_gather.cu` on the card,
the counterpart of the JAX package's `_pallas_ring_gather`): the plain path
exchanges the reference's (11 + 2E, Ml) slabs, the card path the narrower
candidate record (`_pack_record`, `_widen_record`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .state import (
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
    RoutePlan,
    StepOutput,
    _mix_t,
)

i32 = torch.int32
INT_MAX = 2**31 - 1
INT_MIN = -(2**31)

#: calls of the plain version (a run on the card that should go through the
#: kernel can assert that this stayed 0)
REFERENCE_CALLS = {"step_batch": 0}


def _where(c, a, b):
    """jnp.where with int32 results for python-scalar branches."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=b.dtype if isinstance(b, torch.Tensor) else i32,
                         device=c.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=c.device)
    return torch.where(c, a, b)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(i32)


def _rand_timeout(seed, term, slot, et):
    """et + (mix(seed, term, slot) mod et) in u32, as the JAX kernel does
    (a u32 remainder by 0 gives 0 there)."""
    x = _mix_t(seed.to(torch.int64), term.to(torch.int64), slot.to(torch.int64))
    etu = et.to(torch.int64) & 0xFFFFFFFF
    r = torch.where(etu == 0, torch.zeros_like(x), x % torch.clamp(etu, min=1))
    return _wrap32(et.to(torch.int64) + r)


def _one_hot(x, n):
    """jax.nn.one_hot(x, n, dtype=bool): out-of-range rows are all False."""
    return x[:, None] == torch.arange(n, dtype=x.dtype, device=x.device)[None, :]


def _gather_fill(a, idx):
    """take_along_axis(a, idx[:, None], axis=1)[:, 0] with JAX's default
    mode: negative indices in [-n, -1] wrap, others out of range give
    INT_MIN."""
    n = a.shape[1]
    wrapped = torch.where((idx < 0) & (idx >= -n), idx + n, idx)
    ok = (wrapped >= 0) & (wrapped < n)
    v = torch.gather(a, 1, torch.clamp(wrapped, 0, n - 1).long()[:, None])[:, 0]
    return torch.where(ok, v, torch.full_like(v, INT_MIN))


def _shl1(n):
    """int32(1) << n with XLA's semantics: 0 for n outside [0, 31]."""
    ok = (n >= 0) & (n < 32)
    v = torch.ones_like(n) << torch.clamp(n, 0, 31)
    return torch.where(ok, v, torch.zeros_like(v))


def _popcount(x):
    """Population count of the u32 bit pattern of int32 x."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(i32)


def _term_at(s: RaftTensors, idx):
    """Term of entry idx (i32[G]): ring lookup, marker, or 0 out-of-window."""
    W = s.log_term.shape[1]
    in_ring = (idx >= s.first_index) & (idx <= s.last_index) & (idx >= 1)
    ring = torch.gather(s.log_term, 1, (idx % W).long()[:, None])[:, 0]
    marker = idx == (s.first_index - 1)
    return torch.where(
        in_ring, ring, torch.where(marker, s.marker_term, torch.zeros_like(ring))
    )


def _self_mask(s: RaftTensors):
    return _one_hot(s.self_slot, s.member.shape[1])


def _num_voting(s: RaftTensors):
    return s.voting.sum(dim=1).to(i32)


def _quorum(s: RaftTensors):
    return torch.div(_num_voting(s), 2, rounding_mode="floor") + 1


def _reset(s: RaftTensors, new_term) -> RaftTensors:
    """The shared reset on any role change."""
    term_changed = new_term != s.term
    vote = _where(term_changed, 0, s.vote)
    selfm = _self_mask(s)
    last = s.last_index
    z = torch.zeros_like
    return s._replace(
        term=new_term,
        vote=vote,
        election_tick=z(s.election_tick),
        heartbeat_tick=z(s.heartbeat_tick),
        rand_timeout=_rand_timeout(s.seed, new_term, s.self_slot, s.election_timeout),
        vresp=z(s.vresp),
        vgrant=z(s.vgrant),
        transfer_to=z(s.transfer_to),
        pending_cc=z(s.pending_cc),
        ri_ctx=z(s.ri_ctx),
        ri_ctx2=z(s.ri_ctx2),
        ri_index=z(s.ri_index),
        ri_acks=z(s.ri_acks),
        ri_count=z(s.ri_count),
        lease_until=z(s.lease_until),
        hb_round_tick=z(s.hb_round_tick),
        hb_ack_bits=z(s.hb_ack_bits),
        match=_where(selfm, last[:, None].expand_as(s.match), 0),
        next=(last + 1)[:, None].expand_as(s.next).clone(),
        rstate=z(s.rstate),
        snap_sent=z(s.snap_sent),
    )


def _merge(mask, new: RaftTensors, old: RaftTensors) -> RaftTensors:
    """Select new state for lanes where mask[G] is True."""
    def sel(n, o):
        if n is o:
            return o
        m = mask
        while m.dim() < n.dim():
            m = m[..., None]
        return torch.where(m, n, o)

    return type(old)(*(sel(n, o) for n, o in zip(new, old)))


def _become_follower(s: RaftTensors, mask, new_term, leader) -> RaftTensors:
    if not bool(mask.any()):  # nothing selected: the merge would return s
        return s
    ns = _reset(s, torch.where(mask, new_term, s.term))
    new_role = _where(
        (s.role == ROLE.OBSERVER) | (s.role == ROLE.WITNESS), s.role, ROLE.FOLLOWER
    )
    ns = ns._replace(role=new_role, leader=leader)
    return _merge(mask, ns, s)


def _append_one(s: RaftTensors, mask, is_cc) -> RaftTensors:
    W = s.log_term.shape[1]
    idx = s.last_index + 1
    onehot = _one_hot(idx % W, W) & mask[:, None]
    log_term = torch.where(onehot, s.term[:, None], s.log_term)
    log_cc = torch.where(onehot, is_cc[:, None], s.log_is_cc)
    last = torch.where(mask, idx, s.last_index)
    selfm = _self_mask(s)
    match = torch.where(selfm & mask[:, None], last[:, None], s.match)
    return s._replace(log_term=log_term, log_is_cc=log_cc, last_index=last, match=match)


def _become_leader(s: RaftTensors, mask) -> RaftTensors:
    if not bool(mask.any()):
        return s
    ns = _reset(s, s.term)
    ns = ns._replace(
        role=_where(mask, ROLE.LEADER, ns.role),
        leader=torch.where(mask, s.self_slot + 1, ns.leader),
        pending_cc=torch.where(mask, _has_uncommitted_cc(s), ns.pending_cc),
    )
    ns = _append_one(ns, mask, torch.zeros_like(mask))
    return _merge(mask, ns, s)


def _live_cands(s: RaftTensors):
    """Each ring slot's absolute index: the largest index <= last_index
    congruent to the slot."""
    W = s.log_is_cc.shape[1]
    idxs = torch.arange(W, dtype=i32, device=s.last_index.device)[None, :]
    base = torch.div(s.last_index[:, None], W, rounding_mode="floor") * W
    cand = base + idxs
    return torch.where(cand > s.last_index[:, None], cand - W, cand)


def _has_uncommitted_cc(s: RaftTensors):
    """bool[G]: any config-change entry in (committed, last_index]."""
    cand = _live_cands(s)
    live = (cand > s.committed[:, None]) & (cand >= s.first_index[:, None]) & (
        cand <= s.last_index[:, None]
    )
    return (live & s.log_is_cc).any(dim=1)


def _has_cc_to_apply(s: RaftTensors):
    """bool[G]: config-change entry in (applied, committed]."""
    cand = _live_cands(s)
    live = (
        (cand > s.applied[:, None])
        & (cand <= s.committed[:, None])
        & (cand >= s.first_index[:, None])
    )
    return (live & s.log_is_cc).any(dim=1)


def _campaign(s: RaftTensors, mask, out, transfer_hint, force_real=None):
    """Start an election (or a pre-vote poll) on masked lanes."""
    if not bool(mask.any()):  # no lane campaigns: state and out unchanged
        return s, out
    can = (
        mask
        & s.active
        & (s.role != ROLE.LEADER)
        & (s.role != ROLE.OBSERVER)
        & (s.role != ROLE.WITNESS)
        & ~_has_cc_to_apply(s)
        & (s.voting & _self_mask(s)).any(dim=1)
    )
    selfm = _self_mask(s)
    single_now = _num_voting(s) == 1
    pre = can & s.prevote_on & ~transfer_hint & ~single_now
    if force_real is not None:
        pre = pre & ~force_real
    real = can & ~pre
    s = s._replace(
        role=_where(pre, ROLE.PRE_CANDIDATE, s.role),
        leader=_where(pre, 0, s.leader),
        vresp=torch.where(pre[:, None], selfm, s.vresp),
        vgrant=torch.where(pre[:, None], selfm, s.vgrant),
    )
    ns = _reset(s, s.term + 1)
    ns = ns._replace(
        role=_where(real, ROLE.CANDIDATE, ns.role),
        leader=_where(real, 0, ns.leader),
        vote=torch.where(real, s.self_slot + 1, ns.vote),
        vresp=torch.where(real[:, None], selfm, ns.vresp),
        vgrant=torch.where(real[:, None], selfm, ns.vgrant),
    )
    ns = _merge(real, ns, s)
    single = real & (_num_voting(ns) == 1)
    noop_at = _where(single, ns.last_index + 1, 0)
    ns = _become_leader(ns, single)
    out["ctr_elections_started"] = out["ctr_elections_started"] + real.to(i32)
    out["ctr_elections_won"] = out["ctr_elections_won"] + single.to(i32)
    others = ns.voting & ~_self_mask(ns)
    flags = torch.where(
        ((real & ~single) | pre)[:, None] & others,
        out["send_flags"] | SEND_VOTE_REQ,
        out["send_flags"],
    )
    hint = torch.where(
        (real & ~single & transfer_hint)[:, None] & others,
        ns.self_slot[:, None] + 1,
        out["send_hint"],
    )
    out = dict(out, send_flags=flags, send_hint=hint)
    out["noop_appended"] = torch.maximum(out["noop_appended"], noop_at)
    out["noop_term"] = torch.maximum(out["noop_term"], _where(single, ns.term, 0))
    return ns, out


def _is_leader_msg(t):
    return (
        (t == MSG.REPLICATE)
        | (t == MSG.INSTALL_SNAPSHOT)
        | (t == MSG.HEARTBEAT)
        | (t == MSG.TIMEOUT_NOW)
        | (t == MSG.READ_INDEX_RESP)
    )


def _handle_message(s: RaftTensors, m, out, cfg: KernelConfig):
    """Apply one message per group (the k-th inbox slot): the term preamble,
    then the handler table as masked updates."""
    P = s.member.shape[1]
    W = s.log_term.shape[1]
    E = cfg.max_entries_per_msg
    dev = s.term.device
    mtype = m["mtype"]
    present = mtype != MSG.NONE
    from_slot = m["from_slot"]
    mterm = m["term"]
    zeros = torch.zeros_like(mterm)
    present_any = bool(present.any())
    if not present_any:
        # an empty slot on every lane changes nothing: the responses are the
        # ones the masked handlers would give with every mask False
        return s, out, {
            "resp_type": torch.full_like(mterm, MSG.NONE),
            "resp_to": from_slot,
            "resp_term": s.term,
            "resp_log_index": zeros,
            "resp_reject": torch.zeros_like(present),
            "resp_hint": zeros,
            "resp_hint2": zeros,
            "prop_base": zeros,
            "rep_base": zeros,
        }

    # ---- term preamble -----------------------------------------------------
    local = mterm == 0
    higher = present & ~local & (mterm > s.term)
    lower = present & ~local & (mterm < s.term)
    is_pv = mtype == MSG.REQUEST_PREVOTE
    is_pvr = mtype == MSG.REQUEST_PREVOTE_RESP
    drop_rv = (
        higher
        & ((mtype == MSG.REQUEST_VOTE) | is_pv)
        & s.check_quorum
        & (m["hint"] != from_slot + 1)
        & (s.leader != 0)
        & (s.election_tick < s.election_timeout)
    )
    step_down = higher & ~drop_rv & ~is_pv & ~(is_pvr & ~m["reject"])
    new_leader = _where(_is_leader_msg(mtype), from_slot + 1, 0)
    s = _become_follower(s, step_down, mterm, torch.where(step_down, new_leader, s.leader))
    noop_resp = lower & _is_leader_msg(mtype) & s.check_quorum
    pv_stale = lower & is_pv
    dropped = lower | drop_rv
    act = present & ~dropped

    is_leader = s.role == ROLE.LEADER
    is_cand = s.role == ROLE.CANDIDATE
    is_precand = s.role == ROLE.PRE_CANDIDATE
    is_obs = s.role == ROLE.OBSERVER
    is_wit = s.role == ROLE.WITNESS
    is_fol = s.role == ROLE.FOLLOWER

    resp_type = _where(noop_resp, MSG.NOOP, torch.full_like(mterm, MSG.NONE))
    resp_type = _where(pv_stale, MSG.REQUEST_PREVOTE_RESP, resp_type)
    resp_to = from_slot
    resp_log_index = zeros
    resp_reject = pv_stale
    resp_hint = zeros
    resp_hint2 = zeros
    pv_resp_term = zeros

    selfm = _self_mask(s)
    from_onehot = _one_hot(from_slot, P)
    known_from = (s.member & from_onehot).any(dim=1)

    # ---- RequestVote (any state) ------------------------------------------
    rv = act & (mtype == MSG.REQUEST_VOTE) & (
        is_fol | is_cand | is_precand | is_leader | is_wit
    )
    can_grant = (s.vote == 0) | (s.vote == from_slot + 1)
    last_term = _term_at(s, s.last_index)
    utd = (m["log_term"] > last_term) | (
        (m["log_term"] == last_term) & (m["log_index"] >= s.last_index)
    )
    grant = rv & can_grant & utd
    s = s._replace(
        vote=torch.where(grant, from_slot + 1, s.vote),
        election_tick=_where(grant, 0, s.election_tick),
    )
    resp_type = _where(rv, MSG.REQUEST_VOTE_RESP, resp_type)
    resp_reject = torch.where(rv, ~grant, resp_reject)

    # ---- RequestPreVote ------------------------------------------------------
    pv = act & is_pv & (is_fol | is_cand | is_precand | is_leader | is_wit)
    grant_pv = pv & (mterm > s.term) & utd
    resp_type = _where(pv, MSG.REQUEST_PREVOTE_RESP, resp_type)
    resp_reject = torch.where(pv, ~grant_pv, resp_reject)
    pv_resp_term = torch.where(grant_pv, mterm, pv_resp_term)

    # ---- RequestVoteResp (candidate) --------------------------------------
    rvr = act & (mtype == MSG.REQUEST_VOTE_RESP) & is_cand & known_from
    first_resp = rvr & ~(s.vresp & from_onehot).any(dim=1)
    fr_first = first_resp[:, None] & from_onehot
    s = s._replace(
        vresp=s.vresp | fr_first,
        vgrant=torch.where(fr_first, ~m["reject"][:, None], s.vgrant),
    )
    granted = (s.vgrant & s.voting).sum(dim=1).to(i32)
    rejected = (s.vresp & ~s.vgrant & s.voting).sum(dim=1).to(i32)
    q = _quorum(s)
    win = rvr & (granted >= q)
    lose = rvr & ~win & (rejected >= q)
    noop_at = _where(win, s.last_index + 1, 0)
    s = _become_leader(s, win)
    out["ctr_elections_won"] = out["ctr_elections_won"] + win.to(i32)
    out["noop_appended"] = torch.maximum(out["noop_appended"], noop_at)
    out["noop_term"] = torch.maximum(out["noop_term"], _where(win, s.term, 0))
    s = _become_follower(s, lose, s.term, torch.zeros_like(s.leader))

    # ---- RequestPreVoteResp (pre-candidate) -------------------------------
    pvr = act & is_pvr & is_precand & known_from
    first_pvr = pvr & ~(s.vresp & from_onehot).any(dim=1)
    fp = first_pvr[:, None] & from_onehot
    s = s._replace(
        vresp=s.vresp | fp,
        vgrant=torch.where(fp, ~m["reject"][:, None], s.vgrant),
    )
    granted_pv = (s.vgrant & s.voting).sum(dim=1).to(i32)
    rejected_pv = (s.vresp & ~s.vgrant & s.voting).sum(dim=1).to(i32)
    q = _quorum(s)
    win_pv = pvr & (granted_pv >= q)
    lose_pv = pvr & ~win_pv & (rejected_pv >= q)
    s, out = _campaign(s, win_pv, out, torch.zeros_like(win_pv), force_real=win_pv)
    s = _become_follower(s, lose_pv, s.term, torch.zeros_like(s.leader))

    # ---- Election / TimeoutNow --------------------------------------------
    ele = act & (mtype == MSG.ELECTION)
    tno = act & (mtype == MSG.TIMEOUT_NOW) & is_fol
    s, out = _campaign(s, ele | tno, out, transfer_hint=tno)

    prop_base = zeros
    rep_base = zeros

    # ---- Replicate (non-leader) -------------------------------------------
    rep = act & (mtype == MSG.REPLICATE) & (is_fol | is_obs | is_wit | is_cand | is_precand)
    rep_demote = rep & (is_cand | is_precand)
    s = _become_follower(
        s, rep_demote, s.term, torch.where(rep_demote, from_slot + 1, s.leader)
    )
    s = s._replace(
        leader=torch.where(rep, from_slot + 1, s.leader),
        election_tick=_where(rep, 0, s.election_tick),
    )
    prev = m["log_index"]
    nent = m["n_entries"]
    stale = rep & (prev < s.committed)
    match_prev = _term_at(s, prev) == m["log_term"]
    in_window = (prev >= s.first_index - 1) & (prev <= s.last_index)
    ok = rep & ~stale & match_prev & in_window
    rej = rep & ~stale & ~ok
    out["ctr_replicate_rejects"] = out["ctr_replicate_rejects"] + rej.to(i32)
    if E > 0:
        ar_e = torch.arange(E, dtype=i32, device=dev)[None, :]
        e_idx = prev[:, None] + 1 + ar_e
        e_valid = ar_e < nent[:, None]
        have = e_idx <= s.last_index[:, None]
        exist_term = torch.gather(s.log_term, 1, (e_idx % W).long())
        conflict = e_valid & (~have | (exist_term != m["entry_terms"]))
        first_conf = _where(conflict, e_idx, INT_MAX).min(dim=1).values
        any_conf = conflict.any(dim=1)
        do_append = ok & any_conf
        w_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
        lo = _where(do_append, first_conf, 1)
        hi = prev + nent
        i_w = lo[:, None] + (w_idx - lo[:, None]) % W
        written = do_append[:, None] & (i_w <= hi[:, None])
        e_pos = torch.clamp(i_w - (prev[:, None] + 1), 0, E - 1).long()
        terms_w = torch.gather(m["entry_terms"], 1, e_pos)
        cc_w = torch.gather(m["entry_cc"], 1, e_pos)
        s = s._replace(
            log_term=torch.where(written, terms_w, s.log_term),
            log_is_cc=torch.where(written, cc_w, s.log_is_cc),
            last_index=torch.where(do_append, prev + nent, s.last_index),
            unsaved_from=torch.where(
                do_append, torch.minimum(s.unsaved_from, first_conf), s.unsaved_from
            ),
        )
    ack_to = prev + nent
    new_commit = torch.clamp(torch.minimum(ack_to, m["commit"]), s.committed, s.last_index)
    s = s._replace(committed=torch.where(ok, new_commit, s.committed))
    rep_base = torch.where(ok, prev + 1, rep_base)
    resp_type = _where(rep, MSG.REPLICATE_RESP, resp_type)
    resp_log_index = torch.where(
        stale, s.committed,
        torch.where(ok, ack_to, torch.where(rej, prev, resp_log_index)),
    )
    resp_reject = resp_reject | rej
    resp_hint = torch.where(rej, s.last_index, resp_hint)

    # ---- Heartbeat (non-leader) -------------------------------------------
    hb = act & (mtype == MSG.HEARTBEAT) & (is_fol | is_obs | is_wit | is_cand | is_precand)
    hb_demote = hb & (is_cand | is_precand)
    s = _become_follower(
        s, hb_demote, s.term, torch.where(hb_demote, from_slot + 1, s.leader)
    )
    s = s._replace(
        leader=torch.where(hb, from_slot + 1, s.leader),
        election_tick=_where(hb, 0, s.election_tick),
        committed=torch.where(
            hb, torch.clamp(m["commit"], s.committed, s.last_index), s.committed
        ),
    )
    resp_type = _where(hb, MSG.HEARTBEAT_RESP, resp_type)
    resp_log_index = torch.where(hb, m["log_index"], resp_log_index)
    resp_hint = torch.where(hb, m["hint"], resp_hint)
    resp_hint2 = torch.where(hb, m["hint_high"], resp_hint2)

    # ---- ReplicateResp (leader) -------------------------------------------
    rr = act & (mtype == MSG.REPLICATE_RESP) & (s.role == ROLE.LEADER) & known_from
    fr = from_onehot
    li = m["log_index"]
    prev_rstate = s.rstate
    racc = rr & ~m["reject"]
    from_val = lambda a: torch.where(fr, a, torch.zeros_like(a)).sum(dim=1).to(i32)
    moved = racc & (li > from_val(s.match))
    fa = racc[:, None] & fr
    s = s._replace(
        ract=s.ract | (rr[:, None] & fr),
        match=torch.where(fa, torch.maximum(s.match, li[:, None]), s.match),
        next=torch.where(fa, torch.maximum(s.next, li[:, None] + 1), s.next),
    )
    st = s.rstate
    mv = moved[:, None] & fr
    st = _where(mv & (st == RSTATE.WAIT), RSTATE.RETRY, st)
    st = _where(mv & (st == RSTATE.RETRY), RSTATE.REPLICATE, st)
    caught = s.match >= s.snap_sent
    st = _where(mv & (st == RSTATE.SNAPSHOT) & caught, RSTATE.RETRY, st)
    s = s._replace(rstate=st)
    rrej = rr & m["reject"]
    in_repl = (fr & (prev_rstate == RSTATE.REPLICATE)).any(dim=1)
    cur_match = from_val(s.match)
    cur_next = from_val(s.next)
    valid_repl = rrej & in_repl & (li > cur_match)
    valid_probe = rrej & ~in_repl & (cur_next - 1 == li)
    nn = torch.where(
        valid_repl,
        cur_match + 1,
        torch.clamp(torch.minimum(li, m["hint"] + 1), min=1),
    )
    dec = valid_repl | valid_probe
    s = s._replace(
        next=torch.where(dec[:, None] & fr, nn[:, None], s.next),
        rstate=_where(dec[:, None] & fr, RSTATE.RETRY, s.rstate),
    )
    tt = s.transfer_to
    t_caught = racc & (tt != 0) & (from_slot + 1 == tt) & (from_val(s.match) == s.last_index)
    out["send_flags"] = torch.where(
        t_caught[:, None] & fr, out["send_flags"] | SEND_TIMEOUT_NOW, out["send_flags"]
    )

    # ---- HeartbeatResp (leader) -------------------------------------------
    hr = act & (mtype == MSG.HEARTBEAT_RESP) & (s.role == ROLE.LEADER) & known_from
    hf = hr[:, None] & fr
    s = s._replace(
        ract=s.ract | hf,
        rstate=_where(hf & (s.rstate == RSTATE.WAIT), RSTATE.RETRY, s.rstate),
    )
    out["force_probe"] = out["force_probe"] | (hf & (s.match < s.last_index[:, None]))
    hint_match = (
        hr[:, None]
        & (s.ri_ctx == m["hint"][:, None])
        & (s.ri_ctx2 == m["hint_high"][:, None])
        & (s.ri_ctx != 0)
    )
    frombit = _shl1(from_slot)
    s = s._replace(ri_acks=torch.where(hint_match, s.ri_acks | frombit[:, None], s.ri_acks))
    tag_match = (
        hr
        & s.lease_on
        & (li != 0)
        & (li == s.hb_round_tick)
        & (fr & s.voting).any(dim=1)
    )
    new_bits = torch.where(tag_match, s.hb_ack_bits | frombit, s.hb_ack_bits)
    ackn = _popcount(new_bits)
    lgrant = (
        hr & s.lease_on & s.clock_ok & (s.hb_round_tick != 0) & (ackn + 1 >= _quorum(s))
    )
    s = s._replace(
        hb_ack_bits=new_bits,
        lease_until=torch.where(
            lgrant,
            torch.maximum(
                s.lease_until, s.hb_round_tick + s.election_timeout - s.lease_margin
            ),
            s.lease_until,
        ),
    )

    # ---- ReadIndex (leader) ------------------------------------------------
    R = s.ri_ctx.shape[1]
    ri = act & (mtype == MSG.READ_INDEX) & (s.role == ROLE.LEADER)
    single = _num_voting(s) == 1
    committed_this_term = _term_at(s, s.committed) == s.term
    ok_ri = ri & (single | committed_this_term)
    slot_free = s.ri_count < R
    lease_valid = (
        s.lease_on & s.clock_ok & (s.tick_count < s.lease_until) & (s.transfer_to == 0)
    )
    imm_lease = ok_ri & ~single & lease_valid & slot_free
    enq = ok_ri & ~single & ~lease_valid & slot_free
    posm = _one_hot(s.ri_count, R) & enq[:, None]
    s = s._replace(
        ri_ctx=torch.where(posm, m["hint"][:, None], s.ri_ctx),
        ri_ctx2=torch.where(posm, m["hint_high"][:, None], s.ri_ctx2),
        ri_index=torch.where(posm, s.committed[:, None], s.ri_index),
        ri_acks=_where(posm, 0, s.ri_acks),
        ri_count=s.ri_count + enq.to(i32),
    )
    others_v = s.voting & ~selfm
    eo = enq[:, None] & others_v
    out["send_flags"] = torch.where(eo, out["send_flags"] | SEND_HEARTBEAT, out["send_flags"])
    out["ctr_heartbeats_sent"] = out["ctr_heartbeats_sent"] + eo.sum(dim=1).to(i32)
    out["send_hint"] = torch.where(eo, m["hint"][:, None], out["send_hint"])
    out["send_hint2"] = torch.where(eo, m["hint_high"][:, None], out["send_hint2"])
    imm = (ok_ri & single) | imm_lease
    posm2 = _one_hot(s.ri_count, R) & imm[:, None]
    s = s._replace(
        ri_ctx=torch.where(posm2, m["hint"][:, None], s.ri_ctx),
        ri_ctx2=torch.where(posm2, m["hint_high"][:, None], s.ri_ctx2),
        ri_index=torch.where(posm2, s.committed[:, None], s.ri_index),
        ri_acks=_where(posm2, -1, s.ri_acks),
        ri_count=s.ri_count + imm.to(i32),
    )
    out["lease_served"] = out["lease_served"] + imm_lease.to(i32)
    out["lease_fallback"] = out["lease_fallback"] + (enq & s.lease_on).to(i32)

    # ---- Propose (leader) --------------------------------------------------
    pp = act & (mtype == MSG.PROPOSE)
    pok = pp & (s.role == ROLE.LEADER) & (s.transfer_to == 0)
    e_in_msg = torch.arange(E, dtype=i32, device=dev)[None, :] < nent[:, None]
    has_cc = (m["entry_cc"] & e_in_msg).any(dim=1)
    cc_allowed = pok & has_cc & ~s.pending_cc
    cc_stripped = pok & has_cc & s.pending_cc
    s = s._replace(pending_cc=s.pending_cc | cc_allowed)
    out["dropped_cc"] = out["dropped_cc"] | cc_stripped
    room = s.last_index - s.first_index + 1 + nent <= W
    can_append = pok & room
    prop_base = torch.where(can_append, s.last_index + 1, prop_base)
    if E > 0:
        eff_cc = m["entry_cc"] & cc_allowed[:, None]
        w_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
        a_lo = s.last_index + 1
        a_hi = s.last_index + nent
        i_w = a_lo[:, None] + (w_idx - a_lo[:, None]) % W
        written = can_append[:, None] & (i_w <= a_hi[:, None])
        e_pos = torch.clamp(i_w - a_lo[:, None], 0, E - 1).long()
        cc_w = torch.gather(eff_cc, 1, e_pos)
        new_last = torch.where(can_append, s.last_index + nent, s.last_index)
        s = s._replace(
            log_term=torch.where(written, s.term[:, None], s.log_term),
            log_is_cc=torch.where(written, cc_w, s.log_is_cc),
            last_index=new_last,
            match=torch.where(selfm & can_append[:, None], new_last[:, None], s.match),
        )
    out["dropped_propose"] = out["dropped_propose"] + _where(pp & ~can_append, nent, 0)
    out["fwd_leader"] = torch.where(pp & ~pok, s.leader, out["fwd_leader"])
    out["log_full"] = out["log_full"] | (pok & ~room)

    # ---- ReadIndexResp (follower/observer) --------------------------------
    rir = act & (mtype == MSG.READ_INDEX_RESP) & (is_fol | is_obs)
    s = s._replace(
        leader=torch.where(rir, from_slot + 1, s.leader),
        election_tick=_where(rir, 0, s.election_tick),
    )
    rir_ok = rir & (s.ri_count < R)
    posm3 = _one_hot(s.ri_count, R) & rir_ok[:, None]
    s = s._replace(
        ri_ctx=torch.where(posm3, m["hint"][:, None], s.ri_ctx),
        ri_ctx2=torch.where(posm3, m["hint_high"][:, None], s.ri_ctx2),
        ri_index=torch.where(posm3, li[:, None], s.ri_index),
        ri_acks=_where(posm3, -1, s.ri_acks),
        ri_count=s.ri_count + rir_ok.to(i32),
    )

    # ---- LeaderTransfer (leader) ------------------------------------------
    lt = act & (mtype == MSG.LEADER_TRANSFER) & (s.role == ROLE.LEADER)
    target = m["hint"]
    lt_ok = lt & (s.transfer_to == 0) & (target != s.self_slot + 1) & (target != 0)
    s = s._replace(
        transfer_to=torch.where(lt_ok, target, s.transfer_to),
        election_tick=_where(lt_ok, 0, s.election_tick),
    )
    t_oh = _one_hot(torch.clamp(target - 1, min=0), P)
    t_match = torch.where(t_oh, s.match, torch.zeros_like(s.match)).sum(dim=1).to(i32)
    fast = lt_ok & (t_match == s.last_index)
    out["send_flags"] = torch.where(
        fast[:, None] & t_oh, out["send_flags"] | SEND_TIMEOUT_NOW, out["send_flags"]
    )

    # ---- Unreachable / SnapshotStatus (leader) -----------------------------
    un = act & (mtype == MSG.UNREACHABLE) & (s.role == ROLE.LEADER) & known_from
    s = s._replace(
        rstate=_where(
            un[:, None] & fr & (s.rstate == RSTATE.REPLICATE), RSTATE.RETRY, s.rstate
        )
    )
    st2 = act & (mtype == MSG.SNAPSHOT_STATUS) & (s.role == ROLE.LEADER) & known_from
    in_snap = st2[:, None] & fr & (s.rstate == RSTATE.SNAPSHOT)
    s = s._replace(
        snap_sent=_where(in_snap & m["reject"][:, None], 0, s.snap_sent),
        next=torch.where(in_snap, torch.maximum(s.match + 1, s.snap_sent + 1), s.next),
        rstate=_where(in_snap, RSTATE.WAIT, s.rstate),
    )

    resps = {
        "resp_type": _where(act | noop_resp | pv_stale, resp_type, MSG.NONE),
        "resp_to": resp_to,
        "resp_term": torch.where(pv_resp_term > 0, pv_resp_term, s.term),
        "resp_log_index": resp_log_index,
        "resp_reject": resp_reject,
        "resp_hint": resp_hint,
        "resp_hint2": resp_hint2,
        "prop_base": prop_base,
        "rep_base": rep_base,
    }
    return s, out, resps


def _quiesce(s: RaftTensors, inbox: Inbox, ticks):
    """Idle-lane freeze: quiesced lanes freeze their timers; any
    non-heartbeat inbox message exits quiesce."""
    t = inbox.mtype
    activity = (
        (t != MSG.NONE) & (t != MSG.HEARTBEAT) & (t != MSG.HEARTBEAT_RESP)
    ).any(dim=1)
    idle = _where(
        activity | ~s.quiesce_on, 0, s.idle_ticks + torch.clamp(ticks, min=0)
    )
    entering = s.quiesce_on & s.active & ~s.quiesced & (idle >= s.quiesce_threshold)
    exiting = s.quiesced & activity
    return s._replace(
        idle_ticks=idle,
        quiesced=(s.quiesced | entering) & ~activity,
        election_tick=_where(exiting, 0, s.election_tick),
    )


def _tick(s: RaftTensors, ticks, out):
    """Advance logical clocks for lanes with ticks > 0."""
    do = s.active & (ticks > 0) & ~s.quiesced
    dt = _where(do, ticks, 0)
    s = s._replace(tick_count=s.tick_count + dt, election_tick=s.election_tick + dt)
    is_leader = s.role == ROLE.LEADER
    can_campaign = (
        do
        & ~is_leader
        & (s.role != ROLE.OBSERVER)
        & (s.role != ROLE.WITNESS)
        & (s.election_tick >= s.rand_timeout)
    )
    s = s._replace(election_tick=_where(can_campaign, 0, s.election_tick))
    s, out = _campaign(s, can_campaign, out, torch.zeros_like(can_campaign))
    cq_due = do & is_leader & (s.election_tick >= s.election_timeout)
    s = s._replace(
        election_tick=_where(cq_due, 0, s.election_tick),
        transfer_to=_where(cq_due, 0, s.transfer_to),
    )
    active_cnt = ((s.ract | _self_mask(s)) & s.voting).sum(dim=1).to(i32)
    down = cq_due & s.check_quorum & (active_cnt < _quorum(s))
    s = s._replace(ract=s.ract & ~cq_due[:, None])
    s = _become_follower(s, down, s.term, torch.zeros_like(s.leader))
    is_leader = s.role == ROLE.LEADER
    s = s._replace(heartbeat_tick=s.heartbeat_tick + _where(do & is_leader, ticks, 0))
    hb_due = do & is_leader & (s.heartbeat_tick >= s.heartbeat_timeout)
    s = s._replace(heartbeat_tick=_where(hb_due, 0, s.heartbeat_tick))
    open_round = hb_due & s.lease_on
    s = s._replace(
        hb_round_tick=torch.where(open_round, s.tick_count, s.hb_round_tick),
        hb_ack_bits=_where(open_round, 0, s.hb_ack_bits),
    )
    newest_pos = torch.clamp(s.ri_count - 1, min=0)
    newest_ctx = _gather_fill(s.ri_ctx, newest_pos)
    newest_ctx2 = _gather_fill(s.ri_ctx2, newest_pos)
    pending = s.ri_count > 0
    hint = _where(pending, newest_ctx, 0)
    hint2 = _where(pending, newest_ctx2, 0)
    others_v = s.voting & ~_self_mask(s)
    tgt = torch.where(pending[:, None], others_v, others_v | s.observer)
    ht = hb_due[:, None] & tgt
    out["send_flags"] = torch.where(ht, out["send_flags"] | SEND_HEARTBEAT, out["send_flags"])
    out["ctr_heartbeats_sent"] = out["ctr_heartbeats_sent"] + ht.sum(dim=1).to(i32)
    out["send_hint"] = torch.where(ht, hint[:, None], out["send_hint"])
    out["send_hint2"] = torch.where(ht, hint2[:, None], out["send_hint2"])
    return s, out


def step_batch_reference(
    s: RaftTensors, inbox: Inbox, ticks: torch.Tensor, cfg: KernelConfig
) -> Tuple[RaftTensors, StepOutput]:
    """The plain PyTorch version of one protocol step for all groups: tick +
    drain K inbox slots + commit + emit engine directives. Pure: the input
    tensors are not modified."""
    REFERENCE_CALLS["step_batch"] += 1
    G, P = s.member.shape
    K = inbox.mtype.shape[1]
    R = s.ri_ctx.shape[1]
    W = s.log_term.shape[1]
    E = cfg.max_entries_per_msg
    dev = s.term.device

    prev_term, prev_vote, prev_commit = s.term, s.vote, s.committed
    save_base_floor = s.unsaved_from

    zi = lambda *shape: torch.zeros(shape, dtype=i32, device=dev)
    zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    out = {
        "send_flags": zi(G, P),
        "send_hint": zi(G, P),
        "send_hint2": zi(G, P),
        "noop_appended": zi(G),
        "noop_term": zi(G),
        "dropped_propose": zi(G),
        "lease_served": zi(G),
        "lease_fallback": zi(G),
        "dropped_cc": zb(G),
        "fwd_leader": zi(G),
        "log_full": zb(G),
        "force_probe": zb(G, P),
        "ctr_elections_started": zi(G),
        "ctr_elections_won": zi(G),
        "ctr_heartbeats_sent": zi(G),
        "ctr_replicate_rejects": zi(G),
    }

    s = _quiesce(s, inbox, ticks)
    s, out = _tick(s, ticks, out)

    per_slot = []
    for k in range(K):
        m = {name: getattr(inbox, name)[:, k] for name in Inbox._fields}
        s, out, resps = _handle_message(s, m, out, cfg)
        per_slot.append(resps)
    resps = {
        name: torch.stack([r[name] for r in per_slot], dim=1) if K else zi(G, 0)
        for name in (per_slot[0] if K else ())
    }

    # ---- quorum commit (leader lanes) --------------------------------------
    is_leader = s.role == ROLE.LEADER
    nv = _num_voting(s)
    q = _quorum(s)
    masked_match = _where(s.voting, s.match, INT_MAX)
    sorted_match = torch.sort(masked_match, dim=1).values
    qpos = torch.clamp(nv - q, 0, P - 1)
    qidx = torch.gather(sorted_match, 1, qpos.long()[:, None])[:, 0]
    qterm = _term_at(s, qidx)
    can_commit = is_leader & (nv > 0) & (qidx > s.committed) & (qterm == s.term)
    s = s._replace(committed=torch.where(can_commit, qidx, s.committed))

    # ---- replication fan-out ----------------------------------------------
    s = s._replace(
        rstate=_where(
            (s.rstate == RSTATE.SNAPSHOT) & (s.match >= s.snap_sent), RSTATE.RETRY, s.rstate
        )
    )
    selfm = _self_mask(s)
    peer_tgt = s.member & ~selfm
    lag = s.next <= s.last_index[:, None]
    commit_moved = (s.committed != prev_commit)[:, None]
    paused = (s.rstate == RSTATE.WAIT) | (s.rstate == RSTATE.SNAPSHOT)
    compacted = s.next < s.first_index[:, None]
    send = (
        is_leader[:, None]
        & peer_tgt
        & (lag | commit_moved | out["force_probe"])
        & ~paused
        & ~compacted
    )
    need_snap = is_leader[:, None] & peer_tgt & lag & ~paused & compacted & s.ract
    n_send = torch.clamp(s.last_index[:, None] - s.next + 1, 0, E)
    prev_idx = s.next - 1
    prev_term_pp = torch.where(
        prev_idx == s.first_index[:, None] - 1,
        s.marker_term[:, None].expand_as(prev_idx),
        torch.gather(s.log_term, 1, (prev_idx % W).long()),
    )
    flags = _where(send, out["send_flags"] | SEND_REPLICATE, out["send_flags"])
    flags = _where(need_snap, flags | NEED_SNAPSHOT, flags)
    s = s._replace(
        snap_sent=torch.where(need_snap, s.last_index[:, None], s.snap_sent),
        rstate=_where(need_snap, RSTATE.SNAPSHOT, s.rstate),
    )
    send_prev_index = _where(send, prev_idx, 0)
    send_n = _where(send, n_send, 0)
    adv = send & (s.rstate == RSTATE.REPLICATE) & (n_send > 0)
    probe = send & (s.rstate == RSTATE.RETRY) & (n_send > 0)
    s = s._replace(
        next=torch.where(adv, s.next + n_send, s.next),
        rstate=_where(probe, RSTATE.WAIT, s.rstate),
    )
    send_commit = _where(send, s.committed[:, None].expand_as(send).to(i32), 0)
    send_hb_commit = torch.minimum(s.match, s.committed[:, None])

    # ---- readindex ready queue pop ----------------------------------------
    acks = s.ri_acks
    confirmed = (_popcount(acks) + 1 >= q[:, None]) | (acks == -1)
    idxs = torch.arange(R, dtype=i32, device=dev)[None, :]
    live = (idxs < s.ri_count[:, None]) & (s.ri_ctx != 0)
    confirmed = confirmed & live
    last_conf = _where(confirmed, idxs + 1, 0).max(dim=1).values
    popmask = idxs < last_conf[:, None]
    ready_ctx = _where(popmask, s.ri_ctx, 0)
    ready_ctx2 = _where(popmask, s.ri_ctx2, 0)
    conf_idx = _where(confirmed, s.ri_index, 0).max(dim=1).values
    ready_index = _where(popmask, torch.minimum(s.ri_index, conf_idx[:, None]), 0)
    ready_count = last_conf
    shift = last_conf

    def shift_left(a):
        take = torch.clamp(idxs + shift[:, None], 0, R - 1).long()
        v = torch.gather(a, 1, take)
        return _where(idxs < (s.ri_count - shift)[:, None], v, 0)

    s = s._replace(
        ri_ctx=shift_left(s.ri_ctx),
        ri_ctx2=shift_left(s.ri_ctx2),
        ri_index=shift_left(s.ri_index),
        ri_acks=shift_left(s.ri_acks),
        ri_count=s.ri_count - shift,
    )

    # ---- engine directives -------------------------------------------------
    save_from = torch.minimum(save_base_floor, s.unsaved_from)
    has_save = (s.last_index >= save_from) & s.active
    out_save_from = _where(has_save, save_from, 0)
    out_save_to = _where(has_save, s.last_index, 0)
    s = s._replace(unsaved_from=s.last_index + 1)

    apply_from = s.processed + 1
    apply_to = s.committed
    has_apply = (apply_to >= apply_from) & s.active
    out_apply_from = _where(has_apply, apply_from, 0)
    out_apply_to = _where(has_apply, apply_to, 0)
    s = s._replace(processed=torch.maximum(s.processed, s.committed))
    s = s._replace(applied=torch.maximum(s.applied, out_apply_to))

    hard_changed = (s.term != prev_term) | (s.vote != prev_vote) | (s.committed != prev_commit)
    last_term_out = _term_at(s, s.last_index)
    active_i = s.active.to(i32)
    counters = torch.stack(
        [
            out["ctr_elections_started"],
            out["ctr_elections_won"],
            out["ctr_heartbeats_sent"],
            out["ctr_replicate_rejects"],
            s.committed - prev_commit,
            out["lease_served"],
            out["lease_fallback"],
            ready_count * active_i,
        ],
        dim=1,
    ).view(torch.uint32)

    leader_bits = SEND_REPLICATE | SEND_HEARTBEAT | SEND_TIMEOUT_NOW | NEED_SNAPSHOT
    end_leader = (s.role == ROLE.LEADER)[:, None]
    end_cand = ((s.role == ROLE.CANDIDATE) | (s.role == ROLE.PRE_CANDIDATE))[:, None]
    flags = torch.where(end_leader, flags, flags & ~leader_bits)
    flags = torch.where(end_cand, flags, flags & ~SEND_VOTE_REQ)
    is_lead_end = s.role == ROLE.LEADER

    output = StepOutput(
        send_flags=flags * active_i[:, None],
        send_prev_index=send_prev_index,
        send_prev_term=_where(send, prev_term_pp, 0),
        send_n_entries=send_n,
        send_commit=send_commit,
        send_hb_commit=send_hb_commit,
        send_hint=out["send_hint"],
        send_hint2=out["send_hint2"],
        vote_last_index=s.last_index,
        vote_last_term=last_term_out,
        resp_type=resps["resp_type"],
        resp_to=resps["resp_to"],
        resp_term=resps["resp_term"],
        resp_log_index=resps["resp_log_index"],
        resp_reject=resps["resp_reject"],
        resp_hint=resps["resp_hint"],
        resp_hint2=resps["resp_hint2"],
        save_from=out_save_from,
        save_to=out_save_to,
        apply_from=out_apply_from,
        apply_to=out_apply_to,
        commit_index=s.committed,
        hard_changed=hard_changed & s.active,
        ready_ctx=ready_ctx,
        ready_ctx2=ready_ctx2,
        ready_index=ready_index,
        ready_count=ready_count * active_i,
        dropped_propose=out["dropped_propose"],
        dropped_cc=out["dropped_cc"],
        fwd_leader=out["fwd_leader"],
        noop_appended=out["noop_appended"],
        noop_term=out["noop_term"],
        log_full=out["log_full"],
        prop_base=resps["prop_base"],
        rep_base=resps["rep_base"],
        leader=s.leader,
        term=s.term,
        vote=s.vote,
        role=s.role,
        match=s.match,
        rstate=s.rstate,
        last_index=s.last_index,
        quiesced=s.quiesced,
        lease_round=_where(s.lease_on & is_lead_end, s.hb_round_tick, 0),
        lease_served=out["lease_served"],
        lease_fallback=out["lease_fallback"],
        lease_ok=(
            s.lease_on & s.clock_ok & is_lead_end
            & (s.tick_count < s.lease_until) & (s.transfer_to == 0)
        ),
        counters=counters,
    )
    return s, output


def step_batch(
    s: RaftTensors, inbox: Inbox, ticks: torch.Tensor, cfg: KernelConfig
) -> Tuple[RaftTensors, StepOutput]:
    """One protocol step for all groups.

    For tensors on the card this launches the CUDA kernel, which updates the
    state tensors IN PLACE and returns them (pass clones to keep the input;
    make_step_fn(cfg, donate=False) does that); `ops.cuda.step_batch_cuda`
    also takes preallocated output buffers. For tensors on the CPU it runs
    step_batch_reference, which leaves its input untouched."""
    if s.term.device.type == "cuda":
        from .cuda import step_batch_cuda

        return step_batch_cuda(s, inbox, ticks, cfg)
    return step_batch_reference(s, inbox, ticks, cfg)


def clone_state(s):
    """A copy of a state (or of any NamedTuple of tensors, such as an
    Inbox) whose tensors are its own."""
    return type(s)(*(t.clone() for t in s))


@functools.lru_cache(maxsize=None)
def make_step_fn(cfg: KernelConfig, donate: bool = True):
    """Return step(state, inbox, ticks) -> (state, output) for `cfg`.

    In-place update replaces the JAX package's jit donation: with
    donate=True the kernel updates the state tensors in place and returns
    them, so the caller must not reuse the state it passed in. With
    donate=False the state is cloned first and the caller's tensors stay as
    they were (what LoopbackCluster needs)."""
    if donate:
        return functools.partial(step_batch, cfg=cfg)

    def step(s, inbox, ticks):
        if s.term.device.type == "cuda":
            s = clone_state(s)
        return step_batch(s, inbox, ticks, cfg)

    return step


# ---------------------------------------------------------------------------
# K-step super-steps with the on-device router
# ---------------------------------------------------------------------------


def _add32(a, b):
    """a + b in i32 with two's-complement wraparound (what JAX does)."""
    b = b.to(torch.int64) if isinstance(b, torch.Tensor) else b
    return _wrap32(a.to(torch.int64) + b)


def route_step_output_reference(
    s: RaftTensors, out: StepOutput, route, rdelta, cfg: KernelConfig
) -> Tuple[Inbox, RoutePlan]:
    """The plain PyTorch router: build the NEXT inner step's inbox from this
    step's outputs by routing co-hosted traffic between lanes.

    ``route[g, p]`` is the lane behind peer slot p of lane g (-1 = not
    device-routable); ``rdelta[g, p]`` is the window base difference added
    to every index-valued field. Candidates are ordered kind-major
    (Replicate, RequestVote, Heartbeat, TimeoutNow, response plane,
    forwarded-read responses) then row-major, and a stable sort by
    destination lane assigns the first K arrivals of each lane to its inbox
    slots. A candidate past its destination's K slots is not routed (its
    RoutePlan bit stays False)."""
    G, P = s.member.shape
    K = cfg.inbox_depth
    R = cfg.readindex_depth
    dest, fields, efields = _route_columns(s, out, route, rdelta, cfg)
    nxt, routed = _route_scatter(dest, fields, efields, G, K)
    return nxt, _split_plan(routed, G, P, K, R)


def route_step_output(
    s: RaftTensors, out: StepOutput, route, rdelta, cfg: KernelConfig
) -> Tuple[Inbox, RoutePlan]:
    """The router between inner steps: the hand-written CUDA kernels
    (`csrc/route.cu`) for tensors on the card, the plain version for
    tensors on the CPU."""
    if s.term.device.type == "cuda":
        from .cuda import route_step_output_cuda

        return route_step_output_cuda(s, out, route, rdelta, cfg)
    return route_step_output_reference(s, out, route, rdelta, cfg)


def _route_columns(s: RaftTensors, out: StepOutput, route, rdelta, cfg: KernelConfig):
    """The router's candidate planes, flattened kind-major then row-major.
    Returns (dest, fields, (entry_terms, entry_cc)): ``dest`` is the
    destination lane per candidate (-1 = not a candidate), ``fields`` the
    ten scalar message columns in Inbox order, and the entry planes carry
    the Replicate payload metadata read off the sender's ring. Lane indexes
    in ``route``/``dest`` are global: a shard block's candidates may be
    addressed to any shard."""
    G, P = s.member.shape
    K = cfg.inbox_depth
    E = cfg.max_entries_per_msg
    R = cfg.readindex_depth
    W = s.log_term.shape[1]
    dev = route.device
    flags = out.send_flags
    self_col = s.self_slot[:, None]
    self_gp = self_col.expand(G, P)
    term_gp = out.term[:, None].expand(G, P)
    zi = lambda *shape: torch.zeros(shape, dtype=i32, device=dev)
    zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    full = lambda shape, v: torch.full(shape, v, dtype=i32, device=dev)
    zero_gp, false_gp, zero_gk, zero_gr = zi(G, P), zb(G, P), zi(G, K), zi(G, R)

    has_dest = route >= 0
    rep_want = ((flags & SEND_REPLICATE) != 0) & has_dest
    vote_want = ((flags & SEND_VOTE_REQ) != 0) & has_dest
    hb_want = ((flags & SEND_HEARTBEAT) != 0) & has_dest
    tn_want = ((flags & SEND_TIMEOUT_NOW) != 0) & has_dest
    precand_gp = (out.role == ROLE.PRE_CANDIDATE)[:, None].expand(G, P)

    # response plane: the destination is the lane behind the replied-to
    # slot; self-addressed responses and below-window REPLICATE_RESP
    # rejects stay host-side
    resp_to = torch.clamp(out.resp_to, 0, P - 1).long()
    resp_dest = torch.gather(route, 1, resp_to)
    resp_delta = torch.gather(rdelta, 1, resp_to)
    is_rresp = out.resp_type == MSG.REPLICATE_RESP
    is_hbresp = out.resp_type == MSG.HEARTBEAT_RESP
    below_window = is_rresp & out.resp_reject & (_add32(out.resp_hint, resp_delta) < 0)
    resp_want = (
        (out.resp_type != MSG.NONE)
        & (resp_dest >= 0)
        & (out.resp_to != self_col)
        & ~below_window
    )

    # confirmed forwarded reads: READ_INDEX_RESP back to the origin slot
    # encoded in the ctx (an arithmetic shift of the i32 ctx)
    ridx = torch.arange(R, dtype=i32, device=dev)[None, :]
    live = (ridx < out.ready_count[:, None]) & (out.ready_ctx != 0)
    origin = (out.ready_ctx >> 24) - 1
    origin_cl = torch.clamp(origin, 0, P - 1).long()
    rir_dest = torch.gather(route, 1, origin_cl)
    rir_delta = torch.gather(rdelta, 1, origin_cl)
    rir_want = live & (origin >= 0) & (origin != self_col) & (rir_dest >= 0)

    # Replicate entry metadata straight from the sender's ring
    e_off = torch.arange(E, dtype=torch.int64, device=dev)[None, None, :]
    e_idx = _wrap32(_add32(out.send_prev_index, 1).to(torch.int64)[:, :, None] + e_off)
    e_live = (e_off < out.send_n_entries[:, :, None]) & rep_want[:, :, None]
    slot = (e_idx % W).long().reshape(G, P * E)
    ring_t = torch.gather(s.log_term, 1, slot).reshape(G, P, E)
    ring_cc = torch.gather(s.log_is_cc, 1, slot).reshape(G, P, E)
    rep_terms = torch.where(e_live, ring_t, torch.zeros_like(ring_t))
    rep_cc = e_live & ring_cc
    no_ents = lambda n: (zi(G, n, E), zb(G, n, E))

    kinds = (
        # (want, dest, mtype, from, term, log_index, log_term, commit,
        #  reject, hint, hint2, n_entries, entry_terms, entry_cc)
        (
            rep_want, route, full((G, P), MSG.REPLICATE), self_gp, term_gp,
            _add32(out.send_prev_index, rdelta), out.send_prev_term,
            torch.clamp(_add32(out.send_commit, rdelta), min=0), false_gp,
            zero_gp, zero_gp, out.send_n_entries, rep_terms, rep_cc,
        ),
        (
            # a PRE_CANDIDATE lane's requests are REQUEST_PREVOTE at the
            # prospective term
            vote_want, route,
            _where(precand_gp, MSG.REQUEST_PREVOTE, full((G, P), MSG.REQUEST_VOTE)),
            self_gp, torch.where(precand_gp, _add32(term_gp, 1), term_gp),
            _add32(out.vote_last_index[:, None], rdelta),
            out.vote_last_term[:, None].expand(G, P), zero_gp, false_gp,
            out.send_hint, zero_gp, zero_gp, *no_ents(P),
        ),
        (
            # log_index carries the lease round tag untranslated
            hb_want, route, full((G, P), MSG.HEARTBEAT), self_gp, term_gp,
            out.lease_round[:, None].expand(G, P), zero_gp,
            torch.clamp(_add32(out.send_hb_commit, rdelta), min=0), false_gp,
            out.send_hint, out.send_hint2, zero_gp, *no_ents(P),
        ),
        (
            tn_want, route, full((G, P), MSG.TIMEOUT_NOW), self_gp, term_gp,
            zero_gp, zero_gp, zero_gp, false_gp, zero_gp, zero_gp, zero_gp,
            *no_ents(P),
        ),
        (
            resp_want, resp_dest, out.resp_type, self_col.expand(G, K),
            out.resp_term,
            torch.where(
                is_rresp, _add32(out.resp_log_index, resp_delta),
                torch.where(is_hbresp, out.resp_log_index, zero_gk),
            ),
            zero_gk, zero_gk,
            out.resp_reject & (
                is_rresp
                | (out.resp_type == MSG.REQUEST_VOTE_RESP)
                | (out.resp_type == MSG.REQUEST_PREVOTE_RESP)
            ),
            torch.where(
                is_rresp, torch.clamp(_add32(out.resp_hint, resp_delta), min=0),
                torch.where(is_hbresp, out.resp_hint, zero_gk),
            ),
            torch.where(is_hbresp, out.resp_hint2, zero_gk),
            zero_gk, *no_ents(K),
        ),
        (
            rir_want, rir_dest, full((G, R), MSG.READ_INDEX_RESP),
            self_col.expand(G, R), out.term[:, None].expand(G, R),
            _add32(out.ready_index, rir_delta), zero_gr, zero_gr, zb(G, R),
            out.ready_ctx, out.ready_ctx2, zero_gr, *no_ents(R),
        ),
    )

    def cat(col):
        return torch.cat([k[col].reshape(-1) for k in kinds])

    def cat_e(col):
        return torch.cat([k[col].reshape(-1, E) for k in kinds])

    to = cat(1)
    dest = torch.where(cat(0), to, torch.full_like(to, -1))
    fields = tuple(cat(c) for c in range(2, 12))
    return dest, fields, (cat_e(12), cat_e(13))


def _route_segments(P: int, K: int, R: int) -> Tuple[int, ...]:
    """Per-kind candidate counts per lane row in the kind-major layout
    (rep, vote, hb, tn, resp, rir)."""
    return (P, P, P, P, K, R)


def _route_scatter(dest, fields, efields, G: int, K: int):
    """Stable-sort the flattened candidates by destination lane and scatter
    the first K arrivals of each destination into a fresh Inbox. Returns
    (inbox, routed), ``routed`` being the accepted mask in the original
    candidate order. Dropped candidates go to a sentinel row G that is cut
    off (torch's index_put_ has no mode="drop")."""
    M = dest.shape[0]
    E = efields[0].shape[1]
    dev = dest.device
    key = torch.where(dest >= 0, dest, torch.full_like(dest, G))
    order = torch.argsort(key, stable=True)
    skey = key[order]
    first = torch.searchsorted(skey, skey, side="left").to(i32)
    slot = torch.arange(M, dtype=i32, device=dev) - first
    ok = (skey < G) & (slot < K)
    row = torch.where(ok, skey, torch.full_like(skey, G)).long()
    col = torch.where(ok, slot, torch.zeros_like(slot)).long()

    def scat(fill, vals):
        buf = torch.full((G + 1, K) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                         device=dev)
        buf[row, col] = vals[order]
        return buf[:G]

    nxt = Inbox(
        *(scat(MSG.NONE if i == 0 else 0, f) for i, f in enumerate(fields)),
        entry_terms=scat(0, efields[0]),
        entry_cc=scat(False, efields[1]),
    )
    routed = torch.zeros((M,), dtype=torch.bool, device=dev)
    routed[order] = ok
    return nxt, routed


def _split_plan(routed, G: int, P: int, K: int, R: int) -> RoutePlan:
    """Reshape the flat accepted mask into per-kind RoutePlan planes (the
    inverse of the kind-major flattening in _route_columns)."""
    gp, gk = G * P, G * K
    return RoutePlan(
        rep=routed[0:gp].reshape(G, P),
        vote=routed[gp:2 * gp].reshape(G, P),
        hb=routed[2 * gp:3 * gp].reshape(G, P),
        tn=routed[3 * gp:4 * gp].reshape(G, P),
        resp=routed[4 * gp:4 * gp + gk].reshape(G, K),
        rir=routed[4 * gp + gk:].reshape(G, R),
    )


def merge_residual(resid: Inbox, inbox: Inbox) -> Inbox:
    """Inner step 0's inbox: the carried residual rows where occupied, the
    host-packed rows elsewhere (the host packs at slots >= resid_count, so
    the merge is a disjoint select; the entry planes follow their slot)."""
    occ = resid.mtype != MSG.NONE

    def mg(r, h):
        m = occ
        while m.dim() < r.dim():
            m = m[..., None]
        return torch.where(m, r, h)

    return Inbox(*(mg(r, h) for r, h in zip(resid, inbox)))


def resid_count(resid: Inbox) -> torch.Tensor:
    """i32[G]: occupied slots of a residual inbox."""
    return (resid.mtype != MSG.NONE).sum(dim=1).to(i32)


def _stack(trees):
    return type(trees[0])(*(torch.stack(planes) for planes in zip(*trees)))


def multi_step_batch_reference(
    s: RaftTensors, inbox: Inbox, ticks, resid: Inbox, route, rdelta,
    cfg: KernelConfig, steps: int,
):
    """The plain super-step: ``steps`` sequential step_batch_reference calls
    glued by the plain router. Inner step 0 consumes the residual merged
    with the host inbox; host ticks apply to inner step 0 only. Returns
    (state, stacked StepOutput, stacked RoutePlan, residual Inbox,
    resid_count)."""
    ibx, tks = merge_residual(resid, inbox), ticks
    outs, plans = [], []
    for _ in range(steps):
        s, out = step_batch_reference(s, ibx, tks, cfg)
        ibx, plan = route_step_output_reference(s, out, route, rdelta, cfg)
        outs.append(out)
        plans.append(plan)
        tks = torch.zeros_like(tks)
    return s, _stack(outs), _stack(plans), ibx, resid_count(ibx)


def multi_step_batch(
    s: RaftTensors, inbox: Inbox, ticks, resid: Inbox, route, rdelta,
    cfg: KernelConfig, steps: int,
):
    """``steps`` protocol steps with co-hosted traffic routed between lanes
    after each one. On the card: the step kernel and the router kernels,
    writing every inner step's outputs into stacked planes allocated once
    and updating the state and the residual in place, with no host sync. On
    the CPU: multi_step_batch_reference."""
    if s.term.device.type == "cuda":
        from .cuda import multi_step_cuda

        return multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg, steps)
    return multi_step_batch_reference(s, inbox, ticks, resid, route, rdelta, cfg, steps)


@functools.lru_cache(maxsize=None)
def make_multi_step_fn(cfg: KernelConfig, steps: int, donate: bool = True):
    """multi_step(state, inbox, ticks, resid, route, rdelta) -> (state,
    outs, plans, resid, resid_count), ``steps`` inner steps per call.

    With donate=True the kernel path updates the state and the residual
    tensors in place (the JAX package donates both), so the caller must not
    reuse what it passed; donate=False clones them first."""

    def multi_step(s, inbox, ticks, resid, route, rdelta):
        if not donate and s.term.device.type == "cuda":
            s, resid = clone_state(s), clone_state(resid)
        return multi_step_batch(s, inbox, ticks, resid, route, rdelta, cfg, steps)

    return multi_step


# ---------------------------------------------------------------------------
# the sharded super-step: n lane blocks, each with its own tensors, and the
# candidate exchange between them after every inner step
# ---------------------------------------------------------------------------


def shard_tree(tree, n: int, axis: int = 0):
    """Split a tensor or a NamedTuple of tensors into n contiguous lane
    blocks along ``axis`` (0 for state-like trees, 1 for trees stacked over
    inner steps), each block a tensor of its own."""
    if isinstance(tree, torch.Tensor):
        G = tree.shape[axis]
        if G % n:
            raise ValueError(f"{G} lanes do not split into {n} equal shards")
        Gl = G // n
        return tuple(tree.narrow(axis, i * Gl, Gl).clone(memory_format=torch.contiguous_format)
                     for i in range(n))
    parts = [shard_tree(t, n, axis) for t in tree]
    return tuple(type(tree)(*(p[i] for p in parts)) for i in range(n))


def unshard_tree(trees, axis: int = 0):
    """Join lane blocks back into one tensor or tree along ``axis``."""
    if isinstance(trees[0], torch.Tensor):
        return torch.cat(list(trees), dim=axis)
    return type(trees[0])(*(torch.cat(list(p), dim=axis) for p in zip(*trees)))


def ring_gather_reference(slabs):
    """The plain candidate exchange: every shard gets the (n, C, Ml) stack
    of all n shards' (C, Ml) slabs, shard-major (lax.all_gather with
    tiled=False)."""
    return [torch.stack(list(slabs)) for _ in slabs]


def _gather_candidates(slabs, outs=None):
    """Per-shard (C, Ml) slabs -> per-shard (n, C, Ml) stacks: the
    hand-written gather kernel (`csrc/ring_gather.cu`) for slabs on the
    card, the plain version for slabs on the CPU."""
    if slabs[0].device.type == "cuda":
        from .cuda import ring_gather_cuda

        return ring_gather_cuda(slabs, outs)
    return ring_gather_reference(slabs)


def _pack_slab(dest, fields, efields):
    """(C, Ml) i32 with C = 11 + 2E: dest, the ten scalar columns, then E
    entry-term rows and E entry-cc rows (bools as 0/1)."""
    cols = [dest] + [f.to(i32) for f in fields]
    return torch.cat([torch.stack(cols)] + [ef.to(i32).T for ef in efields])


# The candidate record: what the card path exchanges in place of the slab
# (csrc/route.cu's header note). One flat i32 buffer per lane block of Gl
# lanes: the slab's first 11 rows [11][Ml], then one run of Xe = E +
# ceil(E/4) words per Replicate candidate (Gl * P of them, at their index in
# the Replicate block): E entry terms, then E cc flags as bytes, four to a
# word (flag e in bits 8 * (e % 4) of word E + e // 4). The slab's entry
# rows of every other kind are zero, so the record leaves them out.


def candidates_per_lane(cfg: KernelConfig) -> int:
    return sum(_route_segments(cfg.peers, cfg.inbox_depth, cfg.readindex_depth))


def entry_words(E: int) -> int:
    """Words of one Replicate's entry run in the record."""
    return E + (E + 3) // 4


def record_words(Gl: int, cfg: KernelConfig) -> int:
    """L: words of the candidate record of a block of Gl lanes."""
    return 11 * Gl * candidates_per_lane(cfg) + Gl * cfg.peers * entry_words(
        cfg.max_entries_per_msg)


def _pack_record(dest, fields, efields, cfg: KernelConfig):
    """The plain version of csrc/route.cu's columns kernel after
    _route_columns: the lane block's candidate record, an i32 vector of
    record_words(Gl, cfg) words."""
    E, P = cfg.max_entries_per_msg, cfg.peers
    runs = dest.shape[0] // candidates_per_lane(cfg) * P
    head = torch.stack([dest] + [f.to(i32) for f in fields])
    cc = efields[1][:runs].to(torch.int64)
    cc = torch.nn.functional.pad(cc, (0, (-E) % 4)).reshape(runs, -1, 4)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=dest.device)
    cc_words = (cc << shifts).sum(-1).to(i32)  # each byte 0 or 1: no overflow
    ents = torch.cat([efields[0][:runs].to(i32), cc_words], dim=1)
    return torch.cat([head.reshape(-1), ents.reshape(-1)])


def _widen_record(record, Gl: int, cfg: KernelConfig):
    """A lane block's candidate record back into the reference's (11 + 2E,
    Ml) slab (zero entry rows for every candidate but a Replicate)."""
    E, P = cfg.max_entries_per_msg, cfg.peers
    Ml, runs = Gl * candidates_per_lane(cfg), Gl * P
    if tuple(record.shape) != (record_words(Gl, cfg),):
        raise ValueError(f"a record of {Gl} lanes has {record_words(Gl, cfg)} words, "
                         f"got shape {tuple(record.shape)}")
    ents = record[11 * Ml:].reshape(runs, entry_words(E))
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=record.device)
    cc = (ents[:, E:].to(torch.int64)[:, :, None] >> shifts) & 0xFF
    slab = torch.zeros((11 + 2 * E, Ml), dtype=i32, device=record.device)
    slab[:11] = record[:11 * Ml].reshape(11, Ml)
    slab[11:11 + E, :runs] = ents[:, :E].T
    slab[11 + E:, :runs] = cc.reshape(runs, -1)[:, :E].T.to(i32)
    return slab


def _shard_route_reference(states, outs, routes, rdeltas, cfg: KernelConfig):
    """The plain cross-shard router: every shard's candidate slab is
    exchanged, each shard replays the global stable-sort scatter on the
    spliced global layout and keeps its own inbox rows and its own
    candidates' plan bits. Equal to the unsharded router on the
    concatenated state."""
    n = len(states)
    Gl, P = states[0].member.shape
    K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    G = n * Gl
    slabs = [_pack_slab(*_route_columns(s, o, r, d, cfg))
             for s, o, r, d in zip(states, outs, routes, rdeltas)]
    gathered = _gather_candidates(slabs)
    segs = _route_segments(P, K, R)
    nxts, plans = [], []
    for my, g in enumerate(gathered):
        # within one kind, shard-major order is global row-major order
        # because shards hold contiguous lane blocks
        parts, off = [], 0
        for seg in segs:
            L = Gl * seg
            parts.append(g[:, :, off:off + L].transpose(0, 1).reshape(g.shape[1], n * L))
            off += L
        gcols = torch.cat(parts, dim=1)
        gfields = list(gcols[1:11])
        gfields[6] = gfields[6] != 0  # reject
        ge_terms = gcols[11:11 + E].T
        ge_cc = gcols[11 + E:11 + 2 * E].T != 0
        nxt_g, routed_g = _route_scatter(gcols[0], tuple(gfields), (ge_terms, ge_cc), G, K)
        nxts.append(Inbox(*(a[my * Gl:(my + 1) * Gl] for a in nxt_g)))
        lparts, goff = [], 0
        for seg in segs:
            L = Gl * seg
            lparts.append(routed_g[goff + my * L:goff + (my + 1) * L])
            goff += n * L
        plans.append(_split_plan(torch.cat(lparts), Gl, P, K, R))
    return nxts, plans


def _shard_route(states, outs, routes, rdeltas, cfg: KernelConfig):
    """route_step_output over n lane blocks, each with its own tensors and
    global lane indexes in its ``route`` block: the router kernels and the
    gather kernel for tensors on the card, the plain version on the CPU.
    Returns (per-shard next Inbox, per-shard RoutePlan)."""
    if states[0].term.device.type == "cuda":
        from .cuda import shard_route_cuda

        return shard_route_cuda(states, outs, routes, rdeltas, cfg)
    return _shard_route_reference(states, outs, routes, rdeltas, cfg)


def sharded_multi_step_batch(states, inboxes, ticks, resids, routes, rdeltas,
                             cfg: KernelConfig, steps: int):
    """multi_step_batch over n lane blocks: the step runs on each block with
    the global cfg (every shape comes from the tensors), and only the
    router between inner steps crosses blocks. Each argument is a sequence
    of n per-shard trees; so is each result. Same results as the unsharded
    super-step on the concatenated state."""
    if states[0].term.device.type == "cuda":
        from .cuda import sharded_multi_step_cuda

        return sharded_multi_step_cuda(states, inboxes, ticks, resids, routes,
                                       rdeltas, cfg, steps)
    n = len(states)
    sts = list(states)
    ibxs = [merge_residual(r, h) for r, h in zip(resids, inboxes)]
    tks = list(ticks)
    outs, plans = [[] for _ in range(n)], [[] for _ in range(n)]
    for _ in range(steps):
        step_outs = []
        for i in range(n):
            sts[i], o = step_batch_reference(sts[i], ibxs[i], tks[i], cfg)
            step_outs.append(o)
            outs[i].append(o)
        ibxs, pl = _shard_route(sts, step_outs, routes, rdeltas, cfg)
        for i in range(n):
            plans[i].append(pl[i])
        tks = [torch.zeros_like(t) for t in tks]
    return (tuple(sts), tuple(_stack(o) for o in outs), tuple(_stack(p) for p in plans),
            tuple(ibxs), tuple(resid_count(b) for b in ibxs))


@functools.lru_cache(maxsize=None)
def make_sharded_multi_step_fn(cfg: KernelConfig, steps: int, devices, donate: bool = True):
    """The sharded super-step over ``devices``, a tuple of one
    torch.device per shard: fn(states, inboxes, ticks, resids, routes,
    rdeltas), each a sequence of n per-shard trees (see shard_tree), ->
    (states, outs, plans, resids, resid_counts), each a tuple of n. The
    shards are logical: all of them live on one device (several lane blocks
    of one card, or of the CPU). Shards on distinct cards are not supported
    yet (ROADMAP queue 2, item G). With donate=True the kernel path updates
    each shard's state and residual in place; donate=False clones them."""
    devs = tuple(torch.device(d) for d in devices)
    if len(set(devs)) != 1:
        raise NotImplementedError(
            "shards on distinct devices need the multi-card gather "
            "(ROADMAP queue 2, item G); give every shard the same device")
    n, dev = len(devs), devs[0]

    def sharded_multi_step(states, inboxes, ticks, resids, routes, rdeltas):
        args = (states, inboxes, ticks, resids, routes, rdeltas)
        if any(len(a) != n for a in args):
            raise ValueError(f"every argument must hold {n} shards")
        if any(s.term.device != dev for s in states):
            raise ValueError(f"the shards' state must live on {dev}")
        if not donate and dev.type == "cuda":
            states = [clone_state(s) for s in states]
            resids = [clone_state(r) for r in resids]
        return sharded_multi_step_batch(states, inboxes, ticks, resids, routes,
                                        rdeltas, cfg, steps)

    return sharded_multi_step
