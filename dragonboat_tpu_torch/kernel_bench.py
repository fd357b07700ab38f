"""Bare-kernel benchmark: the device ceiling of the protocol step.

The counterpart of the JAX package's `bench.py:kernel_step`/`bench_kernel`:
one voting replica per group, so every proposal commits at once, and every
inbox slot of every group carries a full E-entry PROPOSE. Quorum, transport
and fsync are excluded by design; this measures the step kernel alone.

Times come from CUDA events around each step after a warm-up. The module
also carries the byte count of one step (for its bound on the card) and a
seeded random inbox generator used to hold the kernel against its plain
version.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .ops.kernel import _term_at, step_batch
from .ops.state import (
    MSG,
    Inbox,
    KernelConfig,
    RaftTensors,
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
