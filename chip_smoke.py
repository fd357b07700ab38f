"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
drives the port's main path (a 3-replica x 1024-group loopback cluster at
BASELINE config 2's engine shape: elect, propose, read, transfer) through
them, holds every kernel against its plain PyTorch version on the card,
and measures the step kernel at the 50,000-group kernel regime; phase 2
also holds it at P=5, the 5-replica configs' shape (5120 co-hosted
lanes). Phase 4 drives the super-step path at BASELINE config 6's shape
(3072 co-hosted lanes, K=8 inner steps with the on-device router),
unsharded and as 4
logical shards of the card exchanging candidates through the gather
kernel, in lockstep with the plain path, holds the columns kernel's
candidate records against their plain version word for word, times the
router (its columns kernel and the scatter's insert and write passes, per
pass, per router call and per shard) and gather kernels, and prints what
ptxas reported for every kernel. Phase 5 runs the port's engine through
its public entry, `dragonboat_tpu_torch.e2e.run_ladder_config` (the
config's NodeHosts sharing one engine core, WAL and fsync in a temp dir):
BASELINE configs 2 and 6 (1024 groups x 3 replicas, K=1 and K=8), then 1
(one group), 3 (9 ReadIndex reads per write), 4 (1% of replication
traffic dropped), 5 (snapshots and membership churn) at 512 groups x 5
replicas, 8 (ReadIndex reads, then lease reads, 1024 groups x 3) and 7
(64 groups x 3 through the serving fronts: per-tenant admission,
sessions, placement planes), with gates on elections, commits, replica
convergence, a linearizable history, syncs outside the blessed seams,
kernel builds, each config's reads, lease serves, drops, snapshots,
membership changes and sessions, and the kernels each path launched
(the step, at K=8 the router, and the activation kernel). Phase 6 puts the fault plane on the card:
one seed of the chaos matrix (3 hosts on one core, 30% of replication
dropped, seeded partitions; converged and linearizable) and the overload
storm's graceful-degradation verdict on one group. Phase 7 runs the
operator tools against live NodeHosts at config 2's width (3 hosts x
1024 groups on one core): tools.top collects from the serving hosts and
one group's snapshot is exported; after stop logdbcheck, checkdisk,
timeline and doctor read what they left; tools.importer repairs the
exported group as a one-member group on the card, which reads back
every acknowledged write; then tools.perfdiff, tools.check over the port
and the helloworld example. Phase 8 runs tools.longhaul on the vector
engine on the card at the runner's own shape (3 hosts and a churn host,
32 lanes each): a seed-rotated run over the whole scenario mix (crash and
restart with torn WAL tails, partitions, drops, fsync stalls, membership,
observer and witness churn, transfers, snapshots, overload, pre-vote
rejoin storms, streamed installs under crash, live rebalance, lease reads
under clock chaos), a round at K=8 on the on-device router, the rebalance
and rejoin families, and an injected failure whose forensic bundle must
be complete; every other round must pass every verdict (lincheck,
convergence, Log Matching, fairness), the preflight tools.check must
find nothing, and each round's schedule signature must be the one the
JAX package's runner draws for its seed. Phase 9 runs half config 2's
width (512 groups x 3) with every host's log over the native WAL store (NativeWalKV) and every
group's state machine the C++ KV plugin: elected, linearizable, every
group's replicas at one C++ SM hash; then the on-disk C++ plugin's
restart and the C embedding ABI's two demo applications, linked against
the port's own libdbtpu.so, with their NodeHosts on the card. Phase 10
runs the sharded path (`EngineConfig.shard_over_mesh`) over 4 logical
shards of the card, each its own lane block, state tree and CUDA stream,
the candidate gather launched once per destination shard and ordered by
events: the sharded super-step at config 6's shape in lockstep with the
plain sharded version and at 50,000 lanes with the plain one (every
field), its wall and busy time against the unsharded one's, then configs
6 and 2 (at 512 groups x 3) through NodeHost with shard_over_mesh (every gate, the mesh
stamps, no host message for co-hosted traffic at K=8, the launches of
every kernel per shard); it prints how many distinct cards it spanned,
and where several are visible also runs over them. Phase 11 runs the
reference's engine-level scenarios through NodeHost on the card and
asserts their tests' verdicts: witness lanes (zero payload, the witness
in the commit quorum) at K=1 and on a K=8 core, and the pre-vote rejoin
storm with pre-vote on and off, each at half config 2's width (512 groups
x 3 replicas on one core); the lease grant, local read, probe and fallback;
a streamed install resumed after a host crash, and its abort; a crash
mid snapshot save, then the rejoin; each scenario's recorded states
(witnesses, pre-candidates, live leases, installs in flight) then hold
the step kernel, and at K=8 the router, against their plain versions.
Phase 12 runs the reference's last five engine-level test files' own
bodies on the card (tests/torch_twin.py copies them onto the port with
their engines there) and asserts what they assert: a bulk fleet bring-up
through start_clusters (2,048 single-replica groups, each led by its only
replica) and a bulk start restarted through start_cluster; the
observability host under its three engine tests; a causal trace chain
across 3 hosts under a seeded partition schedule, rendered by
tools.timeline; 1,024 lanes electing and committing, and 256 quiesced
lanes, over whose idle second no step launches; chaos at vector scale
(drops, partitions, NodeHost kills and restarts) at 512 x 3 lanes,
every group converged, linearizable and obeying Log Matching. It also
brings 1,024 groups x 3 replicas up on one core and runs the
observability census and history bodies there, and holds the step
kernel on the steps just after bulk starts, stops, restarts, partitions,
drops and the wake from quiesce as well. Phase 13 runs the vector
engine's follower catch-up on the card: 32 groups of 1,024 x 3 on one
shared K=8 core each add a replica on a fourth host that joins as an
empty member and is caught up from its leader's host log (ROADMAP §3
fault 1), and the retry storm of fault 6; a member caught up below a
rebased window (fault 11); the window rebase at config 2's width
(rebase_wide: 1,024 x 3 lanes on a K=1 core and on a shared K=8 core,
the rebase threshold lowered to 512, 32 groups each committing 897
proposals, every rebase held against its plain versions, at K=8 with
parked rows in the residual inbox); and a snapshot install whose
recovery waits while the step appends, on both engines (fault 9), with
no log hole and no save without its payload; then the reference bodies of
the last eleven test files that drive the vector engine (restarts, 50
lane restarts with no growth of the card's allocated memory, batched
proposals, snapshot requests and external files, compression, the rate
limiter, SQLite storage, chaos, the tick clamp and starvation gauges,
health metrics, full-width ReadIndex contexts; the rate limiter's burst
prints the in-memory log size it reached beside its limit). The kernels
are also held on the super-steps just after each joiner's first reject
and each host-log catch-up start. Phase 13 ends with three start/stop
cycles of 3 NodeHosts x 32 groups in each of three shapes (each host on
its own K=1 engine, one shared K=8 core, that core over 4 logical
shards): after every stop the card's allocated bytes are those before the
first start (ROADMAP §3 fault 13), and the blocks a stop leaves are listed
by allocating frame. Lane activation runs as one kernel
(csrc/activate.cu) a batch: phase 3 holds it against its plain version,
bit for bit on every plane, at config 2's engine shape (3,072 lanes) at
three buckets and at 50,000 lanes, and times it, the plain version and
the engine's host side of one batch; phase 12 holds the first four
activation batches of its bulk start of 1,024 x 3 against the plain
version. The window rebase runs as one kernel (csrc/rebase.cu) a shard:
phase 3 holds it against its plain versions at 1,024, 3,072 and 50,000
lanes and with config 6's residual inbox, and times both.
After
each K=1 engine run of phases 5-9 the step kernel is held against its
plain version on states that run stepped, at its own lanes, window and
inbox depth, and after phase 8's K=8 round the kernel super-step (step
and router kernels) against the plain one. It exits non-zero,
printing no result, when no CUDA device is
present or any phase fails. The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -------------------------------------------------------------- comparison

SENTINELS = ((-1431655766, True), (0, False))
# the 50,000-group kernel regime of bench.py:1282-1285
BENCH_GROUPS, BENCH_STEPS = 50_000, 50


def fill(out, value, flag):
    for t in out:
        if t.dtype == torch.bool:
            t.fill_(flag)
        elif t.dtype == torch.uint32:
            t.view(torch.int32).fill_(value)
        else:
            t.fill_(value)


def as_i64(t):
    return (t.view(torch.int32) if t.dtype == torch.uint32 else t).to(torch.int64)


def compare_case(K, cuda, cfg, state, inbox, ticks):
    """Run kernel and plain version on clones of one (state, inbox, ticks),
    once per sentinel fill of the kernel's output buffers. Returns the
    names of the mismatched fields and the largest absolute difference."""
    ref_s, ref_o = K.step_batch_reference(K.clone_state(state), inbox, ticks, cfg)
    bad, err = set(), 0
    for value, flag in SENTINELS:
        out = cuda.empty_output(cfg, state.term.device)
        fill(out, value, flag)
        ker_s, ker_o = cuda.step_batch_cuda(K.clone_state(state), inbox, ticks, cfg, out=out)
        torch.cuda.synchronize()
        for prefix, a, b in (("state.", ref_s, ker_s), ("out.", ref_o, ker_o)):
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                if x.dtype != y.dtype or x.shape != y.shape:
                    bad.add(prefix + f)
                    continue
                d = int((as_i64(x) - as_i64(y)).abs().max()) if x.numel() else 0
                if d:
                    bad.add(prefix + f)
                    err = max(err, d)
    return sorted(bad), err


class StepRecorder:
    """While entered, keeps copies of the (state, inbox, ticks, cfg) that
    the vector engine's K=1 step is called with, spread over the whole
    run: one call in 4, halved (and the stride doubled) whenever 6 are
    held. `pin(why)` also keeps the next call, whatever the stride, in
    `pinned` (at most PIN_CAP for each reason). The copies are clones on
    the engine's stream (no host read, no launch), for holding the kernel
    against its plain version afterwards at the shapes the engine really
    ran. The recorder entered last is `StepRecorder.active`."""

    active = None
    PIN_CAP = 2

    def __init__(self, K):
        self.K, self.keep, self.every, self.calls, self.kept = K, 3, 4, 0, []
        self.pinned, self.pending, self.pins = [], set(), {}

    def pin(self, why):
        if self.pins.get(why, 0) < self.PIN_CAP:
            self.pending.add(why)

    @property
    def states(self):
        """(why, copy) of every state kept: "stride" or the pin's reasons."""
        return [("stride", k) for k in self.kept] + self.pinned

    def __enter__(self):
        from dragonboat_tpu_torch.engine import vector

        self._vector, self._inner = vector, vector.step_batch
        clone = self.K.clone_state

        def step(s, inbox, ticks, cfg, out=None):
            self.calls += 1
            whys, stride = self.pending, self.calls % self.every == 0
            copy = (clone(s), clone(inbox), ticks.clone(), cfg) if whys or stride else None
            if whys:
                self.pending = set()
                for w in whys:
                    self.pins[w] = self.pins.get(w, 0) + 1
                self.pinned.append(("+".join(sorted(whys)), copy))
            if stride:
                self.kept.append(copy)
                if len(self.kept) == 2 * self.keep:
                    self.kept, self.every = self.kept[1::2], 2 * self.every
            return self._inner(s, inbox, ticks, cfg, out=out)

        vector.step_batch = step
        StepRecorder.active = self
        return self

    def __exit__(self, *exc):
        self._vector.step_batch = self._inner
        StepRecorder.active = None
        return False


def compare_recorded(K, cuda, rec, seed):
    """The kernel against its plain version on every copy `rec` kept: on
    the inbox and ticks the engine stepped it with and on two random
    inboxes (kernel_bench.random_inbox), every field, each sentinel fill.
    Fails on any mismatch. Returns the shape, the number of cases, the
    largest error, how many lanes had a wrapped log ring (last index at
    or past the window), each state's reason with its active and quiesced
    lanes, and the seconds the comparison took."""
    from dragonboat_tpu_torch.kernel_bench import random_inbox
    from dragonboat_tpu_torch.ops.convert import state_from_numpy, state_to_numpy

    assert rec.states, "the engine's step was never recorded"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    cases, bad_all, err_all, wrapped, top, per_state = 0, set(), 0, 0, 0, []
    for why, (st, ib, ticks, cfg) in rec.states:
        npst = state_to_numpy(st)
        per_state.append([why, int(npst["active"].sum()), int(npst["quiesced"].sum())])
        wrapped = max(wrapped, int((npst["last_index"] >= cfg.log_window).sum()))
        top = max(top, int(npst["last_index"].max()))
        draws = [(ib, ticks)] + [
            (state_from_numpy(random_inbox(rng, npst, cfg), "cuda"),
             torch.from_numpy(rng.integers(0, 3, cfg.groups).astype(np.int32)).cuda())
            for _ in range(2)]
        for d, t in draws:
            bad, err = compare_case(K, cuda, cfg, st, d, t)
            cases += 1
            bad_all |= set(bad)
            err_all = max(err_all, err)
    cfg = rec.states[-1][1][3]
    out = {"lanes": cfg.groups, "peers": cfg.peers, "log_window": cfg.log_window,
           "inbox_depth": cfg.inbox_depth, "cases": cases, "states": len(per_state),
           "mismatched_fields": sorted(bad_all), "max_abs_err": err_all,
           "wrapped_lanes": wrapped, "max_last_index": top,
           "active_quiesced_lanes": per_state,
           "seconds": round(time.perf_counter() - t0, 2)}
    assert not bad_all, f"kernel disagrees with the plain version at the engine's shape: {out}"
    return out


def time_ms(fn, reps):
    """Mean device time of fn() over reps runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ phases

def phase_cluster(K, cuda, groups=1024, device="cuda"):
    """The main path: 3 replicas x 1024 groups through the CUDA kernel."""
    from dragonboat_tpu_torch.ops.loopback import LoopbackCluster
    from dragonboat_tpu_torch.ops.state import KernelConfig, ROLE

    cfg = KernelConfig(groups=groups, peers=4, log_window=256, inbox_depth=4,
                       max_entries_per_msg=64, readindex_depth=4)
    G, n = cfg.groups, 3
    t0 = time.perf_counter()
    c = LoopbackCluster(n_replicas=n, n_groups=G, cfg=cfg, election=10,
                        heartbeat=2, check_quorum=True, device=device)
    log(f"cluster: configured {n} x {G} lanes in {time.perf_counter() - t0:.1f}s")

    # keep (state, inbox, ticks) triples of replica 0 for the comparison
    kept, want, calls = [], [0], [0]
    inner = c.step_fn

    def recording_step(s, inbox, ticks):
        if calls[0] % n == 0 and want[0] > 0:
            want[0] -= 1
            kept.append((K.clone_state(s), type(inbox)(*(t.clone() for t in inbox)),
                         ticks.clone()))
        calls[0] += 1
        return inner(s, inbox, ticks)

    c.step_fn = recording_step
    roles = lambda: torch.stack([st.role for st in c.states]).cpu().numpy()

    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    K.REFERENCE_CALLS["step_batch"] = 0
    t0 = time.perf_counter()
    rounds = 0
    # 1. elect: tick until every group has exactly one leader
    for r in range(120):
        if r in (8, 12, 16):
            want[0] += 1
        c.run(1)
        rounds += 1
        if ((roles() == ROLE.LEADER).sum(0) == 1).all():
            break
    leaders = (roles() == ROLE.LEADER).argmax(0)
    assert ((roles() == ROLE.LEADER).sum(0) == 1).all(), "not every group elected one leader"
    log(f"cluster: all {G} groups elected in {rounds} ticks")
    # 2. propose: three full E-entry batches to every leader, then settle
    E = cfg.max_entries_per_msg
    base = torch.stack([st.committed for st in c.states]).cpu().numpy().max(0)
    for g in range(G):
        for _ in range(3):
            c.propose(int(leaders[g]), g, n=E)
    want[0] += 3
    c.settle(40)
    c.run(3)
    committed = torch.stack([st.committed for st in c.states]).cpu().numpy()
    assert (committed == committed[0]).all(), "replicas disagree on committed"
    assert (committed[0] >= base + 3 * E).all(), "proposals did not all commit"
    for g in range(0, G, 97):
        hi = int(committed[0, g])
        ref = c.ring_terms(0, g, 1, hi)
        assert all(c.ring_terms(h, g, 1, hi) == ref for h in range(n)), g
    # 3. read: one ReadIndex per group on its leader
    leaders = (roles() == ROLE.LEADER).argmax(0)
    for g in range(G):
        c.read_index(int(leaders[g]), g, ctx=g + 1)
    want[0] += 2
    c.run(3)
    got = {(g, ctx) for h in range(n) for (g, ctx, _i, _c2) in c.ready_reads[h]}
    missing = [g for g in range(G) if (g, g + 1) not in got]
    assert not missing, f"reads not delivered in groups {missing[:8]}"
    # 4. transfer leadership in 16 groups
    moved = list(range(0, G, max(G // 16, 1)))[:16]
    targets = {g: (int(leaders[g]) + 1) % n for g in moved}
    for g in moved:
        c.transfer_leader(int(leaders[g]), g, targets[g])
    want[0] += 2
    c.run(8)
    leaders = roles()
    failed = [g for g in moved if leaders[targets[g], g] != ROLE.LEADER]
    assert not failed, f"transfer did not move leadership in groups {failed}"
    wall = time.perf_counter() - t0
    launches = cuda.LAUNCHES["step_batch"]
    plain = K.REFERENCE_CALLS["step_batch"]
    assert launches > 0, "the main path launched no step_batch kernel"
    assert plain == 0, f"the plain version ran {plain} times on the main path"
    log(f"cluster: ok, {calls[0] // n} rounds, {launches} step_batch launches, "
        f"0 plain-version calls, {wall:.1f}s wall, {len(kept)} triples kept")
    return cfg, kept, launches


def phase_compare(K, cuda, cfg, kept, big):
    """Kernel against the plain version, both on the card, every field."""
    from dragonboat_tpu_torch.kernel_bench import random_inbox
    from dragonboat_tpu_torch.ops.convert import state_from_numpy, state_to_numpy

    cases, bad_all, err_all = 0, set(), 0
    for st, ib, ticks in kept:
        bad, err = compare_case(K, cuda, cfg, st, ib, ticks)
        cases += 1
        bad_all |= set(bad)
        err_all = max(err_all, err)
    bcfg, bstate, binbox, bticks = big
    bad, err = compare_case(K, cuda, bcfg, bstate, binbox, bticks)
    cases += 1
    bad_all |= set(bad)
    err_all = max(err_all, err)
    rng = np.random.default_rng(20261016)
    for cfg_i, st in ((bcfg, bstate), (cfg, kept[-1][0] if kept else None)):
        if st is None:
            continue
        npst = state_to_numpy(st)
        for _ in range(2):
            ib = state_from_numpy(random_inbox(rng, npst, cfg_i), "cuda")
            ticks = torch.from_numpy(rng.integers(0, 3, cfg_i.groups).astype(np.int32)).cuda()
            bad, err = compare_case(K, cuda, cfg_i, st, ib, ticks)
            cases += 1
            bad_all |= set(bad)
            err_all = max(err_all, err)
    log(f"compare: {cases} cases, mismatched fields: {sorted(bad_all) or 0}")
    return cases, sorted(bad_all), err_all


# the 5-replica configs' kernel shape (BASELINE configs 3-5 through the
# shared core: bench.py:307-320 widths, 1024 groups x 5 replicas)
P5_GROUPS, P5_REPLICAS, P5_STEPS = 1024, 5, 8


def phase_compare_p5(K, cuda, kb):
    """step_batch at P=5 (max_peers=5, log_window=256, inbox_depth=4,
    readindex_depth=4, 5120 co-hosted lanes): states captured from 8
    windows of the config-6 scenario at 5 replicas (elections, proposals,
    forwarded reads, a leader change and transfers, each window K=8 steps
    of the plain path with the plain router), each stepped on its window's
    host inbox and on two random inboxes, kernel against plain version,
    every field; fails unless 3-of-5 elections left every group led.
    Returns (cases, mismatched fields, max error, cfg, the state and
    inbox of the last case)."""
    from dragonboat_tpu_torch.kernel_bench import random_inbox
    from dragonboat_tpu_torch.ops.convert import state_from_numpy, state_to_numpy
    from dragonboat_tpu_torch.ops.state import ROLE, make_empty_inbox

    cfg = kb.superstep_config(P5_GROUPS, P5_REPLICAS)
    dev = torch.device("cuda", 0)
    s, route, rdelta = kb.superstep_cluster(P5_GROUPS, P5_REPLICAS, cfg, dev)
    G = cfg.groups
    ticks = torch.ones((G,), dtype=torch.int32, device=dev)
    resid = make_empty_inbox(cfg, dev)
    rc = torch.zeros((G,), dtype=torch.int32, device=dev)
    leaders = np.zeros(P5_GROUPS, np.int64)
    rng = np.random.default_rng(SS_SEED + 5)
    cases, bad_all, err_all, last = 0, set(), 0, None
    for w in range(SS_WINDOWS):
        ib, leaders = kb.host_window(w, rc, leaders, P5_GROUPS, P5_REPLICAS, cfg, rng, dev)
        if w in (1, 3, 5, 7):
            npst = state_to_numpy(s)
            draws = [ib] + [state_from_numpy(random_inbox(rng, npst, cfg), "cuda")
                            for _ in range(2)]
            for d in draws:
                bad, err = compare_case(K, cuda, cfg, s, d, ticks)
                cases += 1
                bad_all |= set(bad)
                err_all = max(err_all, err)
            last = (K.clone_state(s), ib)
        s, _o, _pl, resid, rc = K.multi_step_batch_reference(
            s, ib, ticks, resid, route, rdelta, cfg, P5_STEPS)
        kb.compact(s)
    lanes = torch.from_numpy(leaders).to(dev)
    led = int((s.role[lanes] == ROLE.LEADER).sum())
    log(f"compare P=5 @ {G} lanes (W={cfg.log_window} K={cfg.inbox_depth} "
        f"R={cfg.readindex_depth}): {cases} cases, {led}/{P5_GROUPS} groups led, "
        f"mismatched fields: {sorted(bad_all) or 0}")
    assert led == P5_GROUPS, "the P=5 scenario did not elect every group"
    return cases, sorted(bad_all), err_all, cfg, last


# ------------------------------------------------- phase 4: the super-step

# BASELINE config 6 (bench.py:1149-1157): config 2's 1024 groups x 3
# replicas at steps_per_sync=8, co-hosted in one state of 3072 lanes
SS_GROUPS, SS_REPLICAS, SS_STEPS, SS_WINDOWS, SS_SHARDS = 1024, 3, 8, 8, 4
SS_SEED = 20261016


def cmp_view(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def mismatches(a, b, prefix=""):
    """Names of the fields of two trees that differ in dtype, shape or any
    element."""
    bad = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(cmp_view(x), cmp_view(y)):
            bad.append(prefix + f)
    return bad


def superstep_mismatches(x, y):
    """Fields that differ between two super-step results (state, stacked
    outputs, stacked plans, residual, resid_count)."""
    bad = []
    for prefix, a, b in zip(("state.", "outs.", "plans.", "resid."), x[:4], y[:4]):
        bad += mismatches(a, b, prefix)
    if not torch.equal(x[4], y[4]):
        bad.append("resid_count")
    return bad


def check_superstep_launches(counts, plain_calls, inner_steps, n):
    """Every kernel of the path ran: per inner step one step, one columns
    and one of each scatter pass unsharded and n of each sharded, n
    gathers (sharded only: one per destination shard), and one plain step
    on the plain path."""
    for name in MESH_KERNELS:
        assert counts[name] > 0, f"the super-step path launched no {name} kernel"
    for name in ("step_batch", "route_columns", "route_index", "route_scatter"):
        assert counts[name] == inner_steps * (1 + n), counts
    assert counts["ring_gather"] == inner_steps * n, counts
    assert plain_calls == inner_steps, f"the plain path ran {plain_calls} steps"


def phase_superstep(K, cuda, kb):
    """Config 6's shape through the super-step path: the kernel path
    unsharded, the kernel path as 4 logical shards of the card, and the
    plain path (K sequential step_batch_reference calls glued by the plain
    router), in lockstep, equal on every field after every window."""
    from dragonboat_tpu_torch.ops.state import CTR, ROLE, make_empty_inbox

    cfg = kb.superstep_config(SS_GROUPS, SS_REPLICAS)
    G, n, steps = cfg.groups, SS_SHARDS, SS_STEPS
    dev = torch.device("cuda", 0)
    s0, route, rdelta = kb.superstep_cluster(SS_GROUPS, SS_REPLICAS, cfg, dev)
    routes, rdeltas = K.shard_tree(route, n), K.shard_tree(rdelta, n)
    multi = K.make_multi_step_fn(cfg, steps)
    smulti = K.make_sharded_multi_step_fn(cfg, steps, (dev,) * n)
    ticks = torch.ones((G,), dtype=torch.int32, device=dev)
    sticks = K.shard_tree(ticks, n)

    s_k, s_p = K.clone_state(s0), K.clone_state(s0)
    s_sh = K.shard_tree(K.clone_state(s0), n)
    resid_k, resid_p = make_empty_inbox(cfg, dev), make_empty_inbox(cfg, dev)
    resid_sh = K.shard_tree(make_empty_inbox(cfg, dev), n)
    rc = torch.zeros((G,), dtype=torch.int32, device=dev)
    leaders = torch.zeros(SS_GROUPS, dtype=torch.int64).numpy()
    rng = np.random.default_rng(SS_SEED)
    hosts, kept, bad_all = [], None, set()

    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    K.REFERENCE_CALLS["step_batch"] = 0
    t0 = time.perf_counter()
    for w in range(SS_WINDOWS):
        ib, leaders = kb.host_window(w, rc, leaders, SS_GROUPS, SS_REPLICAS, cfg, rng, dev)
        hosts.append((ib, leaders.copy()))
        if w == 3:
            kept = (K.clone_state(s_k), ib)
        # no host sync inside a super-step, on either kernel path
        torch.cuda.set_sync_debug_mode("error")
        try:
            res_k = multi(s_k, ib, ticks, resid_k, route, rdelta)
            res_sh = smulti(s_sh, K.shard_tree(ib, n), sticks, resid_sh, routes, rdeltas)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        res_p = K.multi_step_batch_reference(s_p, ib, ticks, resid_p, route, rdelta, cfg, steps)
        res_shj = (K.unshard_tree(res_sh[0]), K.unshard_tree(res_sh[1], axis=1),
                   K.unshard_tree(res_sh[2], axis=1), K.unshard_tree(res_sh[3]),
                   K.unshard_tree(res_sh[4]))
        bad = set(superstep_mismatches(res_k, res_p)) | set(
            "sharded." + f for f in superstep_mismatches(res_shj, res_p))
        bad_all |= bad
        s_k, outs_k, plans_k, resid_k, rc = res_k
        s_sh, resid_sh, s_p, resid_p = res_sh[0], res_sh[3], res_p[0], res_p[3]
        for st in (s_k, s_p, *s_sh):
            kb.compact(st)
        lanes = torch.from_numpy(leaders).to(dev)
        led = int((s_k.role[lanes] == ROLE.LEADER).sum())
        log(f"superstep window {w}: leaders {led}/{SS_GROUPS}, routed "
            f"{int(sum(int(p.sum()) for p in plans_k))}, residual {int(rc.sum())}, "
            f"commit advances {int(cmp_view(outs_k.counters)[:, :, CTR.COMMIT_ADVANCES].sum())}, "
            f"mismatched fields {sorted(bad) or 0}")
    wall = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    plain_calls = K.REFERENCE_CALLS["step_batch"]
    check_superstep_launches(counts, plain_calls, SS_WINDOWS * steps, n)
    fin = s_k
    assert int(fin.committed[:SS_GROUPS].min()) > 0, "a group committed nothing"
    lanes = torch.from_numpy(leaders).to(dev)
    assert bool((fin.role[lanes] == ROLE.LEADER).all()), "a scheduled leader does not lead"
    moved = torch.arange(0, SS_GROUPS, 4, device=dev)
    assert bool((fin.role[SS_GROUPS + moved] == ROLE.LEADER).all()), "the leader change failed"
    log(f"superstep: {SS_WINDOWS} windows x {steps} steps, 3 paths in lockstep in "
        f"{wall:.1f}s, launches {counts}, mismatched fields {sorted(bad_all) or 0}")
    if bad_all:
        raise AssertionError(f"super-step paths disagree on {sorted(bad_all)}")
    return cfg, s0, route, rdelta, hosts, kept, counts


def phase_residual(K, cuda, kb):
    """A residual-carrying super-step on the card: at K=2 an election's
    vote responses are still in flight when the super-step ends, so the
    next (host-empty) super-steps consume a non-empty residual. The kernel
    path, unsharded and sharded, against the plain path, every field."""
    from dragonboat_tpu_torch.ops.state import ROLE, make_empty_inbox

    cfg = kb.superstep_config(SS_GROUPS, SS_REPLICAS)
    G, n, steps = cfg.groups, SS_SHARDS, 2
    dev = torch.device("cuda", 0)
    s0, route, rdelta = kb.superstep_cluster(SS_GROUPS, SS_REPLICAS, cfg, dev)
    multi = K.make_multi_step_fn(cfg, steps)
    smulti = K.make_sharded_multi_step_fn(cfg, steps, (dev,) * n)
    ticks = torch.zeros((G,), dtype=torch.int32, device=dev)
    s_k, s_p, s_sh = K.clone_state(s0), K.clone_state(s0), K.shard_tree(K.clone_state(s0), n)
    r_k, r_p = make_empty_inbox(cfg, dev), make_empty_inbox(cfg, dev)
    r_sh = K.shard_tree(make_empty_inbox(cfg, dev), n)
    empty = make_empty_inbox(cfg, dev)
    elect, _ = kb.host_window(0, torch.zeros((G,), dtype=torch.int32), np.zeros(SS_GROUPS, np.int64),
                              SS_GROUPS, SS_REPLICAS, cfg, np.random.default_rng(0), dev)
    bad, carried = set(), []
    for ib in (elect, empty, empty):
        res_k = multi(s_k, ib, ticks, r_k, route, rdelta)
        res_sh = smulti(s_sh, K.shard_tree(ib, n), K.shard_tree(ticks, n), r_sh,
                        K.shard_tree(route, n), K.shard_tree(rdelta, n))
        res_p = K.multi_step_batch_reference(s_p, ib, ticks, r_p, route, rdelta, cfg, steps)
        joined = (K.unshard_tree(res_sh[0]), K.unshard_tree(res_sh[1], axis=1),
                  K.unshard_tree(res_sh[2], axis=1), K.unshard_tree(res_sh[3]),
                  K.unshard_tree(res_sh[4]))
        bad |= set(superstep_mismatches(res_k, res_p))
        bad |= set("sharded." + f for f in superstep_mismatches(joined, res_p))
        s_k, r_k, s_sh, r_sh, s_p, r_p = res_k[0], res_k[3], res_sh[0], res_sh[3], res_p[0], res_p[3]
        carried.append(int(res_k[4].sum()))
    assert carried[0] > 0, "the K=2 election carried no residual"
    assert bool((s_k.role[:SS_GROUPS] == ROLE.LEADER).all()), "the residual did not finish the election"
    log(f"residual: K={steps}, residual rows after each super-step {carried}, "
        f"mismatched fields {sorted(bad) or 0}")
    if bad:
        raise AssertionError(f"residual super-steps disagree on {sorted(bad)}")


class SuperstepRunner:
    """A fresh copy of the config-6 cluster on one kernel path (unsharded,
    or SS_SHARDS logical shards), stepped one recorded window at a time
    with the engine's compaction after each."""

    def __init__(self, K, kb, cfg, s0, route, rdelta, sharded):
        from dragonboat_tpu_torch.ops.state import make_empty_inbox

        G, n, steps = cfg.groups, SS_SHARDS, SS_STEPS
        dev = torch.device("cuda", 0)
        self.K, self.kb, self.sharded = K, kb, sharded
        ticks = torch.ones((G,), dtype=torch.int32, device=dev)
        if sharded:
            self.fn = K.make_sharded_multi_step_fn(cfg, steps, (dev,) * n)
            self.st = K.shard_tree(K.clone_state(s0), n)
            self.resid = K.shard_tree(make_empty_inbox(cfg, dev), n)
            self.args = (K.shard_tree(ticks, n), K.shard_tree(route, n), K.shard_tree(rdelta, n))
        else:
            self.fn = K.make_multi_step_fn(cfg, steps)
            self.st, self.resid = K.clone_state(s0), make_empty_inbox(cfg, dev)
            self.args = (ticks, route, rdelta)

    def step(self, ib):
        """One super-step on the host inbox `ib`; returns the stacked
        outputs (joined over the shards)."""
        K, (ticks, route, rdelta) = self.K, self.args
        if self.sharded:
            ib = K.shard_tree(ib, SS_SHARDS)
        self.st, outs, _, self.resid, _ = self.fn(self.st, ib, ticks, self.resid, route, rdelta)
        return outs

    def compact(self):
        for x in (self.st if self.sharded else (self.st,)):
            self.kb.compact(x)

    def joined(self, outs):
        return self.K.unshard_tree(outs, axis=1) if self.sharded else outs


def time_superstep(K, cuda, kb, cfg, s0, route, rdelta, hosts, sharded):
    """Replay the recorded windows on one kernel path, timing every
    super-step: host clock around the call and a synchronize, CUDA events
    around the call; count launches and the commit advances of the leader
    lanes on the device. Then profile three more replayed windows for the
    device's busy share and its kernel time by name."""
    from dragonboat_tpu_torch.ops.state import CTR

    dev = torch.device("cuda", 0)
    run = SuperstepRunner(K, kb, cfg, s0, route, rdelta, sharded)
    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    wall, dev_ms, committed = [], [], torch.zeros((), dtype=torch.int64, device=dev)
    for ib, leaders in hosts:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        outs = run.step(ib)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(a.elapsed_time(b))
        lanes = torch.from_numpy(leaders).to(dev)
        ctr = cmp_view(run.joined(outs).counters)
        committed += ctr[:, lanes, CTR.COMMIT_ADVANCES].to(torch.int64).sum()
        run.compact()
    launches = {k: v / len(hosts) for k, v in cuda.LAUNCHES.items()}
    timed = slice(1, None)  # window 0 (the election) warms up
    med = lambda xs: sorted(xs)[len(xs) // 2]
    res = {
        "wall_ms": med(wall[timed]), "device_ms": med(dev_ms[timed]),
        "inner_steps_per_s": SS_STEPS / (med(wall[timed]) / 1e3),
        "entries_committed_per_s": int(committed) / (sum(dev_ms) / 1e3),
        "launches_per_superstep": launches,
    }
    res.update(profile_superstep(K, kb, cfg, s0, route, rdelta, hosts, sharded))
    return res


def profile_superstep(K, kb, cfg, s0, route, rdelta, hosts, sharded):
    """torch.profiler over windows 1-3 of a fresh replay: the device's busy
    share (kernel time over the windows' wall time) and the kernel time per
    window by name. Reports None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    run = SuperstepRunner(K, kb, cfg, s0, route, rdelta, sharded)
    run.step(hosts[0][0])
    run.compact()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for ib, _ in hosts[1:4]:
            run.step(ib)
            run.compact()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    # rows of device work only: a CPU op's row also carries the device time
    # of the kernels it launched, which have rows of their own
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) or 0
    per = {e.key: dev_time(e) / 1e3 / 3 for e in prof.key_averages()
           if dev_time(e) > 0 and getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU}
    launches = {e.key: e.count / 3 for e in prof.key_averages() if e.key in per}
    busy = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:6])
    return {
        "profiled_wall_ms_per_superstep": wall / 3,
        "device_busy_ms_per_superstep": busy if busy else None,
        "device_idle_share": 1 - busy / (wall / 3) if busy else None,
        "device_ms_by_kernel": {k[:60]: v for k, v in top.items()},
        "device_launches_by_kernel": {k[:60]: launches[k] for k in top},
    }


def phase_new_kernels(K, cuda, kb, cfg, kept):
    """Each router and gather kernel against its plain version on its own
    inputs, then its time beside its bound, its plain version's and the
    library call's (router: 8 seeded random draws at config 6's shape and
    one where every routed candidate goes to one of 16 lanes, far past K,
    each unsharded and as 4 shards, the inbox and plan and, word for word,
    the columns kernel's candidate records; gather: odd and even record
    lengths and the old slab shape, n in {1, 2, 4})."""
    from dragonboat_tpu_torch.ops.convert import state_from_numpy
    from dragonboat_tpu_torch.ops.state import MSG

    dev = torch.device("cuda", 0)
    G, P, n = cfg.groups, cfg.peers, SS_SHARDS
    K_, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    rng = np.random.default_rng(SS_SEED + 1)
    route_bad, record_bad, route_cases, most, words = set(), set(), 0, 0, 0
    for i in range(9):
        st, out, route, rdelta = kb.random_route_case(rng, cfg)
        if i == 8:
            # K overflow: every routed candidate of every lane to 16 lanes
            route = np.where(route >= 0, route % 16, -1).astype(np.int32)
        s = state_from_numpy(st, dev)
        o = state_from_numpy(out, dev)
        route, rdelta = torch.from_numpy(route).to(dev), torch.from_numpy(rdelta).to(dev)
        ref = K.route_step_output_reference(s, o, route, rdelta, cfg)
        for value, flag in SENTINELS:
            nxt, plan = cuda._alloc_inbox(G, K_, E, dev), cuda._alloc_plan(G, P, K_, R, dev)
            fill(nxt, value, flag)
            fill(plan, value, flag)
            got = cuda.route_step_output_cuda(s, o, route, rdelta, cfg, nxt=nxt, plan=plan)
            torch.cuda.synchronize()
            route_bad |= set(mismatches(got[0], ref[0], "inbox.") + mismatches(got[1], ref[1], "plan."))
        sh = K._shard_route(K.shard_tree(s, n), K.shard_tree(o, n), K.shard_tree(route, n),
                            K.shard_tree(rdelta, n), cfg)
        route_bad |= set(mismatches(K.unshard_tree(sh[0]), ref[0], "sharded.inbox.")
                         + mismatches(K.unshard_tree(sh[1]), ref[1], "sharded.plan."))
        route_cases += 2
        # the columns kernel's records (into sentinel-filled buffers),
        # unsharded and per shard, against the plain columns packed
        for nb, blocks in ((1, [(s, o, route, rdelta)]),
                           (n, list(zip(*(K.shard_tree(x, n) for x in (s, o, route, rdelta)))))):
            for j, args in enumerate(blocks):
                cols = K._route_columns(*args, cfg)
                want = K._pack_record(*cols, cfg)
                rec = torch.full_like(want, SENTINELS[0][0])
                cuda.route_columns_cuda(*args, cfg, record=rec)
                torch.cuda.synchronize()
                words += want.numel()
                off = int((rec != want).sum())
                if off:
                    record_bad.add(f"case {i} of {nb} block(s), block {j}: {off} words")
                if nb == 1:
                    dest = cols[0]
                    if not torch.equal(K._widen_record(rec, G, cfg), K._pack_slab(*cols)):
                        record_bad.add(f"case {i}: the record does not widen to the slab")
        most = max(most, int(torch.bincount(dest[dest >= 0]).max()))
    assert most > K_, f"no router case sent more than K={K_} candidates to a lane"
    log(f"router: {route_cases} cases (most candidates to one lane {most}, K={K_}), "
        f"mismatched fields {sorted(route_bad) or 0}; records: {words} words against "
        f"_pack_record, mismatched {sorted(record_bad) or 0}")

    gather_bad, gather_cases = set(), 0
    Gl, C = G // n, 11 + 2 * E
    Ls = K.record_words(Gl, cfg)
    # the record at config 6's shard, an odd length, and the old slab shape
    shapes = ((Ls,), (Ls - 1,), (C, Gl * cuda.candidates_per_lane(cfg)))
    for shape in shapes:
        for k in (1, 2, 4):
            xs = [torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=dev)
                  for _ in range(k)]
            got = cuda.ring_gather_cuda(xs)
            ref = K.ring_gather_reference(xs)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                if not torch.equal(a, b):
                    gather_bad.add(f"shape={shape} n={k}")
            gather_cases += 1
    log(f"ring_gather: {gather_cases} cases (shapes {[list(x) for x in shapes]}; n in 1, 2, 4), "
        f"mismatched {sorted(gather_bad) or 0}")

    # ---- timings at the main path's shapes (window 3's state and inbox) ----
    st, ib = kept
    ticks = torch.ones((G,), dtype=torch.int32, device=dev)
    work = K.clone_state(st)
    sp, out = cuda.prepare_step(work, ib, ticks, cfg)
    launcher = cuda._Launcher(dev)

    def restore():
        for a, b in zip(work, st):
            a.copy_(b)

    step_ms = kb.device_ms(lambda: launcher("step_batch_launch", sp, "step_batch"), restore, 50,
                           ["step_batch_kernel"])["step_batch_kernel"]
    step_plain = time_ms(lambda: K.step_batch_reference(st, ib, ticks, cfg), 3)
    after, o = cuda.step_batch_cuda(K.clone_state(st), ib, ticks, cfg)
    step_bound = kb.step_bytes(st, ib, ticks, o, after) / kb.HBM_BYTES_PER_S * 1e3

    # the router on the step's output (unsharded: the scatter reads a
    # gather of one shard): columns, insert pass, write pass
    M, L = G * cuda.candidates_per_lane(cfg), K.record_words(G, cfg)
    rec = torch.empty((L,), dtype=torch.int32, device=dev)
    nxt, plan = cuda._alloc_inbox(G, K_, E, dev), cuda._alloc_plan(G, P, K_, R, dev)
    _, route, rdelta = kb.superstep_cluster(SS_GROUPS, SS_REPLICAS, cfg, dev)
    cp = cuda._columns_params(after, o, route, rdelta, rec, plan, cfg)
    xp = cuda._scatter_params(rec, cuda.alloc_slots(G, K_, dev), 1, 0, G, P, nxt, plan, cfg)
    names = ["route_columns_kernel", "route_index_kernel", "route_scatter_kernel"]

    def router_call():
        launcher("route_columns_launch", cp, "route_columns")
        launcher.scatter(xp)

    cols_ms, index_ms, scat_ms = kb.device_ms(router_call, lambda: None, 50, names).values()
    call_ms = cols_ms + index_ms + scat_ms
    accepted = int(sum(int(p.sum()) for p in plan))
    route_plain = time_ms(lambda: K.route_step_output_reference(after, o, route, rdelta, cfg), 3)
    hbm = lambda nbytes: nbytes / kb.HBM_BYTES_PER_S * 1e3
    cols_bound = hbm(kb.route_columns_bytes(o, route, cfg))
    index_bound = hbm(kb.route_index_bytes(1, M))
    scat_bound = hbm(kb.route_scatter_bytes(1, M, accepted, nxt, cfg)) - index_bound

    # the same router as 4 shards: columns per shard, the gather, then each
    # shard's insert and write passes over the gathered stack
    Ml = M // n
    parts = [K.shard_tree(x, n) for x in (after, o, route, rdelta)]
    srecs = [torch.empty((Ls,), dtype=torch.int32, device=dev) for _ in range(n)]
    sgath = [torch.empty((n, Ls), dtype=torch.int32, device=dev) for _ in range(n)]
    snxt = [cuda._alloc_inbox(Gl, K_, E, dev) for _ in range(n)]
    splan = [cuda._alloc_plan(Gl, P, K_, R, dev) for _ in range(n)]
    scp = [cuda._columns_params(*(x[i] for x in parts), srecs[i], splan[i], cfg)
           for i in range(n)]
    shard_cols_ms = kb.device_ms(
        lambda: [launcher("route_columns_launch", p, "route_columns") for p in scp],
        lambda: None, 50, names[:1])["route_columns_kernel"]
    shard_cols_bound = sum(hbm(kb.route_columns_bytes(parts[1][i], parts[2][i], cfg))
                           for i in range(n)) / n
    for d in range(n):
        launcher("ring_gather_launch", cuda._gather_params(srecs, sgath[d]), "ring_gather")
    sxp = [cuda._scatter_params(sgath[i], cuda.alloc_slots(G, K_, dev), n, i, Gl, P, snxt[i],
                                splan[i], cfg) for i in range(n)]
    per_shard = kb.device_ms(lambda: [launcher.scatter(x) for x in sxp], lambda: None, 50,
                             names[1:])
    shard_index_ms, shard_scat_ms = per_shard["route_index_kernel"], per_shard["route_scatter_kernel"]
    mine = [int((x.mtype != MSG.NONE).sum()) for x in snxt]
    bits = [int(sum(int(p.sum()) for p in pl)) for pl in splan]
    shard_bound = sum(hbm(kb.route_scatter_bytes(n, Ml, a, x, cfg, plan_bits=b))
                      for a, x, b in zip(mine, snxt, bits)) / n

    # the gather at config 6 over 4 shards: one record per shard; and, to
    # read beside earlier runs, one (C, Ml) slab per shard. Per destination:
    # one launch's device duration (the mean over the n destinations'
    # launches), the plain version for one destination (gather_for) and the
    # library call that computes the same stack (torch.stack); all n
    # destinations: the device time of the n launches of one call (their
    # durations summed: one stream runs them one after another) and the
    # plain version's. The loop rereads the same records into the same
    # stacks, so where both fit the card's L2 (`l2_resident`) the kernel
    # reads them from there and can beat its HBM bound; phase 10 times the
    # gather at 50,000 lanes, where they do not fit
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0)

    def time_gather(shape):
        xs = [torch.randint(-9, 9, shape, dtype=torch.int32, device=dev) for _ in range(n)]
        outs = [torch.empty((n,) + shape, dtype=torch.int32, device=dev) for _ in range(n)]
        gps = [cuda._gather_params(xs, o) for o in outs]
        call = lambda: [launcher("ring_gather_launch", gp, "ring_gather") for gp in gps]
        ms = kb.device_ms(call, lambda: None, 50, ["ring_gather_kernel"])["ring_gather_kernel"]
        touched = 4 * (n + n * n) * xs[0].numel()
        return dict(ms=ms, plain_ms=time_ms(lambda: K.gather_for(xs, 0), 20),
                    library_ms=time_ms(lambda: torch.stack(xs), 20),
                    bound_ms=hbm(kb.ring_gather_dest_bytes(n, xs[0].numel())),
                    l2_resident=bool(l2) and touched <= l2, bytes_touched=touched,
                    l2_bytes=l2,
                    all_destinations_ms=kb.device_ms(call, lambda: None, 50)["total"],
                    all_destinations_plain_ms=time_ms(lambda: K.ring_gather_reference(xs), 20),
                    all_destinations_bound_ms=hbm(kb.ring_gather_bytes(n, xs[0].numel())))

    gather = time_gather((Ls,))
    gather_slab = time_gather((C, Ml))
    log(f"step_batch @ {G} lanes (config 6 window 3): kernel {step_ms:.4f} ms, "
        f"plain {step_plain:.2f} ms, bound {step_bound:.5f} ms")
    log(f"route_columns @ {M} candidates (record {L} words): kernel {cols_ms:.4f} ms, bound "
        f"{cols_bound:.5f} ms; per shard of {n} ({Ls} words) {shard_cols_ms:.4f} ms, bound "
        f"{shard_cols_bound:.5f} ms; route_index (insert pass) {index_ms:.4f} ms, bound "
        f"{index_bound:.5f} ms; route_scatter (write pass, {accepted} accepted) "
        f"{scat_ms:.4f} ms, bound {scat_bound:.5f} ms; scatter per router call (both passes) "
        f"{index_ms + scat_ms:.4f} ms, bound {index_bound + scat_bound:.5f} ms; router call "
        f"(3 kernels) {call_ms:.4f} ms; plain router {route_plain:.2f} ms, library none "
        f"(kernel times: device durations, torch.profiler)")
    log(f"route scatter per shard ({n} shards, {Ml} candidates each, {sum(mine)} accepted): "
        f"insert pass {shard_index_ms:.4f} ms, write pass {shard_scat_ms:.4f} ms, both "
        f"{shard_index_ms + shard_scat_ms:.4f} ms, bound {shard_bound:.5f} ms")
    for what, g in ((f"{Ls}-word records", gather), (f"({C}, {Ml}) slabs", gather_slab)):
        log(f"ring_gather n={n} x {what}, per destination: kernel {g['ms']:.4f} ms, plain "
            f"(gather_for) {g['plain_ms']:.4f} ms, library torch.stack {g['library_ms']:.4f} ms, "
            f"bound {g['bound_ms']:.5f} ms; all {n} destinations: kernel "
            f"{g['all_destinations_ms']:.4f} ms, plain {g['all_destinations_plain_ms']:.4f} ms, "
            f"bound {g['all_destinations_bound_ms']:.5f} ms; records and stacks "
            f"{g['bytes_touched']} B, L2 {g['l2_bytes']} B, L2-resident {g['l2_resident']}")
    if route_bad or record_bad or gather_bad:
        raise AssertionError(f"router {sorted(route_bad)}, records {sorted(record_bad)}, "
                             f"gather {sorted(gather_bad)}")
    return {
        "step_batch": dict(ms=step_ms, plain_ms=step_plain, bound_ms=step_bound),
        "route_columns": dict(ms=cols_ms, plain_ms=route_plain, bound_ms=cols_bound,
                              library_ms=None, cases=route_cases, bad=route_bad | record_bad,
                              record_words=L, records_checked_words=words,
                              per_shard_ms=shard_cols_ms,
                              per_shard_bound_ms=shard_cols_bound),
        "route_index": dict(ms=index_ms, plain_ms=route_plain, bound_ms=index_bound,
                            library_ms=None, cases=route_cases, bad=route_bad,
                            per_shard_ms=shard_index_ms),
        "route_scatter": dict(ms=scat_ms, plain_ms=route_plain, bound_ms=scat_bound,
                              library_ms=None, cases=route_cases, bad=route_bad,
                              per_shard_ms=shard_scat_ms,
                              scatter_per_call_ms=index_ms + scat_ms,
                              scatter_per_call_bound_ms=index_bound + scat_bound,
                              scatter_per_shard_ms=shard_index_ms + shard_scat_ms,
                              scatter_per_shard_bound_ms=shard_bound,
                              router_call_ms=call_ms),
        "ring_gather": dict(**gather, cases=gather_cases, bad=gather_bad, record_words=Ls,
                            per="destination", slab_shape=[C, Ml],
                            slab_shape_ms=gather_slab["ms"],
                            slab_shape_bound_ms=gather_slab["bound_ms"],
                            slab_shape_library_ms=gather_slab["library_ms"]),
    }


# ------------------------------------------- phase 5: the engine on the card

# BASELINE configs through NodeHost (bench.py:1124-1182): 2 and 6 at full
# width; then 1 (one group) and 8 (1024 groups) at full width, and 3, 4 and
# 5 at 512 groups x 5 replicas (2560 lanes, nominally 10,000 and 50,000
# groups: stamped scaled_down; 1024 until the script's time on a slow card
# host neared its limit); last 7 (64 groups x 3, through the serving
# fronts) at full width. Windows are cut from bench.py's 10 s (configs 2
# and 6) and 8 s (7) to keep the script within its time. The load
# runs through a 2 s warm-up (and until every group has a wave in flight), so each
# window opens on waves in flight. The new configs take 4 s windows; a
# wave through 5120 lanes lands 6-16 s after it is sent (about one engine
# step a second, slower on a slow host), and a window runs on until every
# group committed a wave inside it (e2e.bench_e2e)
E2E_CONFIGS = (2, 6, 1, 3, 4, 5, 8, 7)
E2E_GROUPS = {3: 512, 4: 512, 5: 512}
E2E_WINDOW_S = {1: 4.0, 2: 5.0, 3: 4.0, 4: 4.0, 5: 4.0, 6: 5.0, 7: 4.0, 8: 4.0}
# the kernels each config's engine path must launch
E2E_KERNELS = {1: ("step_batch", "activate"),
               8: ("step_batch", "route_columns", "route_index", "route_scatter", "activate")}


# what the kernels line carries of each engine run
E2E_KEYS = ("value", "committed", "seconds", "commit_latency_p50_s", "commit_latency_p99_s",
            "engine_steps_per_s", "engine_steps_total", "host_stage_window_s",
            "groups_committed_in_window", "elections_in_window", "client_dropped",
            "thread_cpu_share",
            "out_of_seam_syncs", "kernel_builds", "engine_steps", "pipelined_steps",
            "busy", "bring_up_s", "wall_s", "converged", "lincheck_ok", "card", "power_limit")
# and of the read, drop and churn configs
E2E_TRAFFIC_KEYS = ("groups", "replicas", "nominal_groups", "scaled_down", "read_mode",
                    "reads_completed", "reads_submitted", "reads_per_sec",
                    "read_latency_p50_s", "read_latency_p99_s", "lease_reads_local",
                    "lease_reads_fallback", "lease_vs_readindex_reads", "readindex_mode",
                    "drop_rate", "drops_applied", "snapshots_requested",
                    "membership_changes", "out_of_seam_sites",
                    "workload", "tenants", "placement_enabled", "session_registered_total",
                    "session_proposals_total", "session_safe_retries_total",
                    "session_errors_total", "serving_admitted_total", "serving_shed_total",
                    "serving_wakes_total", "serving_urgent_p99_s", "serving_bulk_p50_s",
                    "serving_bulk_p99_s", "serving_tenant_latency", "migrations_started")


# lane activation on the card (csrc/activate.cu): config 2's engine shape
# (3,072 lanes, P=4, W=256) at buckets 1, 16 and 4,096 (a bucket past the
# lanes repeats the last lane, as the engine pads), and 50,000 lanes at P=5
# at bucket 4,096; (lanes, P, W, buckets)
ACT_CASES = ((3072, 4, 256, (1, 16, 4096)), (50_000, 5, 256, (4096,)))
ACT_HOST_LANES = 1024  # the host-side batch timed against the plain path
ACT_SEED = 20261017


def _act_cfg(lanes, P, W):
    from dragonboat_tpu_torch.ops.state import KernelConfig

    return KernelConfig(groups=lanes, peers=P, log_window=W, inbox_depth=4,
                        max_entries_per_msg=64, readindex_depth=4)


def _act_state(cfg, rng, device="cuda"):
    """A state of cfg's shapes with every plane seeded (int32 planes in
    [-5, 300), bools at one half), on `device`."""
    from dragonboat_tpu_torch.ops.state import init_state

    s = init_state(cfg, device="cpu")
    for t in s:
        if t.dtype == torch.bool:
            t.copy_(torch.from_numpy(rng.random(tuple(t.shape)) < 0.5))
        elif t.dtype == torch.int32:
            t.copy_(torch.from_numpy(rng.integers(-5, 300, tuple(t.shape)).astype(np.int32)))
    return type(s)(*(t.to(device) for t in s))


def _act_batch(rng, lanes, n, P, W):
    """n distinct lane rows of `lanes` and their bring-up values, one dict
    per lane as the engine's _compute_activation gives them."""
    from dragonboat_tpu_torch.ops import cuda

    rows = rng.choice(lanes, n, replace=False).tolist()
    keys, cols = [], []
    for k, dt in cuda.ACT_COLUMNS:
        keys.append(k)
        cols.append((rng.random(n) < 0.5 if dt == torch.bool
                     else rng.integers(0, 500, n)).tolist())
    for k, dt in cuda.ACT_ROWS:
        w = W if k.startswith("log_") else P
        keys.append(k)
        cols.append(list(rng.random((n, w)) < 0.5 if dt == torch.bool
                         else rng.integers(0, 500, (n, w)).astype(np.int32)))
    return rows, [dict(zip(keys, lane)) for lane in zip(*cols)]


def _act_plain_inputs(rows, vals, bucket, device="cuda"):
    """The batch as the plain version takes it: the padded lane rows and
    one tensor per value on the card, built column by column from the
    lanes' values (not through the packed layout)."""
    from dragonboat_tpu_torch.ops import cuda

    pad = bucket - len(vals)
    gi = torch.tensor(rows + [rows[-1]] * pad, dtype=torch.int64, device=device)
    v = {}
    for k, dt in cuda.ACT_COLUMNS + cuda.ACT_ROWS:
        a = np.stack([np.asarray(x[k]) for x in vals]).astype(
            bool if dt == torch.bool else np.int32)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
        v[k] = torch.from_numpy(a).to(device)
    return gi, v


def act_mismatches(a, b):
    """The planes where two states differ, and the largest absolute
    difference over them."""
    bad = [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]
    err = max([int((as_i64(getattr(a, f)) - as_i64(getattr(b, f))).abs().max()) for f in bad]
              + [0])
    return bad, err


def act_bytes(s, rows, bucket):
    """The least bytes one batch of `rows` padded to `bucket` moves: the
    lane rows read once, the packed values of each distinct lane read once
    (csrc/activate.cu skips a padding row before it reads its values) and
    every plane activation writes written once for each distinct lane."""
    from dragonboat_tpu_torch.ops import cuda

    lanes = len(set(rows))
    spans, _ = cuda.packed_spans(cuda.activation_layout(
        bucket, s.member.shape[1], s.log_term.shape[1]))
    read = sum(nb if name == "rows" else nb // bucket * lanes for name, _sh, _dt, _o, nb in spans)
    names = cuda.ACT_SET + cuda.ACT_ZERO + ("active", "next", "rstate")
    row = sum(getattr(s, f)[0].numel() * getattr(s, f).element_size() for f in names)
    return read + lanes * row


def _old_activate_rows(vector, fake, sh, rows, vals):
    """The engine's activation batch before csrc/activate.cu, the plain
    path's host side: every value column through its own pinned staging
    and async copy (engine._h2d), then one index_put_ per plane."""
    bucket = vector.activation_bucket(len(vals), sh.hi - sh.lo)
    pad = bucket - len(vals)
    gi = np.asarray(rows + [rows[-1]] * pad, np.int64)
    h2d = lambda a: vector.VectorEngine._h2d(fake, a, sh)
    v = {}
    for key, dtype in vector.VectorEngine._ACT_COLS:
        a = np.asarray([x[key] for x in vals], dtype)
        v[key] = h2d(np.concatenate([a, np.repeat(a[-1:], pad, 0)]) if pad else a)
    for key, dtype in vector.VectorEngine._ACT_MATS:
        a = np.stack([x[key] for x in vals]).astype(dtype)
        v[key] = h2d(np.concatenate([a, np.repeat(a[-1:], pad, 0)]) if pad else a)
    vector.activate_lanes_reference(sh.state, h2d(gi), v)


def phase_activation(cuda, kb, card, device="cuda"):
    """Lane activation on the card: csrc/activate.cu against
    activate_lanes_reference on seeded states (ACT_CASES), bit for bit on
    every plane, through the engine's packing and one copy of the packed
    buffer (activate_packed) and through activate_lanes (values as
    separate tensors, packed on the card); the kernel's and the plain
    version's device time per batch (profiler) at config 2's shape with
    its byte bound; then the host ms of one engine batch of
    ACT_HOST_LANES lanes (VectorEngine._activate_rows: pack, copy and
    launch) against the plain path's per-column copies and index_put_
    launches, in turns in this call. On the CPU (a rehearsal) the plain
    versions run in place of the kernel and nothing is timed."""
    import types as _types

    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.ops.kernel import clone_state

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    rng = np.random.default_rng(ACT_SEED)
    cases, bad, err, timed = [], set(), 0, {}
    for lanes, P, W, buckets in ACT_CASES:
        cfg = _act_cfg(lanes, P, W)
        s0 = _act_state(cfg, rng, device)
        for bucket in buckets:
            n = min(bucket, lanes)
            rows, vals = _act_batch(rng, lanes, n, P, W)
            packed = vector.pack_activation(rows, vals, bucket, P, W).to(device)
            gi, v = _act_plain_inputs(rows, vals, bucket, device)
            want = vector.activate_lanes_reference(clone_state(s0), gi, v)
            got = vector.activate_packed(clone_state(s0), packed, bucket)
            via_dict = vector.activate_lanes(clone_state(s0), gi, v)
            sync()
            for what, x in (("packed", got), ("lanes", via_dict)):
                b, e = act_mismatches(want, x)
                bad |= {f"{lanes}x{bucket}.{what}.{f}" for f in b}
                err = max(err, e)
            cases.append({"lanes": lanes, "P": P, "W": W, "bucket": bucket, "rows": n,
                          "mismatched_planes": sorted(
                              f for f in bad if f.startswith(f"{lanes}x{bucket}."))})
            if on_card and (lanes, bucket) in ((3072, 4096), (50_000, 4096)):
                work = clone_state(s0)
                ms = kb.device_ms(lambda: cuda.activate_cuda(work, packed, bucket), lambda: None,
                                  20, ["activate_kernel"])["activate_kernel"]
                # with a cold L2, as a bring-up finds the state planes:
                # a buffer of 4x the card's L2 written before each launch
                l2 = torch.cuda.get_device_properties(0).L2_cache_size
                flush = torch.empty((4 * l2,), dtype=torch.uint8, device=device)
                cold_ms = kb.device_ms(lambda: cuda.activate_cuda(work, packed, bucket),
                                       flush.zero_, 20, ["activate_kernel"])["activate_kernel"]
                del flush
                # the same values at consecutive lane rows, as a bring-up's
                start = int(np.random.default_rng(ACT_SEED + lanes).integers(0, lanes - n + 1))
                seq = vector.pack_activation(list(range(start, start + n)), vals, bucket, P,
                                             W).to(device)
                seq_ms = kb.device_ms(lambda: cuda.activate_cuda(work, seq, bucket),
                                      lambda: None, 20, ["activate_kernel"])["activate_kernel"]
                plain_ms = kb.device_ms(lambda: vector.activate_lanes_reference(work, gi, v),
                                        lambda: None, 20)["total"]
                nbytes = act_bytes(s0, rows, bucket)
                timed[f"{lanes}x{bucket}"] = {
                    "ms": ms, "cold_ms": cold_ms, "consecutive_rows_ms": seq_ms,
                    "plain_ms": plain_ms, "bytes": nbytes,
                    "bound_ms": nbytes / kb.HBM_BYTES_PER_S * 1e3}
    # the engine's host side: one batch of ACT_HOST_LANES lanes, pack +
    # copy + launch against the plain path's per-column staging, in turns
    lanes, P, W, _ = ACT_CASES[0]
    fake = _types.SimpleNamespace(kcfg=_act_cfg(lanes, P, W), _cuda=on_card)
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    sh = vector._Shard(dev, 0, lanes, None, True)
    sh.state = _act_state(fake.kcfg, rng, device)
    rows, vals = _act_batch(rng, lanes, min(ACT_HOST_LANES, lanes), P, W)
    host = {"new": [], "plain": []}
    for turn in ("new", "plain", "plain", "new") * 5:
        sync()
        t = time.perf_counter()
        if turn == "new":
            vector.VectorEngine._activate_rows(fake, sh, rows, vals)
        else:
            _old_activate_rows(vector, fake, sh, rows, vals)
        host[turn].append((time.perf_counter() - t) * 1e3)
    sync()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    r = {"cases": len(cases), "checks": 2 * len(cases), "mismatched_fields": sorted(bad),
         "max_abs_err": err, "timed": timed, "host_lanes": ACT_HOST_LANES,
         "host_ms": med(host["new"]), "plain_host_ms": med(host["plain"]),
         "seconds": round(time.perf_counter() - t0, 2), "card": card}
    log("activation: " + json.dumps({**r, "by_case": cases}))
    for key, x in timed.items():
        log(f"activate @ {key} (lanes x bucket): kernel {x['ms']:.4f} ms (L2 cold "
            f"{x['cold_ms']:.4f} ms; consecutive rows {x['consecutive_rows_ms']:.4f} ms), plain "
            f"{x['plain_ms']:.4f} ms of device time, bound {x['bound_ms']:.5f} ms "
            f"({x['bytes']} B) [{card}]")
    log(f"activate host side @ {ACT_HOST_LANES} lanes: pack + copy + launch {r['host_ms']:.3f} "
        f"ms, plain per-column copies + index_put_ {r['plain_host_ms']:.3f} ms (medians of "
        f"{len(host['new'])}) [{card}]")
    if bad:
        raise AssertionError(f"activation kernel disagrees with the plain version on {sorted(bad)}")
    return r


# the window rebase (csrc/rebase.cu) against its plain versions: (lanes, P,
# W, residual inbox depth or 0): phase 1's 1,024 lanes, config 2's 3,072,
# the kernel regime's 50,000 (P=8, W=512) and config 6's 3,072 lanes with
# its residual inbox (K=8 super-steps, inbox depth 4)
REBASE_CASES = ((1024, 4, 256, 0), (3072, 4, 256, 0), (50_000, 8, 512, 0), (3072, 4, 256, 4))
REBASE_SEED = 20261018


def _rebase_inputs(lanes, P, W, depth, rng, device):
    """A seeded state (and residual inbox of every message type) of the
    case's shapes on `device`, and a delta of 0, W or 2W a lane."""
    from dragonboat_tpu_torch.ops.state import KernelConfig, make_empty_inbox

    cfg = KernelConfig(groups=lanes, peers=P, log_window=W, inbox_depth=max(depth, 1),
                       max_entries_per_msg=64, readindex_depth=4)
    s = _act_state(cfg, rng, device)
    resid = None
    if depth:
        ib = make_empty_inbox(cfg, device="cpu")
        for t in ib:
            if t.dtype == torch.int32:
                t.copy_(torch.from_numpy(rng.integers(-5, 3 * W, tuple(t.shape)).astype(np.int32)))
        ib.mtype.copy_(torch.from_numpy(rng.integers(-1, 28, tuple(ib.mtype.shape)).astype(np.int32)))
        resid = type(ib)(*(t.to(device) for t in ib))
    delta = torch.from_numpy((rng.integers(0, 3, lanes) * W).astype(np.int32)).to(device)
    return s, resid, delta


def phase_rebase(cuda, kb, card, device="cuda"):
    """The window rebase on the card: csrc/rebase.cu (through the engine's
    call, engine.vector.rebase_lanes) against ops.state.rebase and
    engine.vector.rebase_resid on seeded states of REBASE_CASES, every
    plane bit for bit; then the kernel's and the plain versions' device
    time per call (profiler) beside the byte bound. On the CPU (a
    rehearsal) the plain versions run in place of the kernel and nothing
    is timed."""
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.ops.kernel import clone_state
    from dragonboat_tpu_torch.ops.state import rebase

    on_card = device == "cuda"
    rng = np.random.default_rng(REBASE_SEED)
    bad, err, timed = [], 0, {}
    for lanes, P, W, depth in REBASE_CASES:
        key = f"{lanes}" + (f"_resid_k{depth}" if depth else "")
        s, resid, delta = _rebase_inputs(lanes, P, W, depth, rng, device)
        want = rebase(clone_state(s), delta)
        want_r = clone_state(resid) if depth else None
        if depth:
            vector.rebase_resid(want_r, delta)
        got_r = clone_state(resid) if depth else None
        got = vector.rebase_lanes(clone_state(s), delta, got_r)
        b, e = act_mismatches(want, got)
        err = max(err, e)
        if depth:
            br, er = act_mismatches(want_r, got_r)
            b, err = b + ["resid." + f for f in br], max(err, er)
        bad += [f"{key}.{f}" for f in b]
        if not on_card:
            continue
        work, work_r = clone_state(s), clone_state(resid) if depth else None
        ms = kb.device_ms(lambda: cuda.rebase_cuda(work, delta, work_r), lambda: None, 20,
                          ["rebase_kernel"])["rebase_kernel"]

        def plain():
            rebase(work, delta)
            if depth:
                vector.rebase_resid(work_r, delta)

        plain_ms = kb.device_ms(plain, lambda: None, 20)["total"]
        nbytes = kb.rebase_bytes(s) + (kb.rebase_resid_bytes(resid) if depth else 0)
        timed[key] = {"lanes": lanes, "P": P, "W": W, "resid_depth": depth, "ms": ms,
                      "plain_ms": plain_ms, "bytes": nbytes,
                      "bound_ms": nbytes / kb.HBM_BYTES_PER_S * 1e3}
        log(f"rebase @ {key} lanes (P={P} W={W}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"of device time, bound {timed[key]['bound_ms']:.5f} ms ({nbytes} B) [{card}]")
    r = {"cases": len(REBASE_CASES), "mismatched_fields": bad, "max_abs_err": err,
         "timed": timed}
    log("rebase: " + json.dumps(r))
    if bad:
        raise AssertionError(f"rebase kernel disagrees with the plain versions on {bad}")
    return r


def phase_engine(cuda, K, config, groups=None, device="cuda", duration=None):
    """BASELINE config `config` through NodeHost on `device`
    (dragonboat_tpu_torch.e2e.run_ladder_config: the config's NodeHosts
    sharing one engine core, WAL and fsync in a temp dir): elect, run the
    load through a 2 s warm-up, measure pipelined proposal waves with the
    config's reads, drops or churn, a 1 s profiler window, settle, a
    3-client propose/read history, and the replicas. Fails on any of e2e.gate_failures
    (elections, commits, convergence, lincheck, kernel builds, syncs off
    the seams outside config 5's rare reconcile paths, and the reads,
    lease serves, drops, snapshots and membership changes of each
    config), and on the card unless the plain step never ran, every
    kernel of the path launched and, at K=1 without churn (whose
    reconciles drain the pipeline by design), more than half of the
    window's steps were decoded pipelined. At K=1 on the card the step
    kernel is then held against its plain version on states the engine
    really stepped (StepRecorder; these comparison launches come after
    the counts are read) and fails on any mismatched field.
    Returns (report, launches in the run)."""
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.engine import vector

    spec = e2e.LADDER[config]
    groups = groups or E2E_GROUPS.get(config, spec["groups"])
    duration = duration or E2E_WINDOW_S.get(config, spec["duration"])
    vector.ACTIVATIONS.clear()
    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    K.REFERENCE_CALLS["step_batch"] = 0
    k = spec.get("steps_per_sync", 1)
    rebases = []

    def counted(f):
        def call(*a, **kw):
            rebases.append(1)
            return f(*a, **kw)
        return call

    with StepRecorder(K) as rec, _patched([(vector, "rebase_lanes", counted)]):
        r = e2e.run_ladder_config(config, groups=groups, duration=duration, device=device)
    launches = dict(cuda.LAUNCHES)
    r["rebase_calls"] = len(rebases)
    r["plain_step_calls"] = K.REFERENCE_CALLS["step_batch"]
    if device == "cuda" and k == 1:
        # after the counts are read: these calls are not the path's
        r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, SS_SEED + config)
    r["activation_batches"] = {str(k): v for k, v in sorted(vector.ACTIVATIONS.items())}
    r["launches"] = launches
    busy = r.get("busy") or {}
    lat = lambda k: f"{r.get(k, 0) * 1e3:.3f}"
    stages = sorted((r.get("host_stage_window_s") or {}).items(), key=lambda kv: -kv[1])
    traffic = {t: r[t] for t in ("reads_completed", "reads_per_sec", "read_latency_p99_s",
                                 "lease_reads_local", "lease_reads_fallback",
                                 "lease_vs_readindex_reads", "drops_applied",
                                 "snapshots_requested", "membership_changes",
                                 "session_registered_total", "session_proposals_total",
                                 "serving_admitted_total", "serving_shed_total",
                                 "serving_bulk_p50_s", "serving_bulk_p99_s") if t in r}
    log(f"engine config {config} ({spec['label']}; {groups} groups x {spec['replicas']}): "
        f"{r.get('committed', 0)} committed in {r.get('seconds')} s "
        f"({r.get('groups_committed_in_window')} groups committed in it), value "
        f"{r.get('value', 0):.1f}/s (proposals + reads), commit latency p50 "
        f"{lat('commit_latency_p50_s')} ms p99 {lat('commit_latency_p99_s')} ms, "
        f"{r.get('engine_steps_per_s', 0):.2f} engine steps/s (K={k}: "
        f"{r.get('engine_steps_per_s', 0) / k:.2f} dispatches/s), traffic {traffic}, "
        f"window seconds by stage {dict(stages)}, "
        f"thread CPU s per s {r.get('thread_cpu_share')}, "
        f"out-of-seam syncs {r.get('out_of_seam_syncs')} {r.get('out_of_seam_sites') or ''}, "
        f"kernel builds {r.get('kernel_builds')}, "
        f"device busy share {busy.get('device_busy_share') or 'not measured'} over "
        f"{busy.get('window_s', 0)} s ({busy.get('window_steps', 0)} steps), "
        f"elected {r.get('groups_elected')}/{groups} in "
        f"{r.get('bring_up_s')} s, converged {r.get('converged')}, lincheck "
        f"{r.get('lincheck_ok')}, kernel against plain at the engine's shape "
        f"{r.get('kernel_vs_plain', 'not compared')} [{r.get('card')}, {r.get('power_limit')}]")
    log(json.dumps({"engine": r}, default=str))
    bad = e2e.gate_failures(r)
    # the whole record goes to stdout above; the message carries what
    # explains a failed window
    why = {k: r.get(k) for k in ("committed", "client_dropped", "seconds",
                                 "groups_committed_in_window", "elections_in_window",
                                 "engine_steps", "commit_latency_p99_s", "wall_s",
                                 "thread_cpu_share")}
    assert not bad, f"config {config}: {bad} {why}"
    if device == "cuda":
        assert r["plain_step_calls"] == 0, "the engine ran the plain step on the card"
        idle = [n for n in E2E_KERNELS[k] if not launches[n]]
        assert not idle, f"the engine path never launched {idle}"
        if k == 1 and not spec.get("churn"):
            assert 2 * r["pipelined_steps"] > r["engine_steps"], (
                f"{r['pipelined_steps']} of {r['engine_steps']} steps decoded pipelined")
    return r, launches


# ------------------------------------------ phase 6: the fault plane on the card

# the first seed of the chaos matrix (tests/test_chaos_matrix.py) and the
# storm of the serving tests' graceful-degradation verdict
# (tests/test_serving.py), at their constants: 5 ms ticks, 30% drops of
# replication traffic, a 4 s partition schedule; a 0.8 s storm at 800
# bulk ops/s per tenant after 300 baseline ops
CHAOS_SEED = 11
STORM = dict(seed=0xD1A60, storm_s=0.8, baseline_ops=300, capacity_rate=800.0)
FAULT_RTT_MS = 5


def _kv_sm():
    from dragonboat_tpu_torch.statemachine import IStateMachine, Result

    class KV(IStateMachine):
        """`key=value` puts, key lookups, a hash of the whole map."""

        def __init__(self, *_):
            self.d = {}

        def update(self, data):
            k, v = data.decode().split("=", 1)
            self.d[k] = v
            return Result(value=1)

        def lookup(self, q):
            return self.d.get(q)

        def get_hash(self):
            return zlib.crc32(json.dumps(sorted(self.d.items())).encode())

        def save_snapshot(self, w, files, done):
            w.write(json.dumps(self.d).encode())

        def recover_from_snapshot(self, r, files, done):
            self.d = json.loads(r.read().decode())

    return KV


def _fault_host(nid, addrs, reg, workdir, share_scope, device, rtt_ms=FAULT_RTT_MS,
                recv_rate=0):
    """The reference tests' vector host: 32 lanes, P=4, W=64, 5 ms ticks."""
    from dragonboat_tpu_torch.config import EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import loopback_factory

    return NodeHost(NodeHostConfig(
        deployment_id=11, rtt_millisecond=rtt_ms,
        nodehost_dir=f"{workdir}/h{nid}", raft_address=addrs[nid],
        raft_rpc_factory=lambda listen: loopback_factory(listen, reg),
        max_snapshot_recv_bytes_per_second=recv_rate,
        engine=EngineConfig(kind="vector", max_groups=32, max_peers=4, log_window=64,
                            share_scope=share_scope, device=device)))


def phase_chaos(workdir, seed=CHAOS_SEED, device="cuda", rtt_ms=FAULT_RTT_MS):
    """One seed of the chaos matrix on `device`: 3 NodeHosts sharing one
    vector core, ticking every `rtt_ms`, FaultPlane(seed, 30% drops of
    replication traffic) installed on the core's co-hosted drop hook and
    on every transport, a seeded 4 s partition schedule while a client
    writes and reads, then heal, one final write, and the verdicts:
    something committed, the replicas applied the same index and hold
    the same state, no control-plane message was dropped from a full send
    queue, and the recorded history is linearizable. The CPU twin of the
    chaos matrix (tests/test_torch_faults.py) runs this body with
    device="cpu" and holds the returned `schedule` against the
    reference's."""
    import threading

    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.faults import REPLICATION_TYPES, FaultPlane, FaultSpec
    from dragonboat_tpu_torch.lincheck import HistoryRecorder, check_kv_history
    from dragonboat_tpu_torch.transport.loopback import _Registry

    cid, ids = 2, (1, 2, 3)
    fp = FaultPlane(seed, FaultSpec(drop=0.3, only_types=REPLICATION_TYPES))
    reg, kv = _Registry(), _kv_sm()
    addrs = {n: f"cm{n}:1" for n in ids}
    t_start = time.perf_counter()
    hosts = {n: _fault_host(n, addrs, reg, workdir, f"chip-chaos-{seed}", device, rtt_ms)
             for n in ids}
    try:
        for n, nh in hosts.items():
            nh.start_cluster(dict(addrs), False, lambda c, _n: kv(),
                             Config(cluster_id=cid, node_id=n, election_rtt=20,
                                    heartbeat_rtt=4, snapshot_entries=0))
        core = hosts[1].engine.core

        def leader():
            for n, nh in hosts.items():
                lid, ok = nh.get_leader_id(cid)
                if ok and lid == n and not nh.is_partitioned():
                    return nh
            return None

        deadline = time.monotonic() + 60
        while leader() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert leader() is not None, f"chaos seed {seed}: no leader elected"
        rec, stop, committed = HistoryRecorder(), threading.Event(), [0]

        def client():
            n = 0
            while not stop.is_set():
                nh = leader()
                if nh is None:
                    time.sleep(0.05)
                    continue
                n += 1
                key = f"k{n % 4}"
                if n % 3:
                    op = rec.invoke(0, ("put", key, f"v{n}"))
                    try:
                        nh.sync_propose(nh.get_noop_session(cid), f"{key}=v{n}".encode(),
                                        timeout_s=1.0)
                        rec.complete(op, None)
                        committed[0] += 1
                    except Exception:
                        rec.unknown(op)  # timed out, refused or dropped: maybe applied
                else:
                    op = rec.invoke(0, ("get", key))
                    try:
                        rec.complete(op, nh.sync_read(cid, key, timeout_s=1.0))
                    except Exception:
                        rec.fail(op)

        t = threading.Thread(target=client, name="chaos-client", daemon=True)
        t.start()
        core.set_local_drop_hook(fp.message_hook("local:core"))
        for n, nh in hosts.items():
            nh.transport.set_pre_send_batch_hook(fp.batch_hook(f"wire:h{n}"))
        sched = []
        for victim, window, idle in fp.partition_schedule(
                "faultloop", ids, total_s=4.0, min_window_s=0.2, max_window_s=0.5):
            sched.append((victim, window, idle))
            hosts[victim].set_partitioned(True)
            time.sleep(window)
            hosts[victim].set_partitioned(False)
            time.sleep(idle)
        core.set_local_drop_hook(None)
        for nh in hosts.values():
            nh.transport.set_pre_send_batch_hook(None)
            nh.set_partitioned(False)
        drops = sum(1 for _site, kind, _n, v in fp.schedule_log()
                    if kind in ("drop", "local_drop") and v)
        deadline = time.monotonic() + 30
        while committed[0] == 0 and time.monotonic() < deadline:
            time.sleep(0.2)
        stop.set()
        t.join(timeout=5)
        assert committed[0] > 0, f"chaos seed {seed}: nothing committed"
        deadline = time.monotonic() + 45
        while True:
            nh = leader()
            try:
                if nh is not None:
                    nh.sync_propose(nh.get_noop_session(cid), b"final=done", 5.0)
                    break
            except Exception:
                if time.monotonic() > deadline:
                    raise
            time.sleep(0.1)
        deadline = time.monotonic() + 30
        while True:
            idx = {n: nh.get_applied_index(cid) for n, nh in hosts.items()}
            if len(set(idx.values())) == 1:
                break
            assert time.monotonic() < deadline, f"chaos seed {seed}: applied {idx}"
            time.sleep(0.05)
        hashes = {n: nh.get_sm_hash(cid) for n, nh in hosts.items()}
        assert len(set(hashes.values())) == 1, f"chaos seed {seed}: state {hashes}"
        urgent = {n: nh.transport.metrics()["queue_dropped_urgent"] for n, nh in hosts.items()}
        assert not any(urgent.values()), f"chaos seed {seed}: urgent drops {urgent}"
        hist = rec.history()
        assert hist and check_kv_history(hist), f"chaos seed {seed}: not linearizable"
        return {"seed": seed, "committed": committed[0], "ops": len(hist),
                "partition_windows": len(sched), "schedule": sched, "drop_decisions": drops,
                "applied_index": idx[1], "seconds": round(time.perf_counter() - t_start, 2)}
    finally:
        for nh in hosts.values():
            nh.stop()


def phase_storm(workdir, device="cuda"):
    """serving.storm.run_overload_storm on one group of one NodeHost's
    vector engine on `device`: the graceful-degradation verdict (no
    urgent op shed, urgent p99 bounded, bulk shed fast with hints, the
    admitted throughput within 20% of the baseline) must hold, and the
    storm's schedule signature must be the one its seed draws with no
    host at all."""
    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.faults import FaultPlane
    from dragonboat_tpu_torch.serving import run_overload_storm
    from dragonboat_tpu_torch.serving.storm import STORM_SITE
    from dragonboat_tpu_torch.transport.loopback import _Registry

    t_start = time.perf_counter()
    nh = _fault_host(1, {1: "st1:1"}, _Registry(), workdir, None, device)
    try:
        nh.start_cluster({1: "st1:1"}, False, lambda c, n: _kv_sm()(),
                         Config(cluster_id=100, node_id=1, election_rtt=10, heartbeat_rtt=2))
        deadline = time.monotonic() + 60
        while not nh.get_leader_id(100)[1] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert nh.get_leader_id(100)[1], "storm: no leader elected"
        rep = run_overload_storm(nh, 100, **STORM)
        fp = FaultPlane(STORM["seed"])
        list(fp.overload_storm_schedule(STORM_SITE, (1, 2, 3), STORM["storm_s"]))
        assert rep.ok, f"storm verdicts {rep.verdicts}"
        assert rep.signature == fp.schedule_signature(sites=(STORM_SITE,)), "storm replay"
        return {"verdicts": rep.verdicts, "offered": rep.offered, "admitted": rep.admitted,
                "shed": rep.shed, "urgent_ops": rep.urgent_ops,
                "baseline_tput": rep.baseline_tput, "storm_tput": rep.storm_tput,
                "urgent_p99_s": rep.urgent_p99_s, "urgent_baseline_s": rep.urgent_baseline_s,
                "shed_max_latency_s": rep.shed_max_latency_s,
                "seconds": round(time.perf_counter() - t_start, 2)}
    finally:
        nh.stop()


def phase_faults(cuda, K, device="cuda"):
    """Phase 6: the chaos seed, then the storm, each with the launch
    counts zeroed just before it; on the card each must have launched the
    step kernel and never the plain step, and the kernel is then held
    against its plain version on states the engine stepped (the cores'
    shape: 32 lanes, W=64); fails unless some compared state had a
    wrapped log ring (the storm's group passes index 64 every run)."""
    import tempfile

    out = {}
    for i, (name, fn) in enumerate((("chaos", phase_chaos), ("storm", phase_storm))):
        for k in cuda.LAUNCHES:
            cuda.LAUNCHES[k] = 0
        K.REFERENCE_CALLS["step_batch"] = 0
        with tempfile.TemporaryDirectory(prefix=f"dbtorch-{name}-") as d, \
                StepRecorder(K) as rec:
            r = fn(d, device=device)
        r["launches"] = dict(cuda.LAUNCHES)
        r["plain_step_calls"] = K.REFERENCE_CALLS["step_batch"]
        if device == "cuda":
            r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, CHAOS_SEED + i)
        log(f"faults {name}: {json.dumps(r, default=str)}")
        if device == "cuda":
            assert r["plain_step_calls"] == 0, f"{name}: the engine ran the plain step on the card"
            assert r["launches"]["step_batch"] > 0, f"{name}: the step kernel never launched"
        out[name] = r
    if device == "cuda":
        wrapped = {n: r["kernel_vs_plain"]["wrapped_lanes"] for n, r in out.items()}
        assert any(wrapped.values()), f"no compared W=64 state had a wrapped ring: {wrapped}"
    return out


# ------------------------------ phase 7: the operator tools on the card

# config 2's width: 3 hosts x 1024 groups on one core, K=1
TOOLS_GROUPS = 1024
TOOLS_SERVE_S = 4.0
TOOLS_CLUSTER = 1  # the group whose snapshot is exported and imported


def _tools_nh_config(nid, reg, nh_dir, groups, device):
    """The NodeHostConfig of a tools-phase host: config 2's engine shape
    (the e2e harness's: W=256, inbox 4, 64 entries per message) on one
    core shared by the hosts of `reg`, with 3 x `groups` lanes."""
    from dragonboat_tpu_torch.config import EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.transport.loopback import loopback_factory

    return NodeHostConfig(
        raft_address=f"tools:{nid}", rtt_millisecond=10, nodehost_dir=nh_dir,
        raft_rpc_factory=lambda a: loopback_factory(a, reg),
        engine=EngineConfig(kind="vector", max_groups=max(4, 3 * groups), max_peers=4,
                            log_window=256, inbox_depth=4, max_entries_per_msg=64,
                            share_scope=f"tools-{id(reg)}", device=device))


def _tools_config(nid, cid):
    from dragonboat_tpu_torch.config import Config

    # e2e's timers: 10 ms ticks x 300 election RTT, 30-tick heartbeats
    return Config(node_id=nid, cluster_id=cid, election_rtt=300, heartbeat_rtt=30)


def _quiet(fn, *args):
    """fn(*args) with its standard output captured; (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def phase_tools(cuda, K, record, device="cuda", groups=TOOLS_GROUPS):
    """Phase 7: the port's operator tools against live NodeHosts at config
    2's width (3 hosts x `groups` groups on one core, K=1), with the
    flight recorder teed into an mmap ring and a history sampler per host.
    While the hosts serve proposals (e2e's pipelined waves on every group,
    and acknowledged `kv:` writes on group TOOLS_CLUSTER): tools.top
    collects from the live hosts (one row per lane, no doubles, a census
    read from the engine's tensors) and one group's snapshot is exported.
    After stop: tools.logdbcheck over every group's three replicas,
    tools.checkdisk on the workdir, tools.timeline merging the three
    history rings and the flight ring, tools.doctor on a bundle of them.
    Then the quorum repair: tools.importer imports the export with a
    one-member membership into a fresh dir, that host starts on `device`,
    every acknowledged write of the group reads back and a new proposal
    commits. Then tools.perfdiff (`record`, a phase-5 e2e config record,
    against itself: pass; against the JAX package's fixture: refused,
    exit 2), tools.check on the port (0 findings) and the helloworld
    example. Each engine part runs under its own StepRecorder, with the
    counts zeroed before it; on the card each must launch the step kernel
    and never the plain step, and the kernel is held against its plain
    version at the shape the part ran. Returns the phase's report."""
    import os
    import statistics
    import tempfile
    import threading

    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.examples import helloworld
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.profile import read_history
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.tools import check, doctor, perfdiff, timeline, top
    from dragonboat_tpu_torch.tools.checkdisk import check_disk
    from dragonboat_tpu_torch.tools.importer import import_snapshot
    from dragonboat_tpu_torch.tools.logdbcheck import check_logdb_consistency
    from dragonboat_tpu_torch.trace import flight_recorder
    from dragonboat_tpu_torch.transport.loopback import _Registry

    t_phase = time.perf_counter()
    walls = {}
    lap = [t_phase]

    def mark(name):
        now = time.perf_counter()
        walls[name] = round(now - lap[0], 3)
        lap[0] = now

    def part(name, rec, seed):
        """Read the part's counts, then (on the card) hold the kernel."""
        r = {"launches": dict(cuda.LAUNCHES), "plain_step_calls": K.REFERENCE_CALLS["step_batch"]}
        if device == "cuda":
            assert r["plain_step_calls"] == 0, f"tools {name}: the engine ran the plain step"
            assert r["launches"]["step_batch"] > 0, f"tools {name}: the step kernel never launched"
            r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, seed)
        return r

    def zero():
        for k in cuda.LAUNCHES:
            cuda.LAUNCHES[k] = 0
        K.REFERENCE_CALLS["step_batch"] = 0

    out = {"groups": groups, "lanes": 3 * groups}
    members = {n: f"tools:{n}" for n in (1, 2, 3)}
    with tempfile.TemporaryDirectory(prefix="dbtorch-tools-") as wd:
        ring = os.path.join(wd, "flight.ring")
        flight_recorder().attach_mmap(ring)
        reg = _Registry()
        hosts = {}
        e2e.BenchSM.replicas = {}
        zero()
        try:
            with StepRecorder(K) as rec:
                for nid in members:
                    hosts[nid] = NodeHost(_tools_nh_config(
                        nid, reg, os.path.join(wd, f"h{nid}"), groups, device))
                for nid, nh in hosts.items():
                    nh.start_clusters([(dict(members), False, e2e.BenchSM, _tools_config(nid, c))
                                       for c in range(1, groups + 1)])
                mark("hosts")
                snap_fn = hosts[1].engine.leader_snapshot
                leaders, deadline = {}, time.monotonic() + 180
                while len(leaders) < groups and time.monotonic() < deadline:
                    leaders.update((c, lid) for c, (lid, _t) in snap_fn().items() if lid)
                    time.sleep(0.05)
                assert len(leaders) == groups, f"tools: {groups - len(leaders)} groups never elected"
                mark("elect")
                # the samplers attach to the serving fleet (from bring-up,
                # the lane count's climb reads as doctor's lane_leak)
                hist = [nh.start_history(interval_s=0.25) for nh in hosts.values()]
                load = e2e._Load(hosts, dict(leaders), snap_fn, wave=8, cmd=b"x" * 16)
                loader = threading.Thread(target=load.run, args=(TOOLS_SERVE_S,), daemon=True)
                loader.start()
                lead = hosts[leaders[TOOLS_CLUSTER]]
                sess = lead.get_noop_session(TOOLS_CLUSTER)
                acked, collect_ms, snaps = {}, [], []
                t_end = time.monotonic() + TOOLS_SERVE_S
                i = 0
                while time.monotonic() < t_end or len(snaps) < 3:
                    # a round of 16 writes in flight on the group, a top
                    # collect while they commit, then their acks
                    round_ = [(f"k{j}", f"v{j}", lead.propose(
                        sess, f"kv:k{j}=v{j}".encode(), 60.0)) for j in range(i, i + 16)]
                    i += 16
                    t = time.perf_counter()
                    snaps.append(top.collect_snapshot(hosts))
                    collect_ms.append((time.perf_counter() - t) * 1e3)
                    for k, v, rs in round_:
                        if rs.wait(90.0).completed:
                            acked[k] = v
                loader.join(timeout=120)
                assert not loader.is_alive(), "tools: the load never finished"
                mark("serve")
                snap = snaps[-1]
                keys = [(r["host"], r["cluster_id"]) for r in snap["lanes"]]
                assert len(keys) == 3 * groups and len(set(keys)) == len(keys), (
                    f"top: {len(keys)} rows, {len(set(keys))} distinct, want {3 * groups}")
                hbm = snap["census"].get("hbm_bytes_total", 0)
                assert hbm > 0, f"top: census {snap['census']}"
                ranked = top.rank_lanes(snap, prev=snaps[-2])
                _, rendered = _quiet(top.render, snap)
                out["top"] = {
                    "rows": len(keys), "hbm_bytes_total": hbm,
                    "collect_ms_median": statistics.median(collect_ms),
                    "collect_ms_max": max(collect_ms), "collects": len(collect_ms),
                    "hottest": {k: ranked[0][k] for k in ("host", "cluster_id", "heat",
                                                         "ingest_rate")},
                    "header": rendered.splitlines()[:2],
                }
                export = os.path.join(wd, "export")
                os.makedirs(export)
                lead.sync_request_snapshot(TOOLS_CLUSTER, export_path=export, timeout_s=60.0)
                (src,) = [os.path.join(export, d) for d in os.listdir(export)]
                out["load"] = {"proposals_committed": load.total, "dropped": load.dropped,
                               "acked_writes": len(acked)}
                bundle = os.path.join(wd, "bundle")
                os.makedirs(bundle)
                with open(os.path.join(bundle, "top_snapshot.json"), "w") as f:
                    json.dump(snap, f)
                hosts[1].dump_flight(os.path.join(bundle, "flight_dump.jsonl"))
                for nh in hosts.values():
                    nh.stop()
                hosts = {}
                mark("export_stop")
            out["hosts"] = part("hosts", rec, SS_SEED + 70)
            costs = [h.stats() for h in hist]
            out["history"] = {
                "samplers": len(costs),
                "samples_total": sum(c["samples_total"] for c in costs),
                "errors_total": sum(c["errors_total"] for c in costs),
                "sample_cost_seconds_total": sum(c["sample_cost_seconds_total"] for c in costs),
                "sample_cost_ms_mean": 1e3 * sum(c["sample_cost_seconds_total"] for c in costs)
                / max(1, sum(c["samples_total"] for c in costs)),
                "lanes_per_sampler": groups,
            }
            mark("compare")

            # ---- after stop: logdbcheck, checkdisk, timeline, doctor ----
            dbs = {nid: ShardedLogDB(os.path.join(wd, f"h{nid}", f"tools-{nid}", "logdb"))
                   for nid in members}
            try:
                bad = {}
                for c in range(1, groups + 1):
                    rep = check_logdb_consistency(dbs, c)
                    if not rep.ok or len(rep.replicas) != 3:
                        bad[c] = rep.violations or f"{len(rep.replicas)} replicas"
                assert not bad, f"logdbcheck: {dict(list(bad.items())[:4])}"
            finally:
                for db in dbs.values():
                    db.close()
            out["logdbcheck"] = {"groups": groups, "replicas": 3, "violations": 0}
            mark("logdbcheck")
            out["checkdisk"] = check_disk(wd, count=50)
            rings = timeline.sweep_artifacts(wd)
            rc, text = _quiet(timeline.main, ["--sweep", wd, "--json"])
            assert rc == 0, "timeline failed"
            evs = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
            hist_hosts = {e.get("host") for e in evs if e.get("event") == "history_sample"}
            assert len(hist_hosts) == 3, f"timeline merged history of {hist_hosts}"
            assert sum(r.endswith("history.ring") for r in rings) == 3, rings
            assert all(a["_tw"] <= b["_tw"] for a, b in zip(evs, evs[1:])), "timeline order"
            out["timeline"] = {"artifacts": len(rings), "events": len(evs),
                               "history_hosts": sorted(map(str, hist_hosts)),
                               "span_s": round(evs[-1]["_tw"] - evs[0]["_tw"], 3)}
            with open(os.path.join(bundle, "history.jsonl"), "w") as f:
                for nid in members:
                    for smp in read_history(os.path.join(wd, f"h{nid}", f"tools-{nid}",
                                                         "history.ring"))[1]:
                        f.write(json.dumps(smp) + "\n")
            rc, text = _quiet(doctor.main, [bundle, "--json"])
            assert rc == 0, "doctor failed"
            report = json.loads(text)
            assert report["samples"] > 0 and len(report["hosts"]) == 3, report
            assert all(v["kind"] in doctor.SEVERITY for v in report["verdicts"]), report
            out["doctor"] = {"samples": report["samples"], "hosts": report["hosts"],
                             "window_s": report["window_s"],
                             "verdicts": [v["kind"] for v in report["verdicts"]]}
            mark("tools_after_stop")

            # ---- quorum repair: import the export into a fresh dir ----
            zero()
            with StepRecorder(K) as rec:
                ncfg = _tools_nh_config(1, _Registry(), os.path.join(wd, "repair"), 1, device)
                ss = import_snapshot(ncfg, src, {1: members[1]}, 1)
                assert ss.imported and set(ss.membership.addresses) == {1}, ss.membership
                nh = NodeHost(ncfg)
                try:
                    nh.start_cluster({}, False, e2e.BenchSM, _tools_config(1, TOOLS_CLUSTER))
                    deadline = time.monotonic() + 60
                    while nh.get_leader_id(TOOLS_CLUSTER) != (1, True):
                        assert time.monotonic() < deadline, "repaired host never led"
                        time.sleep(0.02)
                    wrong = {k: v for k, v in acked.items()
                             if nh.sync_read(TOOLS_CLUSTER, k, timeout_s=30.0) != v}
                    assert not wrong, f"importer: {len(wrong)} acknowledged writes lost"
                    nh.sync_propose(nh.get_noop_session(TOOLS_CLUSTER), b"kv:post=repair",
                                    timeout_s=30.0)
                    assert nh.sync_read(TOOLS_CLUSTER, "post", timeout_s=30.0) == "repair"
                    members_after = sorted(nh.get_cluster_membership(TOOLS_CLUSTER).addresses)
                finally:
                    nh.stop()
            out["importer"] = {"snapshot_index": ss.index, "acked_read_back": len(acked),
                               "members": members_after, **part("importer", rec, SS_SEED + 71)}
            mark("importer")
        finally:
            for nh in hosts.values():
                nh.stop()
            flight_recorder().detach_mmap()

        # ---- perfdiff: the phase-5 record against itself, and against
        # the JAX package's fixture (no backend stamp: refused) ----
        rec_path = os.path.join(wd, "e2e_config2.json")
        with open(rec_path, "w") as f:
            json.dump(e2e.bench_record({2: record}), f, default=str)
        here = os.path.dirname(os.path.abspath(__file__))
        base = os.path.join(here, "tests", "data", "perfdiff_base.json")
        rc_self, text = _quiet(perfdiff.main, [rec_path, rec_path, "--gate", "--json"])
        assert rc_self == 0 and json.loads(text)["verdict"] == "pass", text
        rc_ref, text = _quiet(perfdiff.main, [base, rec_path, "--gate", "--json"])
        assert rc_ref == 2 and json.loads(text)["verdict"] == "incomparable", text
        ref_reasons = json.loads(text).get("reasons")
        # the same record with its backend stamp removed: refused by the
        # backend rule alone (one side stamped)
        unstamped = os.path.join(wd, "e2e_config2_unstamped.json")
        with open(unstamped, "w") as f:
            json.dump({k: v for k, v in e2e.bench_record({2: record}).items()
                       if k != "backend"}, f, default=str)
        rc_bk, text = _quiet(perfdiff.main, [unstamped, rec_path, "--gate", "--json"])
        assert rc_bk == 2 and "backend" in json.loads(text)["reasons"][0], text
        out["perfdiff"] = {"self_rc": rc_self, "vs_jax_fixture_rc": rc_ref,
                           "vs_jax_fixture_reasons": ref_reasons, "unstamped_rc": rc_bk}
        mark("perfdiff")

        # ---- the static analyzer over the port ----
        rc, text = _quiet(check.main, [])
        assert rc == 0 and " 0 finding(s)" in text, text
        out["check"] = text.strip().splitlines()[-1]
        mark("check")

        # ---- helloworld: real TCP, 3 hosts, election to restart ----
        zero()
        with StepRecorder(K) as rec:
            rc, text = _quiet(helloworld.main, ["--device", device, "--data",
                                                os.path.join(wd, "helloworld")])
        assert rc == 0 and "HELLOWORLD PASS" in text, text[-2000:]
        out["helloworld"] = part("helloworld", rec, SS_SEED + 72)
        mark("helloworld")
    out["wall_s"] = walls
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


# --------------------------------- phase 8: the long-haul soak on the card

# tools.longhaul's own shape (3 hosts and the churn host, 32 lanes each,
# P=4, W=64, 5 ms ticks) on the vector engine: a seed-rotated run over the
# whole scenario mix at K=1, one round at K=8 on the on-device router, the
# rebalance scenario, the rejoin family (tests/test_chaos_matrix.py's
# seeds) and a round whose failure is injected. A round's seed, scenarios
# and round_s fix its orchestration schedule, so its signature is a
# constant: tests/test_torch_longhaul_cross.py derives each from the JAX
# package's longhaul on its scalar engine
LONGHAUL_ROUNDS = (
    ("k1", dict(rounds_max=2, round_s=7.2, rotate=True, seed=0xBEEF)),
    ("k8", dict(rounds_max=1, round_s=6.0, seed=0xD0C5, scenarios=("partition", "drop", "none"),
                steps_per_sync=8, shard_over_mesh=True)),
    ("rebalance", dict(rounds_max=1, round_s=5.0, seed=0x5EED14,
                       scenarios=("rebalance_under_load", "none"))),
    ("rejoin", dict(rounds_max=1, round_s=6.0, seed=0x5EED13,
                    scenarios=("observer_witness_churn", "prevote_rejoin_storm",
                               "streamed_install_under_crash", "none"))),
    ("injected", dict(rounds_max=1, round_s=3.0, seed=0xF00D, inject_failure=True)),
)
LONGHAUL_SIGNATURES = {
    "k1": ("4da1e7490f7e7186", "3cfebc0168018314"),
    "k8": ("cdc2992b9c4fae48",),
    "rebalance": ("edf4468d689360c3",),
    "rejoin": ("12a750b56ab9fda9",),
    "injected": ("6f730c3c085cfca7",),
}
# the kernels each round's engine must launch on the card
LONGHAUL_KERNELS = {1: ("step_batch",),
                    8: ("step_batch", "route_columns", "route_index", "route_scatter")}


class SuperstepRecorder:
    """While entered, every vector engine built inside it wraps its K-step
    super-step (engine/vector.py's make_multi_step_fn, and the sharded
    engine's make_sharded_multi_step_fn) to keep copies of the
    super-step's inputs (state, inbox, ticks, residual inbox, route and
    delta planes; per shard when sharded, each cloned on its shard's
    stream) as StepRecorder keeps the step's: clones on the engine's
    stream, one call in 4, halved when 6 are held. For holding the kernel
    super-step (step and router kernels, and the gather when sharded)
    against the plain one afterwards at the shape the engine ran.
    `pin(why)` also keeps the next unsharded super-step in `pinned`, as
    StepRecorder.pin does. The recorder entered last is
    `SuperstepRecorder.active`."""

    active = None
    PIN_CAP = 2

    def __init__(self, K):
        self.K, self.keep, self.every, self.calls = K, 3, 4, 0
        self.kept, self.kept_sharded = [], []
        self.pinned, self.pending, self.pins = [], set(), {}

    pin = StepRecorder.pin

    @property
    def states(self):
        """(why, copy) of every unsharded super-step kept."""
        return [("stride", k) for k in self.kept] + self.pinned

    def _record(self, kept, copy):
        self.calls += 1
        if self.pending and kept is self.kept:
            whys, self.pending = self.pending, set()
            for w in whys:
                self.pins[w] = self.pins.get(w, 0) + 1
            self.pinned.append(("+".join(sorted(whys)), copy()))
        if self.calls % self.every == 0:
            kept.append(copy())
            if len(kept) == 2 * self.keep:
                kept[:], self.every = kept[1::2], 2 * self.every

    def __enter__(self):
        import contextlib

        from dragonboat_tpu_torch.engine import vector

        self._vector = vector
        self._inner = vector.make_multi_step_fn, vector.make_sharded_multi_step_fn
        clone = self.K.clone_state

        def make(cfg, steps, *args, **kwargs):
            fn = self._inner[0](cfg, steps, *args, **kwargs)

            def multi_step(s, inbox, ticks, resid, route, rdelta, into=None):
                self._record(self.kept, lambda: (
                    clone(s), clone(inbox), ticks.clone(), clone(resid), route.clone(),
                    rdelta.clone(), cfg, steps))
                return fn(s, inbox, ticks, resid, route, rdelta, into=into)

            return multi_step

        def make_sharded(cfg, steps, devices, *args, **kwargs):
            fn = self._inner[1](cfg, steps, devices, *args, **kwargs)

            def sharded(states, inboxes, ticks, resids, routes, rdeltas, streams=None,
                        into=None):
                def copy():
                    copies = []
                    for i in range(len(states)):
                        with (torch.cuda.stream(streams[i]) if streams
                              else contextlib.nullcontext()):
                            copies.append((clone(states[i]), clone(inboxes[i]),
                                           ticks[i].clone(), clone(resids[i]),
                                           routes[i].clone(), rdeltas[i].clone()))
                    return copies, cfg, steps, tuple(devices)

                self._record(self.kept_sharded, copy)
                return fn(states, inboxes, ticks, resids, routes, rdeltas, streams=streams,
                          into=into)

            return sharded

        vector.make_multi_step_fn, vector.make_sharded_multi_step_fn = make, make_sharded
        SuperstepRecorder.active = self
        return self

    def __exit__(self, *exc):
        self._vector.make_multi_step_fn, self._vector.make_sharded_multi_step_fn = self._inner
        SuperstepRecorder.active = None
        return False


def compare_superstep_recorded(K, rec):
    """The kernel super-step against the plain one on every copy `rec`
    kept (the stride and the pinned ones), every field of the state, the
    stacked outputs and plans, the residual and its count. Fails on any
    mismatch."""
    states = rec.states
    assert states, "the engine's super-step was never recorded"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clone, bad = K.clone_state, set()
    for _why, (s, ib, ticks, resid, route, rdelta, cfg, steps) in states:
        res_k = K.multi_step_batch(clone(s), ib, ticks, clone(resid), route, rdelta, cfg, steps)
        res_p = K.multi_step_batch_reference(clone(s), ib, ticks, clone(resid), route, rdelta,
                                             cfg, steps)
        torch.cuda.synchronize()
        bad |= set(superstep_mismatches(res_k, res_p))
    cfg, steps = states[-1][1][6:]
    out = {"lanes": cfg.groups, "peers": cfg.peers, "log_window": cfg.log_window,
           "inbox_depth": cfg.inbox_depth, "steps": steps, "cases": len(states),
           "states": [why for why, _ in states],
           "mismatched_fields": sorted(bad), "max_abs_err": 0 if not bad else None,
           "seconds": round(time.perf_counter() - t0, 2)}
    assert not bad, f"kernel super-step disagrees with the plain one: {out}"
    return out


def _plant_ring(path):
    """A crash ring where a killed co-process would have left one: the
    failure bundle's sweep must find it without manual collection."""
    import os

    from dragonboat_tpu_torch.trace import MmapRing

    os.makedirs(os.path.dirname(path), exist_ok=True)
    ring = MmapRing(path)
    ring.write(json.dumps({"t": 1.0, "event": "planted_marker", "cluster": 0}).encode())
    ring.close()


def _check_bundle(res, planted, device):
    """The injected round's forensic bundle: manifest, the census read
    from the engines, the history ring and the doctor's diagnosis, the
    swept rings (the planted one and the round's history ring) merged into
    one timeline, and a replay line naming the port."""
    import os

    b = res.bundle
    assert b and os.path.isdir(b), f"no failure bundle: {b!r}"
    manifest = json.load(open(os.path.join(b, "manifest.json")))
    assert manifest["verdicts"].get("injected_failure") is False, manifest["verdicts"]
    for name in ("device_census.json", "diagnosis.json", "history.ring",
                 "merged_timeline.jsonl", "top_snapshot.json"):
        assert os.path.exists(os.path.join(b, name)), f"bundle lacks {name}"
    census = json.load(open(os.path.join(b, "device_census.json")))
    diag = json.load(open(os.path.join(b, "diagnosis.json")))
    swept = manifest["swept_artifacts"]
    assert planted in swept and any(p.endswith("history.ring") for p in swept), swept
    events = [json.loads(ln) for ln in open(os.path.join(b, "merged_timeline.jsonl"))]
    assert any(e.get("event") == "planted_marker" for e in events), "planted ring not merged"
    assert "python -m dragonboat_tpu_torch.tools.longhaul --seed" in res.replay, res.replay
    # the card is the default: its replay line names no device
    assert ("--device" not in res.replay if device == "cuda"
            else res.replay.endswith(f" --device {device}")), res.replay
    return {"files": sorted(os.listdir(b)), "swept": len(swept), "merged_events": len(events),
            "census_hosts": len(census) if hasattr(census, "__len__") else None,
            "diagnosis": [v["kind"] for v in diag["verdicts"]], "replay": res.replay}


def phase_longhaul(cuda, K, device="cuda", rounds=LONGHAUL_ROUNDS):
    """Phase 8: tools.longhaul on the vector engine on `device`, each run of
    LONGHAUL_ROUNDS with the counts zeroed just before it. Every round of
    every run but the injected one must pass every verdict (lincheck,
    convergence, Log Matching, fairness and its scenarios'), the preflight
    (tools.check over the port) must report 0 findings, and each round's
    schedule signature must be its constant. The injected round must fail
    its injected verdict only and leave a complete bundle. On the card the
    plain step must never run, every kernel of the run's path must launch,
    and afterwards the step kernel (K=1 runs) or the kernel super-step
    (the K=8 run) is held against its plain version on inputs the engines
    really stepped. Returns the phase's report."""
    import os
    import tempfile

    from dragonboat_tpu_torch.tools import longhaul

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="dbtorch-longhaul-") as wd:
        for i, (name, kw) in enumerate(rounds):
            run_dir = os.path.join(wd, name)
            planted = None
            if kw.get("inject_failure"):
                planted = os.path.join(run_dir, f"round-001-seed-0x{kw['seed']:X}", "crashed.ring")
                _plant_ring(planted)
            opts = longhaul.Options(budget_s=900.0, engine="vector", out_dir=run_dir, ring=False,
                                    device=device, reuse_out=planted is not None,
                                    triage=planted is None, **kw)
            for k in cuda.LAUNCHES:
                cuda.LAUNCHES[k] = 0
            K.REFERENCE_CALLS["step_batch"] = 0
            t0 = time.perf_counter()
            with StepRecorder(K) as rec, SuperstepRecorder(K) as srec:
                report = longhaul.run_longhaul(opts)
            r = {"seconds": round(time.perf_counter() - t0, 2),
                 "launches": dict(cuda.LAUNCHES),
                 "plain_step_calls": K.REFERENCE_CALLS["step_batch"],
                 "engine_steps": rec.calls, "supersteps": srec.calls,
                 "steps_per_sync": opts.steps_per_sync,
                 "preflight": {k: report["check"].get(k) for k in ("ok", "findings", "suppressed")},
                 "rounds": [{"seed": f"0x{x.seed:X}", "signature": x.signature,
                             "scenarios": x.scenarios, "ops": x.ops,
                             "verdicts": len(x.verdicts),
                             "failed": sorted(k for k, v in x.verdicts.items() if not v),
                             "error": x.error, "seconds": round(x.elapsed_s, 2)}
                            for x in report["rounds"]]}
            assert report["check"].get("ok") and report["check"].get("findings") == 0, \
                f"longhaul {name}: preflight {report['check']}"
            sigs = tuple(x["signature"] for x in r["rounds"])
            assert sigs == LONGHAUL_SIGNATURES[name], f"longhaul {name}: signatures {sigs}"
            if planted is not None:
                assert [x["failed"] for x in r["rounds"]] == [["injected_failure"]], r["rounds"]
                r["bundle"] = _check_bundle(report["rounds"][0], planted, device)
            else:
                assert report["ok"] and all(not x["failed"] and not x["error"]
                                            for x in r["rounds"]), f"longhaul {name}: {r['rounds']}"
            if device == "cuda":
                assert r["plain_step_calls"] == 0, f"longhaul {name}: the plain step ran"
                idle = [n for n in LONGHAUL_KERNELS[opts.steps_per_sync] if not r["launches"][n]]
                assert not idle, f"longhaul {name}: never launched {idle}"
                # after the counts are read: these launches are not the path's
                if opts.steps_per_sync == 1:
                    r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, SS_SEED + 80 + i)
                else:
                    r["superstep_vs_plain"] = compare_superstep_recorded(K, srec)
            for x in r["rounds"]:
                log(f"longhaul {name} round seed={x['seed']}: {x['seconds']} s, "
                    f"{x['ops']} client ops, scenarios {x['scenarios']}, sig {x['signature']}, "
                    f"{x['verdicts']} verdicts, failed {x['failed'] or 'none'}")
            log(f"longhaul {name}: {json.dumps(r, default=str)}")
            out[name] = r
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


# ------------- phase 9: native storage, C++ state machines, the C ABI

# half config 2's width: 3 hosts x 512 groups on one core, K=1, 10 ms ticks
# (1024 until the script's time on a slow card host neared its limit)
NATIVE_GROUPS = 512
NATIVE_LOAD_S = 2.0
NATIVE_WAVE = 128


def _native_lincheck(hosts, leaders, snap_fn, groups=8, clients=3, ops=4, seed=9):
    """e2e.lincheck_run's clients for the C++ KV plugin: `key=value`
    puts and byte-key reads of the first `groups` groups."""
    import random
    import threading

    from dragonboat_tpu_torch.lincheck import HistoryRecorder, check_kv_history
    from dragonboat_tpu_torch.requests import ErrTimeout

    rec, errors = HistoryRecorder(), []

    def client(i):
        rng = random.Random(seed * 100 + i)
        for j in range(ops):
            c = rng.randrange(1, groups + 1)
            key = f"lk{c}-{rng.randrange(2)}".encode()
            nh = hosts[snap_fn().get(c, (0, 0))[0] or leaders[c]]
            if rng.random() < 0.5:
                val = f"c{i}o{j}".encode()
                op = rec.invoke(i, ("put", key, val))
                try:
                    nh.sync_propose(nh.get_noop_session(c), key + b"=" + val, timeout_s=10.0)
                    rec.complete(op, None)
                except ErrTimeout:
                    rec.unknown(op)
                except Exception as e:
                    errors.append(repr(e))
                    rec.fail(op)
            else:
                op = rec.invoke(i, ("get", key))
                try:
                    rec.complete(op, nh.sync_read(c, key, timeout_s=10.0))
                except Exception as e:
                    errors.append(repr(e))
                    rec.fail(op)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hist = rec.history()
    return {"lincheck_ops": len(hist), "lincheck_errors": len(errors),
            "lincheck_ok": bool(hist) and check_kv_history(hist)}


def _hashes_converged(hosts, groups, timeout_s=60.0):
    """Wait until every group's replicas hold the same C++ SM hash (the
    ABI's get_hash) at the same applied index; count the groups that do."""
    deadline = time.monotonic() + timeout_s
    pending = set(range(1, groups + 1))
    while pending:
        for c in list(pending):
            idx = {nh.get_applied_index(c) for nh in hosts.values()}
            if len(idx) == 1 and len({nh.get_sm_hash(c) for nh in hosts.values()}) == 1:
                pending.discard(c)
        if not pending or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    return {"groups_hash_equal": groups - len(pending), "hashes_converged": not pending}


def _native_main(cuda, K, device, groups, load_s, plugin, workdir):
    """The main run of phase 9 (see phase_native). Returns its report and
    the StepRecorder that watched it."""
    import os

    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.cpp_sm import CppStateMachineFactory
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.profile import compile_watch, sync_audit
    from dragonboat_tpu_torch.storage.logdb import ShardedLogDB
    from dragonboat_tpu_torch.storage.native_kv import NativeWalKV
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    reg, hosts, r = _Registry(), {}, {"groups": groups, "lanes": 3 * groups}
    members = {n: f"native:{n}" for n in (1, 2, 3)}
    factory = CppStateMachineFactory(plugin)
    walls, lap = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        walls[name] = round(now - lap[0], 2)
        lap[0] = now

    with StepRecorder(K) as rec:
        try:
            for nid, addr in members.items():
                hosts[nid] = NodeHost(NodeHostConfig(
                    raft_address=addr, rtt_millisecond=10,
                    nodehost_dir=os.path.join(workdir, f"nh{nid}"),
                    raft_rpc_factory=lambda a: loopback_factory(a, reg),
                    logdb_factory=lambda d: ShardedLogDB(os.path.join(d, "logdb"),
                                                         kv_factory=NativeWalKV),
                    engine=EngineConfig(kind="vector", max_groups=3 * groups, max_peers=4,
                                        log_window=256, inbox_depth=4, max_entries_per_msg=64,
                                        share_scope=f"native-{id(reg)}", profile_sample_ratio=1,
                                        device=device)))
            kinds = {type(sh.kv).__name__ for nh in hosts.values() for sh in nh.logdb._shards}
            assert kinds == {"NativeWalKV"}, f"native: the logdb runs over {kinds}"
            r["logdb_kv"] = sorted(kinds)
            for nid in members:
                hosts[nid].start_clusters([
                    (dict(members), False, factory,
                     Config(node_id=nid, cluster_id=c, election_rtt=300, heartbeat_rtt=30))
                    for c in range(1, groups + 1)])
            mark("hosts")
            snap_fn = hosts[1].engine.leader_snapshot
            leaders, t0 = {}, time.monotonic()
            while len(leaders) < groups and time.monotonic() - t0 < 180.0:
                for c, (lid, _t) in snap_fn().items():
                    if lid:
                        leaders[c] = lid
                if len(leaders) < groups:
                    time.sleep(0.05)
            r.update(groups_elected=len(leaders), bring_up_s=round(time.monotonic() - t0, 2))
            mark("elect")
            assert len(leaders) == groups, f"native: {groups - len(leaders)} groups never elected"
            load = e2e._Load(hosts, leaders, snap_fn, NATIVE_WAVE, b"w=" + b"x" * 14)
            load.run(2.0)
            while not load.started():
                load.run(0.1)
            load.open_window()
            mark("warm")
            sync_mark = sync_audit().install(device=device).snapshot()
            build_mark = compile_watch().install().snapshot()
            t1 = time.perf_counter()
            load.run(load_s)
            stop = time.perf_counter() + 15.0
            while len(load.committed_groups) < groups and time.perf_counter() < stop:
                load.run(0.25)
            dt = time.perf_counter() - t1
            att = e2e._attribution_report(hosts, sync_mark, build_mark)
            mark("window")
            r.update(committed=load.total, seconds=round(dt, 2),
                     proposals_per_s=load.total / dt,
                     groups_committed_in_window=len(load.committed_groups),
                     out_of_seam_syncs=att["device_syncs"]["out_of_seam"],
                     out_of_seam_sites=att["device_syncs"]["sites"],
                     kernel_builds=att["compile_events"]["total"])
            r.update(e2e.latency_report(hosts))
            load.settle()
            r.update(_native_lincheck(hosts, leaders, snap_fn))
            mark("lincheck")
            r.update(_hashes_converged(hosts, groups))
            mark("hashes")
            r["engine_steps_total"] = hosts[1].engine.step_stats()["steps"]
        finally:
            for nh in hosts.values():
                try:
                    nh.stop()
                except Exception:
                    pass
            mark("stop")
    r["wall_s"] = walls
    return r, rec


def _diskkv_restart(plugin, workdir, device):
    """tests/test_cpp_sm.py's on-disk cluster restart on `device`: three
    hosts on the on-disk C++ plugin, 20 proposals, a follower restarted
    from its dir reopens the plugin at its persisted applied index and
    serves the last write."""
    import os

    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.cpp_sm import CppStateMachineFactory
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    t_start = time.perf_counter()
    factory, reg, hosts = CppStateMachineFactory(plugin), _Registry(), {}
    old = os.environ.get("DBTPU_DISKKV_DIR")
    os.environ["DBTPU_DISKKV_DIR"] = os.path.join(workdir, "diskkv")

    def mk(nid, restart=False):
        nh = NodeHost(NodeHostConfig(
            deployment_id=32, rtt_millisecond=5, nodehost_dir=f"{workdir}/d{nid}",
            raft_address=f"d{nid}:1", raft_rpc_factory=lambda a: loopback_factory(a, reg),
            engine=EngineConfig(kind="vector", max_groups=32, max_peers=4, log_window=64,
                                device=device)))
        nh.start_cluster({} if restart else {n: f"d{n}:1" for n in (1, 2, 3)}, False, factory,
                         Config(cluster_id=1, node_id=nid, election_rtt=20, heartbeat_rtt=2))
        return nh

    def leader():
        for n, nh in hosts.items():
            lid, ok = nh.get_leader_id(1)
            if ok and lid == n:
                return n
        return None

    try:
        for nid in (1, 2, 3):
            hosts[nid] = mk(nid)
        deadline = time.monotonic() + 60
        while leader() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert leader() is not None, "diskkv: no leader"
        i = 0
        while i < 20:
            lid = leader()
            try:
                if lid is not None:
                    nh = hosts[lid]
                    nh.sync_propose(nh.get_noop_session(1), f"k{i}=v{i}".encode(), timeout_s=5.0)
                    i += 1
                    continue
            except Exception:
                assert time.monotonic() < deadline + 60, "diskkv: proposals keep failing"
            time.sleep(0.05)
        lid = leader()
        victim = next(n for n in hosts if n != lid)
        applied = hosts[victim].get_applied_index(1)
        hosts[victim].stop()
        hosts[victim] = mk(victim, restart=True)
        resumed = hosts[victim].get_applied_index(1)
        deadline = time.monotonic() + 30
        while True:
            try:
                if hosts[victim].stale_read(1, b"k19") == b"v19":
                    break
            except Exception:
                pass
            assert time.monotonic() < deadline, "diskkv: the restarted host did not recover"
            time.sleep(0.05)
        return {"applied_before_restart": applied, "applied_at_restart": resumed,
                "seconds": round(time.perf_counter() - t_start, 2)}
    finally:
        for nh in hosts.values():
            try:
                nh.stop()
            except Exception:
                pass
        if old is None:
            os.environ.pop("DBTPU_DISKKV_DIR", None)
        else:
            os.environ["DBTPU_DISKKV_DIR"] = old


def _run_demos(paths, plugins, workdir, device):
    """The port's embed_demo and oo_demo (native/examples, linked against
    the port's libdbtpu.so) with the NodeHost on `device`."""
    import os

    from dragonboat_tpu_torch import native

    out = {}
    for name, plugin, banner in (("embed_demo", plugins["kvstore"], "EMBED DEMO PASS"),
                                 ("oo_demo", plugins["diskkv"], "OO DEMO PASS")):
        env = native.demo_env(device)
        env["DBTPU_DISKKV_DIR"] = os.path.join(workdir, f"{name}-diskkv")
        t0 = time.perf_counter()
        proc = subprocess.run([paths[name], os.path.join(workdir, name), plugin],
                              capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0 and banner in proc.stdout, \
            f"{name}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
        out[name] = {"seconds": round(time.perf_counter() - t0, 2), "passed": banner}
    return out


def phase_native(cuda, K, device="cuda", groups=NATIVE_GROUPS, load_s=NATIVE_LOAD_S):
    """Phase 9: the native pieces on `device`. Builds native/ (make: the
    WAL store and the example C++ state machine plugins) and the port's
    embedding library with its demos (dragonboat_tpu_torch.native); a
    failed build fails the phase. Main run at `groups` groups (3 hosts x
    `groups` groups on one core, K=1): each host's ShardedLogDB over
    NativeWalKV, every group's state machine the C++ KV plugin through
    CppStateMachineFactory; elect every group, pipelined waves for
    `load_s` (run on until every group committed one in the window), a
    3-client propose/read history that must be linearizable, and every
    group's replicas at one C++ SM hash; 0 kernel builds and 0 device
    reads off the seams in the window, the step kernel launched and the
    plain step never (counts zeroed just before), then the kernel held
    against its plain version at this shape. Then the on-disk plugin's
    3-host restart, and the port's embed_demo and oo_demo with the
    NodeHost on `device`. Returns the phase's report."""
    import tempfile

    from dragonboat_tpu_torch import native
    from dragonboat_tpu_torch.storage.native_kv import _ensure_built

    t_phase = time.perf_counter()
    plugins = native.build_plugins()
    _ensure_built()
    paths = native.build_embedding()
    out = {"build_s": round(time.perf_counter() - t_phase, 2)}
    for k in cuda.LAUNCHES:
        cuda.LAUNCHES[k] = 0
    K.REFERENCE_CALLS["step_batch"] = 0
    with tempfile.TemporaryDirectory(prefix="dbtorch-native-") as wd:
        r, rec = _native_main(cuda, K, device, groups, load_s, plugins["kvstore"], wd)
    r["launches"] = dict(cuda.LAUNCHES)
    r["plain_step_calls"] = K.REFERENCE_CALLS["step_batch"]
    log(f"native: {json.dumps(r, default=str)}")
    gates = {"elected": r["groups_elected"] == groups, "committed": r["committed"] > 0,
             "lincheck": r["lincheck_ok"], "hashes": r["hashes_converged"],
             "builds": r["kernel_builds"] == 0, "syncs": r["out_of_seam_syncs"] == 0}
    assert all(gates.values()), f"native: gates {gates}"
    if device == "cuda":
        assert r["plain_step_calls"] == 0, "native: the engine ran the plain step on the card"
        assert r["launches"]["step_batch"] > 0, "native: the step kernel never launched"
        r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, SS_SEED + 90)
    out["main"] = r
    for k in cuda.LAUNCHES:
        cuda.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory(prefix="dbtorch-diskkv-") as wd:
        out["diskkv_restart"] = _diskkv_restart(plugins["diskkv"], wd, device)
    out["diskkv_restart"]["launches"] = dict(cuda.LAUNCHES)
    if device == "cuda":
        assert out["diskkv_restart"]["launches"]["step_batch"] > 0, "diskkv: no step launched"
    with tempfile.TemporaryDirectory(prefix="dbtorch-embed-") as wd:
        out["demos"] = _run_demos(paths, plugins, wd, device)
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


# ---------- phase 10: the sharded path (shard_over_mesh) on logical shards

# 4 shards, each its own lane block, state tree and CUDA stream; on a
# one-card machine all of them on cuda:0 (logical shards). The kernel-level
# lockstep runs config 6's shape (3,072 lanes) and BASELINE's scale (50,000
# lanes: 12,500 groups x 4 replicas, 12,500 lanes a shard); the engine runs
# configs 6 and 2 through NodeHost with shard_over_mesh at MESH_ENGINE_GROUPS
# (half config 2's 1,024), each over a 4 s window (bench.py's 10 s; both cut
# to keep the script within its time on a slow card host)
MESH_ENGINE_S = 4.0
MESH_ENGINE_GROUPS = 512
MESH_SHARDS = 4
MESH_WINDOWS = 4
MESH_BIG = (12500, 4)
MESH_CONFIGS = (6, 2)
MESH_KERNELS = ("step_batch", "route_columns", "ring_gather", "route_index", "route_scatter")


def _join_superstep(K, res):
    """A sharded super-step result joined over the lane axis."""
    return (K.unshard_tree(res[0]), K.unshard_tree(res[1], axis=1),
            K.unshard_tree(res[2], axis=1), K.unshard_tree(res[3]), K.unshard_tree(res[4]))


def _on_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_on_cpu(t) for t in tree)
    return type(tree)(*(t.cpu() for t in tree))


def compare_sharded_recorded(K, rec):
    """The kernel sharded super-step (its own streams) on every copy `rec`
    (a SuperstepRecorder) kept of the sharded engine's against the plain
    unsharded super-step on the joined inputs, every field. Fails on any
    mismatch."""
    assert rec.kept_sharded, "the engine's sharded super-step was never recorded"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clone, bad = K.clone_state, set()
    for copies, cfg, steps, devices in rec.kept_sharded:
        cols = list(zip(*copies))
        fn = K.make_sharded_multi_step_fn(cfg, steps, devices)
        res_k = fn([clone(x) for x in cols[0]], cols[1], cols[2],
                   [clone(x) for x in cols[3]], cols[4], cols[5])
        joined = [K.unshard_tree(list(c)) for c in cols]
        res_p = K.multi_step_batch_reference(clone(joined[0]), joined[1], joined[2],
                                             clone(joined[3]), joined[4], joined[5], cfg, steps)
        torch.cuda.synchronize()
        bad |= set(superstep_mismatches(_join_superstep(K, res_k), res_p))
    cfg, steps, devices = rec.kept_sharded[-1][1:]
    out = {"lanes": cfg.groups, "shards": len(devices), "steps": steps,
           "cases": len(rec.kept_sharded), "mismatched_fields": sorted(bad),
           "max_abs_err": 0 if not bad else None,
           "seconds": round(time.perf_counter() - t0, 2)}
    assert not bad, f"kernel sharded super-step disagrees with the plain one: {out}"
    return out


def mesh_lockstep(K, cuda, kb, groups, replicas, devices, yardstick):
    """The sharded super-step over `devices` (one per shard, each on a
    stream of its own, K=SS_STEPS) for MESH_WINDOWS windows of the config-6
    scenario, in lockstep with a plain yardstick, every field of the state,
    the stacked outputs and plans, the residual and its count after every
    window: yardstick "sharded" is sharded_multi_step_batch on CPU copies of
    the shards (the plain sharded version), "unsharded" the plain unsharded
    super-step on the card. The launch counts are read before any other
    launch. Returns (cfg, s0, route, rdelta, hosts, mismatched fields,
    launches)."""
    from dragonboat_tpu_torch.ops.state import make_empty_inbox

    cfg = kb.superstep_config(groups, replicas)
    G, n, steps = cfg.groups, len(devices), SS_STEPS
    dev = devices[0]
    cpu = torch.device("cpu")
    s0, route, rdelta = kb.superstep_cluster(groups, replicas, cfg, dev)
    smulti = K.make_sharded_multi_step_fn(cfg, steps, devices)
    ticks = torch.ones((G,), dtype=torch.int32, device=dev)
    shard = lambda x: K.shard_tree(x, n, devices=devices)
    s_sh, resid_sh = shard(K.clone_state(s0)), shard(make_empty_inbox(cfg, dev))
    sticks, routes, rdeltas = shard(ticks), shard(route), shard(rdelta)
    if yardstick == "sharded":
        cshard = lambda x: K.shard_tree(_on_cpu(x), n)
        s_p, resid_p = cshard(s0), cshard(make_empty_inbox(cfg, dev))
        p_args = (cshard(ticks), cshard(route), cshard(rdelta))
    else:
        s_p, resid_p = K.clone_state(s0), make_empty_inbox(cfg, dev)
    rc = torch.zeros((G,), dtype=torch.int32, device=dev)
    leaders = np.zeros(groups, dtype=np.int64)
    rng = np.random.default_rng(SS_SEED + groups)
    hosts, bad_all = [], set()
    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    for w in range(MESH_WINDOWS):
        ib, leaders = kb.host_window(w, rc, leaders, groups, replicas, cfg, rng, dev)
        hosts.append((ib, leaders.copy()))
        res_sh = smulti(s_sh, shard(ib), sticks, resid_sh, routes, rdeltas)
        got = _join_superstep(K, res_sh)
        if yardstick == "sharded":
            res_p = K.sharded_multi_step_batch(s_p, K.shard_tree(_on_cpu(ib), n), p_args[0],
                                               resid_p, p_args[1], p_args[2], cfg, steps)
            want = _join_superstep(K, res_p)
            bad = superstep_mismatches(_on_cpu(got), want)
            s_p, resid_p = res_p[0], res_p[3]
        else:
            res_p = K.multi_step_batch_reference(s_p, ib, ticks, resid_p, route, rdelta, cfg,
                                                 steps)
            bad = superstep_mismatches(got, res_p)
            s_p, resid_p = res_p[0], res_p[3]
        bad_all |= set(bad)
        s_sh, resid_sh, rc = res_sh[0], res_sh[3], got[4].to(dev)
        for st in (*s_sh, *(s_p if yardstick == "sharded" else (s_p,))):
            kb.compact(st)
        log(f"mesh lockstep {G} lanes over {n} shards ({yardstick} yardstick) window {w}: "
            f"routed {int(sum(int(p.sum()) for p in got[2]))}, residual {int(got[4].sum())}, "
            f"mismatched fields {sorted(bad) or 0}")
    counts = dict(cuda.LAUNCHES)  # the yardsticks launch none of the kernels
    want_n = MESH_WINDOWS * steps * n
    if dev.type == "cuda":
        assert all(counts[k] == want_n for k in MESH_KERNELS), (counts, want_n)
    return cfg, s0, route, rdelta, hosts, sorted(bad_all), counts


def phase_mesh_engine(cuda, K, config, devices, groups=None, duration=None):
    """BASELINE config `config` through NodeHost with shard_over_mesh over
    `devices` (engine.vector.mesh_devices names them for the run), with
    every gate of e2e.gate_failures, the mesh stamps, no ghost lane in
    lane_stats, and the launches of the path: per inner step n step
    launches and, at K>1, n of each router kernel and n gathers. At K>1 the
    window must build no host Message for co-hosted traffic while the
    device router carries it, and a recorded engine super-step is held
    against the plain one afterwards (SuperstepRecorder; these launches
    come after the counts are read). Returns (report, launches)."""
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.engine import vector

    spec = e2e.LADDER[config]
    k, n = spec.get("steps_per_sync", 1), len(devices)
    orig = vector.mesh_devices
    vector.mesh_devices = lambda device: tuple(devices)
    for name in cuda.LAUNCHES:
        cuda.LAUNCHES[name] = 0
    K.REFERENCE_CALLS["step_batch"] = 0
    try:
        with SuperstepRecorder(K) as rec:
            r = e2e.run_ladder_config(config, groups=groups, duration=duration,
                                      device=devices[0].type, shard_over_mesh=True)
    finally:
        vector.mesh_devices = orig
    launches = dict(cuda.LAUNCHES)
    r["launches"] = launches
    r["plain_step_calls"] = K.REFERENCE_CALLS["step_batch"]
    inner = max(1, r.get("engine_steps_total", 0))
    r["launches_per_inner_step"] = {name: c / inner for name, c in launches.items()}
    msgs = r.get("msgs_in_window") or {}
    log(f"mesh engine config {config} ({spec['label']}; {r.get('groups')} groups x "
        f"{spec['replicas']}) over {n} shards on {len({str(d) for d in devices})} card(s): "
        f"{r.get('committed', 0)} committed in {r.get('seconds')} s, value "
        f"{r.get('value', 0):.1f}/s, commit p50 {r.get('commit_latency_p50_s')} s p99 "
        f"{r.get('commit_latency_p99_s')} s, {r.get('engine_steps_per_s', 0):.2f} engine steps/s "
        f"(K={k}), mesh {dict((x, r.get(x)) for x in ('shard_over_mesh', 'n_devices', 'mesh_shape', 'padded_groups'))}, "
        f"messages in the window {msgs}, lanes {r.get('lanes_total')}, launches {launches} "
        f"({ {x: round(v, 3) for x, v in r['launches_per_inner_step'].items()} } per inner "
        f"step), out-of-seam syncs {r.get('out_of_seam_syncs')}, kernel builds "
        f"{r.get('kernel_builds')}, elected {r.get('groups_elected')}, converged "
        f"{r.get('converged')}, lincheck {r.get('lincheck_ok')} [{r.get('card')}, "
        f"{r.get('power_limit')}]")
    log(json.dumps({"mesh_engine": r}, default=str))
    bad = e2e.gate_failures(r)
    assert not bad, f"mesh config {config}: {bad}"
    assert (r["shard_over_mesh"], r["n_devices"], r["mesh_shape"]) == (True, n, [n]), r
    assert "padded_groups" in r and r["padded_groups"] >= 0
    # lane_stats reports the configured lanes only: no ghost of the round-up
    assert r.get("lanes_total") == r["groups"] * spec["replicas"], r.get("lanes_total")
    if k > 1:
        for key in ("msgs_replicate", "msgs_broadcast", "msgs_resp"):
            assert msgs.get(key) == 0, f"co-hosted traffic built host messages: {msgs}"
        assert msgs.get("msgs_routed_device", 0) > 0, msgs
    if devices[0].type != "cuda":
        return r, launches
    assert r["plain_step_calls"] == 0, "the sharded engine ran the plain step on the card"
    assert launches["step_batch"] > 0 and launches["step_batch"] % n == 0, launches
    if k > 1:
        for name in MESH_KERNELS:
            assert launches[name] == launches["step_batch"], launches
        r["superstep_vs_plain"] = compare_sharded_recorded(K, rec)
    else:
        assert all(launches[x] == 0 for x in MESH_KERNELS[1:]), launches
    return r, launches


def gather_at_scale(K, kb, cfg, devices, timed):
    """The gather's launches in the profiled sharded super-steps of
    time_superstep (`timed`): device time per launch (the kernel's time
    over its launch count) beside one destination's byte bound at this
    record size."""
    n = len(devices)
    words = K.record_words(cfg.groups // n, cfg)
    key = next(k for k in timed["device_ms_by_kernel"] if k.startswith("ring_gather_kernel"))
    per_step = timed["device_launches_by_kernel"][key]
    out = {"lanes": cfg.groups, "shards": n, "record_words": words,
           "ms": timed["device_ms_by_kernel"][key] / per_step,
           "launches_per_superstep": per_step,
           "bound_ms": kb.ring_gather_dest_bytes(n, words) / kb.HBM_BYTES_PER_S * 1e3}
    # the library call that computes one destination's stack: torch.stack
    # of the n records (timed here only; the port never calls it). The
    # profiler's device times held nothing for it on the card, so CUDA
    # events around 20 calls time it (each call moves 234 MB at 50,000
    # lanes: the gap between launches is noise beside it)
    g = torch.Generator(device=devices[0]).manual_seed(SS_SEED)
    recs = [torch.randint(-2**31, 2**31 - 1, (words,), dtype=torch.int32, device=devices[0],
                          generator=g) for _ in range(n)]
    stacked = torch.stack(recs)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(20):
        torch.stack(recs, out=stacked)
    t1.record()
    torch.cuda.synchronize()
    out["library_ms"] = t0.elapsed_time(t1) / 20
    del recs, stacked
    log(f"ring_gather in the sharded super-step @ {cfg.groups} lanes ({n} x {words}-word "
        f"records): {out['ms']:.4f} ms per launch ({per_step:.0f} launches a super-step), "
        f"bound {out['bound_ms']:.5f} ms, torch.stack of the {n} records "
        f"{out['library_ms']:.4f} ms")
    return out


def phase_mesh(cuda, K, kb, card):
    """Phase 10: the sharded path over MESH_SHARDS logical shards of one
    card (each its own stream), then, where more cards are visible, over
    the distinct cards. Returns the phase's report."""
    t_phase = time.perf_counter()
    logical = (torch.device("cuda", 0),) * MESH_SHARDS
    cards = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    spans = [("logical", logical)]
    if len(cards) > 1:
        spans.append(("cards", cards[:MESH_SHARDS]))
    log(f"mesh: shards on {len(cards[:MESH_SHARDS]) if len(cards) > 1 else 1} distinct card(s) "
        f"of {len(cards)} visible; runs {[name for name, _ in spans]}")
    out = {"distinct_cards": len(cards[:MESH_SHARDS]) if len(cards) > 1 else 1, "runs": {}}
    for name, devices in spans:
        run = {}
        # config 6's shape, against the plain sharded version on the CPU
        cfg, s0, route, rdelta, hosts, bad, counts = mesh_lockstep(
            K, cuda, kb, SS_GROUPS, SS_REPLICAS, devices, "sharded")
        run["lockstep_3072"] = {"lanes": cfg.groups, "windows": MESH_WINDOWS,
                                "mismatched_fields": bad, "launches": counts}
        assert not bad, f"mesh lockstep at {cfg.groups} lanes: {bad}"
        if name == "logical":
            # BASELINE's scale: 50,000 lanes, against the plain unsharded
            # super-step on the card; then the sharded super-step's wall and
            # busy time against the unsharded one's at the same lanes
            bcfg, b0, broute, brdelta, bhosts, bbad, bcounts = mesh_lockstep(
                K, cuda, kb, *MESH_BIG, devices, "unsharded")
            run["lockstep_50k"] = {"lanes": bcfg.groups, "windows": MESH_WINDOWS,
                                   "mismatched_fields": bbad, "launches": bcounts}
            assert not bbad, f"mesh lockstep at {bcfg.groups} lanes: {bbad}"
            for label, sharded in (("unsharded", False), ("sharded", True)):
                t = time_superstep(K, cuda, kb, bcfg, b0, broute, brdelta, bhosts, sharded)
                run["lockstep_50k"][label] = t
                log(f"mesh superstep {label} @ {bcfg.groups} lanes (K={SS_STEPS}"
                    f"{f', {MESH_SHARDS} shards' if sharded else ''}): wall "
                    f"{t['wall_ms']:.3f} ms, device {t['device_ms']:.3f} ms, busy "
                    f"{t['device_busy_ms_per_superstep']} ms of "
                    f"{t['profiled_wall_ms_per_superstep']:.3f} ms profiled wall, idle share "
                    f"{t['device_idle_share']}, launches per super-step "
                    f"{t['launches_per_superstep']} [{card}]")
            run["lockstep_50k"]["gather"] = gather_at_scale(K, kb, bcfg, devices,
                                                            run["lockstep_50k"]["sharded"])
        for config in MESH_CONFIGS if name == "logical" else MESH_CONFIGS[:1]:
            r, launches = phase_mesh_engine(cuda, K, config, devices, groups=MESH_ENGINE_GROUPS,
                                            duration=MESH_ENGINE_S)
            run[f"config{config}"] = r
        out["runs"][name] = run
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


# ------------- phase 11: the reference's engine-level scenarios on the card

# (a) and (b) at half BASELINE config 2's width: 512 groups x 3 replicas on
# one shared core (config 2's 1,024 until the script's time on a slow card
# host neared its limit), config 2's engine shape (W=256, inbox 4, 64
# entries a message), 10 ms ticks. Elections 50 ticks and heartbeats 10: the storm
# isolates a replica for 8 election timeouts (the reference storm's
# schedule), which short timeouts keep to seconds. Pre-vote with
# check-quorum, the canonical pairing, except where the storm turns
# pre-vote off.
SCEN_GROUPS = 512
# phases 12 and 13 keep config 2's width (1,024 groups x 3)
WIDE_GROUPS = 1024
SCEN_RTT_MS = 10
SCEN_ELECTION, SCEN_HEARTBEAT = 50, 10
SCEN_WAVE = 4  # proposals per group in a wave
# the reference storm's shape (tests/test_prevote.py): 3 replicas, one
# group, 10-tick elections, 2-tick heartbeats
STORM_N, STORM_ELECTION, STORM_HEARTBEAT = 3, 10, 2


def _scen_host(tag, nid, reg, workdir, groups, device, steps_per_sync=1, enable_metrics=False):
    from dragonboat_tpu_torch.config import EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import loopback_factory

    return NodeHost(NodeHostConfig(
        deployment_id=12, rtt_millisecond=SCEN_RTT_MS, nodehost_dir=f"{workdir}/{tag}{nid}",
        raft_address=f"{tag}{nid}:1", raft_rpc_factory=lambda a: loopback_factory(a, reg),
        enable_metrics=enable_metrics,
        engine=EngineConfig(kind="vector", max_groups=3 * groups, max_peers=4, log_window=256,
                            inbox_depth=4, max_entries_per_msg=64,
                            steps_per_sync=steps_per_sync,
                            share_scope=f"chip-{tag}-{id(reg)}", device=device)))


def _scen_cfg(nid, cid, **kw):
    from dragonboat_tpu_torch.config import Config

    kw.setdefault("pre_vote", True)
    return Config(cluster_id=cid, node_id=nid, election_rtt=SCEN_ELECTION,
                  heartbeat_rtt=SCEN_HEARTBEAT, check_quorum=True, snapshot_entries=0, **kw)


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, what()
        time.sleep(0.05)


def _leaders(nh):
    return {c: lid for c, (lid, _t) in nh.engine.leader_snapshot().items() if lid}


def _wave(hosts, leaders, groups, tag, timeout_s=60.0):
    """SCEN_WAVE proposals per group through its leader, all in flight at
    once; returns how many completed."""
    pending = []
    for c in range(1, groups + 1):
        nh = hosts[leaders[c]]
        pending.append(nh.propose_batch_async(
            nh.get_noop_session(c), [f"{tag}{i}=v{c}".encode() for i in range(SCEN_WAVE)],
            timeout_s))
    done = 0
    for h in pending:
        h.wait(timeout_s + 5.0)
        done += h.completed
    return done


def scen_witness(workdir, device, groups=SCEN_GROUPS, steps_per_sync=1):
    """tests/test_witness_lanes.py at SCEN_GROUPS' width: groups of 2 full
    replicas (hosts 1 and 2) elect, each leader adds node 3 as a WITNESS
    through the membership API and host 3 starts it with join, a wave of
    proposals per group commits. Verdicts (the reference's): every witness
    lane reports the WITNESS role, zero payload bytes and the leader, its
    SM never applied a client update while the full replicas' did. At K=1
    the two full replicas are then cut from each other (a co-hosted drop
    hook) and a second wave must commit through leader and witness, the
    witness counting in the quorum. At K>1 (steps_per_sync) the core
    routes co-hosted traffic on the device, and the witness-bound traffic
    must stay on the payload-stripping host path."""
    from dragonboat_tpu_torch.ops.state import ROLE
    from dragonboat_tpu_torch.transport.loopback import _Registry

    tag = f"wit{steps_per_sync}-"
    reg, kv = _Registry(), _kv_sm()
    addrs = {n: f"{tag}{n}:1" for n in (1, 2, 3)}
    hosts = {n: _scen_host(tag, n, reg, workdir, groups, device, steps_per_sync)
             for n in (1, 2, 3)}
    try:
        full = {1: addrs[1], 2: addrs[2]}
        for n in (1, 2):
            hosts[n].start_clusters([(dict(full), False, lambda c, _n: kv(), _scen_cfg(n, c))
                                     for c in range(1, groups + 1)])
        _wait_for(lambda: len(_leaders(hosts[1])) == groups, 120,
                  lambda: f"witness: {len(_leaders(hosts[1]))}/{groups} groups elected")
        leaders = _leaders(hosts[1])
        adds = [hosts[leaders[c]].request_add_witness(c, 3, addrs[3], timeout_s=60.0)
                for c in range(1, groups + 1)]
        added = sum(1 for rs in adds if rs.wait(65.0).completed)
        assert added == groups, f"witness: {added}/{groups} witnesses added"
        hosts[3].start_clusters([({}, True, lambda c, _n: kv(), _scen_cfg(3, c, is_witness=True))
                                 for c in range(1, groups + 1)])
        leaders = _leaders(hosts[1])
        wave1 = _wave(hosts, leaders, groups, "a")

        def followed():
            st = hosts[3].engine.lane_stats()
            return len(st) == groups and all(
                s["leader_id"] == leaders[c] and s["term"] > 0 for c, s in st.items())

        _wait_for(followed, 60, lambda: "witness: witness lanes never followed their leaders")
        st = hosts[3].engine.lane_stats()
        empty = kv().get_hash()
        roles = {s["role"] for s in st.values()}
        payload = sum(s["payload_bytes"] for s in st.values())
        wit_applied = sum(1 for c in st if hosts[3].get_sm_hash(c) != empty)
        full_applied = sum(1 for c in range(1, groups + 1)
                           if hosts[leaders[c]].get_sm_hash(c) != empty)
        verdicts = {"wave_committed": wave1 == SCEN_WAVE * groups,
                    "witness_role": roles == {ROLE.WITNESS}, "witness_zero_payload": payload == 0,
                    "witness_sm_untouched": wit_applied == 0,
                    "full_replicas_applied": full_applied == groups}
        out = {"groups": groups, "lanes": 3 * groups, "steps_per_sync": steps_per_sync,
               "witnesses_added": added, "wave_completed": wave1,
               "witness_payload_bytes": payload}
        if steps_per_sync == 1:
            core = hosts[1].engine.core
            core.set_local_drop_hook(lambda m: {m.from_, m.to} == {1, 2})
            try:
                wave2 = _wave(hosts, leaders, groups, "b")
            finally:
                core.set_local_drop_hook(None)
            verdicts["witness_in_commit_quorum"] = wave2 == SCEN_WAVE * groups
            out["quorum_wave_completed"] = wave2
        else:
            out["msgs_routed_device"] = hosts[1].engine.core.step_stats()["msgs_routed_device"]
        out["verdicts"] = verdicts
        return out
    finally:
        for nh in hosts.values():
            nh.stop()


def reference_storm(prevote, device):
    """tests/test_prevote.py's test_rejoin_storm_prevote_on_vs_off on the
    port's LoopbackCluster (the step kernel on the card): elect, isolate a
    follower for 8 election timeouts, heal, run 4 more; the leader, the
    terms before and after, and each replica's elections started."""
    from dragonboat_tpu_torch.ops.loopback import LoopbackCluster

    kc = LoopbackCluster(n_replicas=STORM_N, n_groups=1, election=STORM_ELECTION,
                         heartbeat=STORM_HEARTBEAT, prevote=prevote, device=device)
    for _ in range(200):
        kc.step()
        kc.settle()
        if kc.leader_of(0) is not None:
            break
    lead = kc.leader_of(0)
    assert lead is not None, "reference storm: no leader"
    base = kc.field("term", 0)
    kc.isolated.add((lead + 1) % STORM_N)
    for _ in range(8 * STORM_ELECTION):
        kc.step()
        kc.settle()
    kc.isolated.clear()
    for _ in range(4 * STORM_ELECTION):
        kc.step()
        kc.settle()
    return {"leader": lead, "leader_after": kc.leader_of(0), "terms_before": base,
            "terms_after": kc.field("term", 0),
            "elections_started": [int(np.asarray(c)[0][0]) for c in kc.counters]}


def scen_storm(workdir, device, prevote, groups=SCEN_GROUPS):
    """The rejoin storm at SCEN_GROUPS' width: 3 replicas a group, leaders on
    hosts 1 and 2 (host 3 starts after they elect); a wave; host 3 stops
    (one replica of every group), a wave it misses, host 3 restarts from
    its directory partitioned, every one of its replicas campaigns in
    isolation (pre-vote on: as a pre-candidate at its old term; off: a
    real candidate at ever higher terms) for at least 8 election
    timeouts, then heals and runs 4 more. Verdicts (the reference's):
    pre-vote on, every group keeps its leader and no term moves; pre-vote
    off, the terms move."""
    from dragonboat_tpu_torch.ops.state import ROLE
    from dragonboat_tpu_torch.transport.loopback import _Registry

    tag = f"storm{int(prevote)}-"
    reg, kv = _Registry(), _kv_sm()
    addrs = {n: f"{tag}{n}:1" for n in (1, 2, 3)}
    spec = lambda n: [(dict(addrs), False, lambda c, _n: kv(), _scen_cfg(n, c, pre_vote=prevote))
                      for c in range(1, groups + 1)]
    hosts = {n: _scen_host(tag, n, reg, workdir, groups, device) for n in (1, 2)}
    try:
        for n in (1, 2):
            hosts[n].start_clusters(spec(n))
        _wait_for(lambda: len(_leaders(hosts[1])) == groups, 120,
                  lambda: f"storm: {len(_leaders(hosts[1]))}/{groups} groups elected")
        leaders = _leaders(hosts[1])
        hosts[3] = _scen_host(tag, 3, reg, workdir, groups, device)
        hosts[3].start_clusters(spec(3))
        wave1 = _wave(hosts, leaders, groups, "a")
        terms = lambda n: {c: s["term"] for c, s in hosts[n].engine.lane_stats().items()}
        base = {n: terms(n) for n in (1, 2)}
        assert _leaders(hosts[1]) == leaders, "storm: leadership moved before the storm"
        hosts.pop(3).stop()
        wave2 = _wave(hosts, leaders, groups, "b")
        hosts[3] = _scen_host(tag, 3, reg, workdir, groups, device)
        hosts[3].set_partitioned(True)
        hosts[3].start_clusters(spec(3))
        t_iso = time.monotonic()
        campaigned = set()
        want = ROLE.PRE_CANDIDATE if prevote else ROLE.CANDIDATE

        def all_campaigned():
            for c, s in hosts[3].engine.lane_stats().items():
                if s["role"] == want:
                    campaigned.add(c)
            return len(campaigned) == groups

        _wait_for(all_campaigned, 120,
                  lambda: f"storm: {len(campaigned)}/{groups} isolated replicas campaigned")
        # 8 election timeouts of isolation in all, at the logical clock
        # the replicas ran: at least the time the slowest took to campaign
        time.sleep(max(8 * SCEN_ELECTION * SCEN_RTT_MS / 1000 - (time.monotonic() - t_iso), 0))
        isolated_s = time.monotonic() - t_iso
        hosts[3].set_partitioned(False)
        time.sleep(4 * SCEN_ELECTION * SCEN_RTT_MS / 1000)

        def settled():
            ls = _leaders(hosts[1])
            st = hosts[3].engine.lane_stats()
            return len(ls) == groups and all(st[c]["leader_id"] == ls[c] for c in st)

        _wait_for(settled, 120, lambda: "storm: the groups never settled after the heal")
        after = _leaders(hosts[1])
        now = {n: terms(n) for n in (1, 2)}
        moved = sum(1 for c in range(1, groups + 1) if any(now[n][c] != base[n][c] for n in (1, 2)))
        ctr = {n: hosts[n].engine.lane_counters() for n in hosts}
        started = {n: sum(v["elections_started"] for v in ctr[n].values()) for n in ctr}
        won = {n: sum(v["elections_won"] for v in ctr[n].values()) for n in ctr}
        kept = sum(1 for c in range(1, groups + 1) if after[c] == leaders[c])
        verdicts = {"waves_committed": wave1 == wave2 == SCEN_WAVE * groups,
                    "every_isolated_replica_campaigned": len(campaigned) == groups}
        if prevote:
            verdicts.update(leaders_kept=kept == groups, terms_unmoved=moved == 0)
        else:
            verdicts.update(terms_moved=moved == groups)
        return {"groups": groups, "lanes": 3 * groups, "prevote": prevote,
                "waves_completed": [wave1, wave2], "isolated_s": round(isolated_s, 2),
                "groups_leader_kept": kept, "groups_terms_moved": moved,
                "elections_started": started, "elections_won": won,
                "verdicts": verdicts}
    finally:
        for nh in hosts.values():
            nh.stop()


def _leader_of(hosts, cid):
    for n, nh in hosts.items():
        try:
            lid, ok = nh.get_leader_id(cid)
        except Exception:
            continue  # a crashed or stopped node
        if ok and lid == n:
            return n
    return None


def scen_lease(workdir, device):
    """tests/test_lease.py at its shapes: the kernel's lease grant and local
    read (test_kernel_lease_grant_and_local_read, a 3-replica
    LoopbackCluster, the step kernel on the card), then the probe API and
    its fallback through three vector hosts on one core
    (test_lease_probe_api_and_fallback): the leader earns its lease from
    quorum heartbeat acks and serves `lease_read`; a follower's probe
    raises the typed, retriable ErrLeaseExpired while its `sync_read`
    falls back to ReadIndex and reads the value."""
    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.ops.loopback import LoopbackCluster
    from dragonboat_tpu_torch.requests import ErrLeaseExpired, ErrSystemBusy
    from dragonboat_tpu_torch.transport.loopback import _Registry

    kc = LoopbackCluster(n_replicas=3, n_groups=1, election=10, heartbeat=2, lease_read=True,
                         lease_margin=2, device=device)
    lead = None
    for _ in range(300):
        kc.step()
        kc.settle()
        lead = kc.leader_of(0)
        if lead is not None:
            break
    assert lead is not None, "lease: no kernel leader"
    kc.propose(lead, 0, 1)
    kc.settle()
    lease_ok = lambda: bool(kc.last_outputs[lead].lease_ok[0].cpu())
    for _ in range(8):
        kc.step()
        kc.settle()
        if lease_ok():
            break
    granted = lease_ok()
    st = {f: int(getattr(kc.states[lead], f)[0].cpu()) for f in
          ("lease_until", "tick_count", "lease_margin", "hb_round_tick")}
    kc.ready_reads[lead].clear()
    kc.read_index(lead, 0, ctx=42)
    kc.step(tick=False)
    served = int(kc.last_outputs[lead].lease_served[0].cpu())
    ready = [ctx for (_g, ctx, _i, _c2) in kc.ready_reads[lead]]
    verdicts = {
        "kernel_lease_granted": granted,
        "kernel_lease_bounded": st["tick_count"] < st["lease_until"]
        <= st["hb_round_tick"] + 10 - st["lease_margin"],
        "kernel_local_read_same_step": served == 1 and ready == [42]}

    reg, kv = _Registry(), _kv_sm()
    members = {n: f"lease{n}:1" for n in (1, 2, 3)}
    hosts = {n: _fault_host(n, members, reg, workdir, f"chip-lease-{id(reg)}", device)
             for n in members}
    try:
        for n, nh in hosts.items():
            nh.start_cluster(dict(members), False, lambda c, _n: kv(),
                             Config(node_id=n, cluster_id=1, election_rtt=20, heartbeat_rtt=4,
                                    lease_read=True))
        _wait_for(lambda: _leader_of(hosts, 1) is not None, 30, lambda: "lease: no leader")
        ld = _leader_of(hosts, 1)
        hosts[ld].sync_propose(hosts[ld].get_noop_session(1), b"k=v", timeout_s=10.0)
        _wait_for(lambda: hosts[ld].engine.lease_valid(1), 10,
                  lambda: "lease: the leader never earned its lease")
        verdicts["probe_served_on_leader"] = hosts[ld].lease_read(1, "k", timeout_s=10.0) == "v"
        follower = next(n for n in hosts if n != ld)
        try:
            hosts[follower].lease_read(1, "k")
            verdicts["probe_refused_on_follower"] = False
        except ErrLeaseExpired as e:
            verdicts["probe_refused_on_follower"] = (isinstance(e, ErrSystemBusy)
                                                     and e.retry_after_s > 0)
        verdicts["follower_read_falls_back"] = (
            hosts[follower].sync_read(1, "k", timeout_s=10.0) == "v")
        return {"kernel": st, "lease_stats": hosts[ld].engine.lease_stats(),
                "verdicts": verdicts}
    finally:
        for nh in hosts.values():
            nh.stop()


def scen_install(workdir, device):
    """tests/test_streamed_install.py at its shape and constants (5 ms
    ticks, 8 KiB chunks, snapshots every 20 entries): a member crashed
    behind a compacted log rejoins through a streamed install throttled to
    150 kB/s, its whole host crashes mid-stream, and the restarted host's
    install must RESUME from the recorded offset (skipped chunks > 0) and
    converge (test_install_resumes_after_host_crash_mid_stream); then the
    abort: a stream with a gap reports `out_of_order` through the abort
    hook (test_chunks_abort_notifies_nodehost) and a replica whose install
    aborted fails reads fast with the typed ErrSnapshotStreamAborted and
    its retry hint until cleared (test_err_snapshot_stream_aborted_fails_
    reads_fast)."""
    import os

    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.settings import soft
    from dragonboat_tpu_torch.transport.loopback import _Registry

    cid, reg, kv = 5, _Registry(), _kv_sm()
    members = {n: f"si{n}:1" for n in (1, 2, 3)}
    cfg = lambda n: Config(cluster_id=cid, node_id=n, election_rtt=60, heartbeat_rtt=10,
                           snapshot_entries=20, compaction_overhead=5, pre_vote=True,
                           check_quorum=True)
    mk = lambda n, rate=0: _fault_host(n, members, reg, workdir, None, device, recv_rate=rate)
    chunk = soft.sent_snapshot_chunk_size
    soft.sent_snapshot_chunk_size = 8 * 1024
    hosts = {n: mk(n, 150_000 if n == 3 else 0) for n in (1, 2, 3)}
    try:
        for n in (1, 2, 3):
            hosts[n].start_cluster(members, False, lambda c, _n: kv(), cfg(n))
        _wait_for(lambda: _leader_of(hosts, cid) is not None, 30, lambda: "install: no leader")
        leader = _leader_of(hosts, cid)
        if leader == 3:
            hosts[3].request_leader_transfer(cid, 1)
            _wait_for(lambda: _leader_of(hosts, cid) in (1, 2), 10,
                      lambda: "install: leadership never left host 3")
            leader = _leader_of(hosts, cid)
        hosts[3].crash_cluster(cid)
        s = hosts[leader].get_noop_session(cid)
        for i in range(60):
            hosts[leader].sync_propose(s, f"big{i}={'b' * 4096}".encode(), timeout_s=5.0)
        _wait_for(lambda: len({hosts[n].get_applied_index(cid) for n in (1, 2)}) == 1, 20,
                  lambda: "install: the live members never met")
        for n in (1, 2):
            hosts[n].sync_request_snapshot(cid, timeout_s=10.0)
        hosts[3].restart_cluster(cid)
        root = hosts[3].snapshot_dir_root()
        _wait_for(lambda: any("stream-progress.json" in f for _r, _d, f in os.walk(root)), 30,
                  lambda: "install: the stream never started")
        hosts[3].crash()
        hosts[3] = mk(3)
        hosts[3].start_cluster(members, False, lambda c, _n: kv(), cfg(3))
        ch = hosts[3]._chunks
        _wait_for(lambda: ch.stats()["resumed_streams"] >= 1
                  and ch.stats()["completed_streams"] >= 1, 90,
                  lambda: f"install: no resumed stream completed {ch.stats()}")
        want = hosts[leader].get_sm_hash(cid)
        _wait_for(lambda: hosts[3].get_sm_hash(cid) == want, 60,
                  lambda: "install: the rejoiner diverged")
        stats = ch.stats()
        verdicts = {"resumed": stats["resumed_streams"] >= 1,
                    "skipped_durable_chunks": stats["skipped_chunks"] > 0,
                    "converged": hosts[3].get_sm_hash(cid) == want}
    finally:
        soft.sent_snapshot_chunk_size = chunk
        for nh in hosts.values():
            try:
                nh.stop()
            except Exception:
                pass  # the crashed host's stop may find nothing to stop
    verdicts.update(_install_abort(f"{workdir}/abort", device))
    return {"chunk_stats": stats, "verdicts": verdicts}


def _install_abort(workdir, device):
    """The abort half of scen_install: a chunk gap, then the typed error."""
    import os

    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.requests import ErrSnapshotStreamAborted
    from dragonboat_tpu_torch.rsm.snapshotio import SnapshotHeader, SnapshotWriter
    from dragonboat_tpu_torch.transport.chunks import Chunks
    from dragonboat_tpu_torch.transport.loopback import _Registry
    from dragonboat_tpu_torch.transport.snapshotstream import load_chunk_data, split_snapshot_message
    from dragonboat_tpu_torch.types import Membership, Message, MessageType, Snapshot

    os.makedirs(workdir)
    path = f"{workdir}/abort.gbsnap"
    mem = Membership(addresses={1: "a:1", 2: "a:2"})
    with open(path, "wb") as f:
        with SnapshotWriter(f, SnapshotHeader(index=50, term=3, membership=mem), session=b"") as w:
            w.write(b"x" * (64 * 1024))
    ss = Snapshot(filepath=path, file_size=os.path.getsize(path), index=50, term=3,
                  membership=mem, cluster_id=5)
    m = Message(type=MessageType.INSTALL_SNAPSHOT, cluster_id=5, to=2, from_=1, snapshot=ss)
    chunks = [load_chunk_data(c, chunk_size=4096)
              for c in split_snapshot_message(m, chunk_size=4096)]

    class Sink:
        def __init__(self):
            self.aborts = []

        def snapshot_dir_root(self):
            return f"{workdir}/abort-recv"

        def handle_message_batch(self, batch):
            pass

        def handle_snapshot(self, *a):
            pass

        def _on_snapshot_stream_aborted(self, cluster_id, node_id, from_, reason):
            self.aborts.append((cluster_id, reason))

    sink = Sink()
    ch = Chunks(sink)
    first = ch.add_chunk(chunks[0])
    gap = ch.add_chunk(chunks[3])
    verdicts = {"gap_aborts_stream": first and not gap
                and ch.stats()["aborted_streams"] == 1 and sink.aborts == [(5, "out_of_order")]}
    nh = _fault_host(1, {1: "sa1:1"}, _Registry(), workdir, None, device)
    try:
        nh.start_cluster({1: "sa1:1"}, False, lambda c, _n: _kv_sm()(),
                         Config(cluster_id=5, node_id=1, election_rtt=20, heartbeat_rtt=4))
        _wait_for(lambda: nh.get_leader_id(5)[1], 20, lambda: "abort: no leader")
        node = nh._get_node(5)
        node.notify_install_aborted(retry_after_s=1.5)
        try:
            nh.read_index(5, timeout_s=2.0)
            verdicts["aborted_install_fails_reads_fast"] = False
        except ErrSnapshotStreamAborted as e:
            verdicts["aborted_install_fails_reads_fast"] = e.retry_after_s == 1.5
        node.clear_install_aborted()
        verdicts["reads_flow_after_clear"] = nh.read_index(5, timeout_s=5.0).wait(5.0).completed
    finally:
        nh.stop()
    return verdicts


def scen_crash_save(workdir, device):
    """tests/test_crash_safety.py's crash mid save_snapshot at its shape (3
    vector hosts, 5 ms ticks): a follower's user snapshot save parks on a
    gate, the node crashes mid-save, writes go on, it restarts with the
    save still parked, the save is released, more writes; verdicts (the
    reference's): every replica reaches one applied index and one SM
    hash, the victim's most recent snapshot is loadable or absent, and the
    client history is linearizable."""
    import threading

    from dragonboat_tpu_torch.config import Config
    from dragonboat_tpu_torch.lincheck import HistoryRecorder, check_kv_history
    from dragonboat_tpu_torch.requests import RequestError
    from dragonboat_tpu_torch.transport.loopback import _Registry

    gate, saving = threading.Event(), threading.Event()
    base = _kv_sm()

    class SlowSnap(base):
        def save_snapshot(self, w, files, done):
            saving.set()
            gate.wait(timeout=10.0)
            super().save_snapshot(w, files, done)

    reg, rec = _Registry(), HistoryRecorder()
    members = {n: f"cs{n}:1" for n in (1, 2, 3)}
    hosts = {}
    try:
        for n in (1, 2, 3):
            hosts[n] = _fault_host(n, members, reg, workdir, None, device)
            hosts[n].start_cluster(members, False, lambda c, _n: SlowSnap(),
                                   Config(cluster_id=1, node_id=n, election_rtt=20,
                                          heartbeat_rtt=4))

        def put(i):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                nid = _leader_of(hosts, 1)
                if nid is not None:
                    op = rec.invoke(0, ("put", "k", f"v{i}"))
                    try:
                        hosts[nid].sync_propose(hosts[nid].get_noop_session(1),
                                                f"k=v{i}".encode(), 2.0)
                        rec.complete(op, None)
                        return
                    except RequestError:
                        rec.unknown(op)
                time.sleep(0.05)
            raise AssertionError(f"crash-save: put {i} never committed")

        for i in range(5):
            put(i)
        leader = _leader_of(hosts, 1)
        victim = next(n for n in (1, 2, 3) if n != leader)
        hosts[victim].request_snapshot(1, timeout_s=10.0)
        assert saving.wait(timeout=20.0), "crash-save: the save never started"
        hosts[victim].crash_cluster(1)
        for i in range(5, 10):
            put(i)
        hosts[victim].restart_cluster(1)
        gate.set()
        for i in range(10, 13):
            put(i)
        _wait_for(lambda: len({hosts[n].get_applied_index(1) for n in hosts}) == 1, 45,
                  lambda: "crash-save: the rejoiner never converged")
        ss = hosts[victim]._get_node(1).snapshotter.get_most_recent_snapshot()
        verdicts = {
            "converged": len({hosts[n].get_applied_index(1) for n in hosts}) == 1,
            "one_hash": len({hosts[n].get_sm_hash(1) for n in hosts}) == 1,
            "snapshot_loadable": ss is None or ss.is_empty() or ss.index >= 0,
            "linearizable": check_kv_history(rec.history(), max_states=2_000_000)}
        return {"victim": victim, "ops": len(rec.history()), "verdicts": verdicts}
    finally:
        gate.set()
        for nh in hosts.values():
            nh.stop()


SCENARIOS = (
    ("witness_k1", lambda d, dev, g: scen_witness(d, dev, g, steps_per_sync=1)),
    ("witness_k8", lambda d, dev, g: scen_witness(d, dev, g, steps_per_sync=8)),
    ("storm_prevote_on", lambda d, dev, g: scen_storm(d, dev, True, g)),
    ("storm_prevote_off", lambda d, dev, g: scen_storm(d, dev, False, g)),
    ("lease", lambda d, dev, g: scen_lease(d, dev)),
    ("install", lambda d, dev, g: scen_install(d, dev)),
    ("crash_save", lambda d, dev, g: scen_crash_save(d, dev)),
)


def run_scenarios(cuda, K, card, scenarios, seed, device="cuda", groups=None,
                  host_only=()):
    """Run each (name, fn) of `scenarios` through the port's NodeHost on
    `device` with the launch counts zeroed just before it and read just
    after, its K=1 engine steps recorded (StepRecorder) and its K=8
    super-steps (SuperstepRecorder); on the card it must have launched the
    kernels and never the plain step, and the step kernel (and at K=8 the
    router) is then held against its plain version on the recorded
    states. Prints one line per scenario and fails on any false verdict or
    mismatched field. A scenario named in `host_only` runs the scalar
    engine, which launches no kernel and records no step. Returns the
    records by name."""
    import tempfile

    out = {}
    for i, (name, fn) in enumerate(scenarios):
        for k in cuda.LAUNCHES:
            cuda.LAUNCHES[k] = 0
        K.REFERENCE_CALLS["step_batch"] = 0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"dbtorch-{name}-") as d, \
                StepRecorder(K) as rec, SuperstepRecorder(K) as srec:
            r = fn(d, device, groups)
        r["seconds"] = round(time.perf_counter() - t0, 2)
        r["launches"] = dict(cuda.LAUNCHES)
        r["plain_step_calls"] = K.REFERENCE_CALLS["step_batch"]
        compared = []
        if device == "cuda" and name in host_only:
            assert r["plain_step_calls"] == 0 and r["launches"]["step_batch"] == 0, (
                f"{name}: a host-only scenario stepped a vector engine")
        elif device == "cuda":
            assert r["plain_step_calls"] == 0, f"{name}: the engine ran the plain step on the card"
            assert r["launches"]["step_batch"] > 0, f"{name}: the step kernel never launched"
            if rec.states:
                r["kernel_vs_plain"] = compare_recorded(K, cuda, rec, seed + i)
                compared.append(r["kernel_vs_plain"])
            if srec.states:
                assert r["launches"]["route_scatter"] > 0, f"{name}: the router never launched"
                r["superstep_vs_plain"] = compare_superstep_recorded(K, srec)
                compared.append(r["superstep_vs_plain"])
            assert compared, f"{name}: no engine step was recorded"
        log(f"scenario {name}: " + json.dumps({
            "scenario": name, "seconds": r["seconds"], "verdicts": r["verdicts"],
            "compared_cases": sum(c["cases"] for c in compared),
            "mismatched_fields": sorted({f for c in compared for f in c["mismatched_fields"]}),
            "compared_states": [s for c in compared
                                for s in c.get("active_quiesced_lanes", c.get("states", ()))],
            "card": card, **{k: v for k, v in r.items() if k not in (
                "seconds", "verdicts", "kernel_vs_plain", "superstep_vs_plain")}},
            default=str))
        bad = [v for v, ok in r["verdicts"].items() if not ok]
        assert not bad, f"scenario {name}: verdicts failed {bad}"
        out[name] = r
    return out


def phase_scenarios(cuda, K, card, device="cuda", groups=SCEN_GROUPS):
    """Phase 11: the reference's engine-level scenarios through the port's
    NodeHost on `device` (SCENARIOS, through run_scenarios: witnesses,
    pre-candidates, live leases and installs in flight on the recorded
    states), then the reference test's own storm on the port's
    LoopbackCluster beside the phase's counts."""
    t_phase = time.perf_counter()
    out = run_scenarios(cuda, K, card, SCENARIOS, 1100, device, groups)
    ref = {on: reference_storm(on, device) for on in (True, False)}
    out["reference_storm"] = ref
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    log("scenario storm elections: " + json.dumps({
        "reference_test": {f"prevote_{'on' if k else 'off'}": v for k, v in ref.items()},
        "config2_width": {n: {"elections_started": out[n]["elections_started"],
                              "elections_won": out[n]["elections_won"],
                              "groups_terms_moved": out[n]["groups_terms_moved"]}
                          for n in ("storm_prevote_on", "storm_prevote_off") if n in out},
        "card": card}))
    return out


# ------- phase 12: the reference's last engine-level test files on the card

# Each scenario runs the reference test's own body: tests/<file>.py copied
# onto the port by tests/torch_twin.py with its engines on the card, at
# the test's shapes, ticks, timeouts and seeds; a body whose assertions
# hold is a true verdict. (f) also runs, and (j) runs only, at WIDE_GROUPS'
# width (config 2's 1,024 groups x 3 replicas on one core).
FLEET_ELECT_S = 120  # tests/test_bring_up.py's bound on electing every group
FLEET_GROUPS = 2048  # test_bulk_fleet_bring_up's fleet


def _tests_module(name):
    """tests/<name>.py, imported from the end of sys.path: the card's
    Python has a `tests` package of its own, so `tests.<name>` does not
    resolve there."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    return importlib.import_module(name)


def _reference(name, device):
    """tests/<name>.py's copy on the port, its engines on `device`."""
    return _tests_module("torch_twin").port_copy(name, device)


def _held(out, test, fn, *args):
    """Run a reference test body: out["verdicts"][test] says whether its
    assertions held, and out["failed"][test] keeps the message of one that
    did not."""
    try:
        fn(*args)
        out["verdicts"][test] = True
    except AssertionError as e:
        out["verdicts"][test] = False
        out.setdefault("failed", {})[test] = str(e)[:500]


def _with_fixture(fixture, arg, test):
    """`test` on the value of the generator fixture `fixture` given `arg`,
    set up and torn down as pytest does."""
    with contextlib.contextmanager(fixture.__wrapped__)(arg) as value:
        test(value)


@contextlib.contextmanager
def _patched(patches):
    """Each (cls, name, wrap) of `patches` sets cls.name to wrap(the
    original) during the block."""
    saved = [(cls, n, getattr(cls, n)) for cls, n, _ in patches]
    for (cls, n, f), (_, _, wrap) in zip(saved, patches):
        setattr(cls, n, wrap(f))
    try:
        yield
    finally:
        for cls, n, f in saved:
            setattr(cls, n, f)


def _first_call(got, name):
    """A wrap for _patched that notes the time of the first call in `got`."""
    def wrap(f):
        def call(self, *a, **kw):
            got.setdefault(name, time.monotonic())
            return f(self, *a, **kw)
        return call
    return wrap


def _pin_after(why):
    """A wrap for _patched: after each call, the active StepRecorder and
    SuperstepRecorder keep the next engine step or super-step, under the
    reason why(self, *args) if there is one."""
    def wrap(f):
        def call(self, *a, **kw):
            r = f(self, *a, **kw)
            w = why(self, *a, **kw)
            for rec in (StepRecorder.active, SuperstepRecorder.active):
                if w and rec is not None:
                    rec.pin(w)
            return r
        return call
    return wrap


def pinned_faults():
    """The engine step just after each bulk start ("bulk_start", or
    "restart" on an address that stopped before under the same recorder),
    host stop ("stopped"), partition ("partitioned") and local drop hook
    ("drops") is kept."""
    from dragonboat_tpu_torch.engine.vector import VectorEngine
    from dragonboat_tpu_torch.nodehost import NodeHost

    seen = [None, set()]  # the recorder, the addresses stopped under it

    def stopped():
        if seen[0] is not StepRecorder.active:
            seen[:] = [StepRecorder.active, set()]
        return seen[1]

    def on_stop(nh):
        stopped().add(nh.raft_address())
        return "stopped"

    def on_start(nh, *_):
        return "restart" if nh.raft_address() in stopped() else "bulk_start"

    return _patched((
        (NodeHost, "start_clusters", _pin_after(on_start)),
        (NodeHost, "stop", _pin_after(on_stop)),
        (NodeHost, "set_partitioned", _pin_after(lambda nh, on: "partitioned" if on else None)),
        (VectorEngine, "set_local_drop_hook", _pin_after(lambda e, h: "drops" if h else None))))


def _activation_batches():
    from dragonboat_tpu_torch.engine import vector

    return {"batches": sum(vector.ACTIVATIONS.values()),
            "by_size": {str(k): v for k, v in sorted(vector.ACTIVATIONS.items())}}


def _elect_all(nh, groups, timeout_s):
    """Seconds until every group of `nh`'s core has a leader (or the
    timeout), and the leaders."""
    t0 = time.monotonic()
    leaders = {}
    while len(leaders) < groups and time.monotonic() - t0 < timeout_s:
        leaders = _leaders(nh)
        if len(leaders) < groups:
            time.sleep(0.05)
    return time.monotonic() - t0, leaders


def scen_bulk_fleet(workdir, device):
    """tests/test_bring_up.py's test_bulk_fleet_bring_up: 2,048
    single-replica groups through one start_clusters call (W=64, inbox 4,
    16 entries a message, 10 ms ticks), every group elected within 120 s
    and led by its only replica, a proposal commits. Also the seconds from
    start_clusters to the test's first proposal, which it makes once every
    group has a leader, and the activation batches of the bring-up."""
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.nodehost import NodeHost

    B = _reference("test_bring_up", device)
    out, t = {"verdicts": {}}, {}
    vector.ACTIVATIONS.clear()
    with _patched([(NodeHost, n, _first_call(t, n)) for n in ("start_clusters", "sync_propose")]):
        _held(out, "test_bulk_fleet_bring_up", B.test_bulk_fleet_bring_up, pathlib.Path(workdir))
    out["groups"] = out["lanes"] = FLEET_GROUPS
    out["activation"] = _activation_batches()
    out["elect_all_s"] = round(t["sync_propose"] - t["start_clusters"], 3) if len(t) == 2 else None
    return out


ACT_HELD = 4  # activation batches of a bulk start held against the plain version


@contextlib.contextmanager
def held_activations(cap=ACT_HELD):
    """The first `cap` activation batches of the block
    (VectorEngine._activate_rows), each held against the plain version:
    the shard's state is cloned before the batch runs, the plain version
    (activate_lanes_reference) writes the same lanes and values, built
    column by column, into the clone, and the state just after the batch
    is cloned too; the clones are compared after the block, off the
    engine's loop. Yields {"batches": [{lanes, bucket, mismatched_planes}]}."""
    from dragonboat_tpu_torch.engine.vector import (
        VectorEngine,
        activate_lanes_reference,
        activation_bucket,
    )
    from dragonboat_tpu_torch.ops.kernel import clone_state

    kept, got = [], {"batches": []}

    def wrap(f):
        def call(self, sh, rows, vals):
            if len(kept) >= cap:
                return f(self, sh, rows, vals)
            bucket = activation_bucket(len(vals), sh.hi - sh.lo)
            with sh.on():
                gi, v = _act_plain_inputs(rows, vals, bucket, sh.device)
                want = activate_lanes_reference(clone_state(sh.state), gi, v)
            f(self, sh, rows, vals)
            with sh.on():
                kept.append((len(rows), bucket, want, clone_state(sh.state)))
        return call

    try:
        with _patched([(VectorEngine, "_activate_rows", wrap)]):
            yield got
    finally:
        for n, bucket, want, after in kept:
            got["batches"].append({"lanes": n, "bucket": bucket,
                                   "mismatched_planes": act_mismatches(want, after)[0]})


def scen_bulk_shared(workdir, device, groups):
    """(f) at WIDE_GROUPS' width: `groups` groups x 3 replicas on one shared
    core (phase 11's host and group shapes, metrics on), each of the 3
    hosts calling start_clusters once, every group elected within 120 s.
    Then tests/test_observability.py's census-and-counter and history-gauge
    bodies on that core (the census read from the engine's device): the
    hosts take the observability fixture's addresses (obs<n>:1), which the
    history body reads back."""
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.transport.loopback import _Registry

    O = _reference("test_observability", device)
    reg, kv = _Registry(), _kv_sm()
    addrs = {n: f"obs{n}:1" for n in (1, 2, 3)}
    hosts = {}
    try:
        for n in (1, 2, 3):
            hosts[n] = _scen_host("obs", n, reg, workdir, groups, device, enable_metrics=True)
        vector.ACTIVATIONS.clear()
        t0 = time.monotonic()
        with held_activations() as held:
            for n, nh in hosts.items():
                nh.start_clusters([(dict(addrs), False, lambda c, _n: kv(), _scen_cfg(n, c))
                                   for c in range(1, groups + 1)])
            start_s = time.monotonic() - t0
            elect_s, leaders = _elect_all(hosts[1], groups, FLEET_ELECT_S - start_s)
        act = _activation_batches()
        log("bulk activation held: " + json.dumps({
            **held, "mismatched_planes": sum(len(b["mismatched_planes"]) for b in held["batches"]),
            "of_batches": act["batches"]}))
        out = {"groups": groups, "lanes": 3 * groups, "start_clusters_s": round(start_s, 3),
               "elect_all_s": round(start_s + elect_s, 3), "activation": act,
               "activation_held": held,
               "verdicts": {"every_group_elected": len(leaders) == groups,
                            "first_activation_batches_equal_plain": (
                                len(held["batches"]) == min(ACT_HELD, act["batches"])
                                and not any(b["mismatched_planes"] for b in held["batches"])),
                            "census_from_engine_device": (hosts[1].engine.core.device.type
                                                          == torch.device(device).type)}}
        if 1 in leaders:
            _held(out, "test_census_and_counter_gauges_in_exposition",
                  O.test_census_and_counter_gauges_in_exposition, hosts[leaders[1]])
        _held(out, "test_history_gauges_in_exposition", O.test_history_gauges_in_exposition,
              hosts[1])
        return out
    finally:
        for nh in hosts.values():
            nh.stop()


def scen_bulk_restart(workdir, device):
    """tests/test_bring_up.py's test_bulk_start_matches_incremental: two
    groups started in bulk commit a proposal each; restarted one by one
    through start_cluster, whose bootstrap check must accept the bulk
    start's records, they replay it."""
    B = _reference("test_bring_up", device)
    out = {"groups": 2, "lanes": 2, "verdicts": {}}
    _held(out, "test_bulk_start_matches_incremental", B.test_bulk_start_matches_incremental,
          pathlib.Path(workdir))
    return out


OBSERVABILITY_TESTS = ("test_e2e_latency_histograms_and_step_stats",
                       "test_census_and_counter_gauges_in_exposition",
                       "test_history_gauges_in_exposition")


def scen_observability(workdir, device):
    """tests/test_observability.py's single_host fixture (8 lanes, W=64,
    5 ms ticks, WAL-backed, every request sampled), set up anew for each
    of its three engine tests: the commit, apply, read and fsync
    histograms, step_stats and the engine_step_* gauges in a conformant
    exposition; the census and counter gauges; the history gauges and the
    history ring."""
    O = _reference("test_observability", device)
    out = {"groups": 1, "lanes": 8, "verdicts": {}}
    for t in OBSERVABILITY_TESTS:
        tmp = pathlib.Path(workdir, t)
        tmp.mkdir()
        _held(out, t, _with_fixture, O.single_host, tmp, getattr(O, t))
    return out


def scen_forensics(workdir, device):
    """tests/test_forensics.py's test_e2e_causal_chain_across_nodes_under_
    partition: 3 hosts sharing one core (16 lanes each, W=64, 5 ms ticks,
    every request traced), the seeded partition schedule (seed 1789),
    heal, a proposal commits; one trace's propose_enqueue, replicate_send,
    quorum_commit and proposal_applied in that order across at least 2
    nodes in the merged dumps, rendered by the timeline CLI. The port's
    flight recorder is emptied first, as the test suite's conftest does."""
    from dragonboat_tpu_torch.trace import flight_recorder

    F = _reference("test_forensics", device)
    flight_recorder().reset()
    out = {"groups": 1, "lanes": 3, "verdicts": {}}
    _held(out, "test_e2e_causal_chain_across_nodes_under_partition",
          F.test_e2e_causal_chain_across_nodes_under_partition, pathlib.Path(workdir))
    return out


def scen_scale(workdir, device):
    """tests/test_vector_scale.py's test_1024_lanes_elect_and_commit: 1,024
    single-replica lanes (2 ms ticks) elect within 150 s and commit one
    proposal each, all in flight."""
    S = _reference("test_vector_scale", device)
    out = {"groups": 1024, "lanes": 1024, "verdicts": {}}
    _held(out, "test_1024_lanes_elect_and_commit", S.test_1024_lanes_elect_and_commit)
    return out


def scen_quiesce(workdir, device):
    """tests/test_vector_scale.py's test_idle_quiesced_lanes_cost_no_host_work:
    256 lanes with quiesce on commit a proposal each and freeze, the
    transport sees no traffic over an idle second, a proposal wakes its
    lane and commits. Also the step launches over that second (0: the
    engine skips a fully-quiesced fleet) and after it, and the step that
    wakes the lane kept, so that the kernel is held on quiesced lanes."""
    from dragonboat_tpu_torch.ops import cuda, kernel as K

    S = _reference("test_vector_scale", device)
    steps = lambda: cuda.LAUNCHES["step_batch"] + K.REFERENCE_CALLS["step_batch"]
    idle = []

    class Clock(types.ModuleType):
        """The copy's `time`: its one sleep of a second is the idle one."""

        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def sleep(s):
            before = steps()
            time.sleep(s)
            if s >= 1.0:
                idle.append((before, steps()))
                StepRecorder.active.pin("wake")

    out = {"groups": 256, "lanes": 256, "verdicts": {}}
    S.time = Clock("time")
    try:
        _held(out, "test_idle_quiesced_lanes_cost_no_host_work",
              S.test_idle_quiesced_lanes_cost_no_host_work)
    finally:
        S.time = time
    wake = [st for why, (st, *_) in StepRecorder.active.pinned if "wake" in why.split("+")]
    out["idle_second_steps"] = [b - a for a, b in idle]
    out["wake_steps"] = steps() - idle[-1][1] if idle else 0
    out["wake_state_quiesced_lanes"] = int(wake[0].quiesced.sum()) if wake else 0
    out["verdicts"].update({"no_step_in_idle_second": out["idle_second_steps"] == [0],
                            "steps_after_wake": out["wake_steps"] > 0,
                            "wake_state_quiesced": out["wake_state_quiesced_lanes"] > 0})
    return out


# phase 12's chaos at vector scale runs at 512 x 3 lanes (1,024 x 3 until
# phase 13's rebase_wide took its seconds: the script's time limit)
CHAOS_SCALE_GROUPS = 512


def scen_chaos_scale(workdir, device, groups=None):
    """tests/test_chaos_scale.py's test_chaos_at_vector_scale at `groups`
    groups x 3 replicas on one shared core (its GROUPS set on the copy),
    and at no fewer than its own 256 x 3: W=128, 10 ms ticks, seed
    0xC0FFEE, 25 s of faults (a quarter of co-hosted replication dropped,
    host partitions, NodeHost kills and restarts from their directories)
    under sampled and bulk clients, heal, a final write on every group;
    every group's replicas
    at one applied index and SM hash, the sampled histories linearizable,
    their persisted logs obeying Log Matching below the commit point."""
    C = _reference("test_chaos_scale", device)
    width = C.GROUPS
    C.GROUPS = max(groups or 0, width)
    out = {"groups": C.GROUPS, "lanes": 3 * C.GROUPS, "seed": hex(C.SEED), "verdicts": {}}
    try:
        _held(out, "test_chaos_at_vector_scale", C.test_chaos_at_vector_scale,
              pathlib.Path(workdir))
    finally:
        C.GROUPS = width
    return out


FLEET_SCENARIOS = (
    ("bulk_fleet", lambda d, dev, g: scen_bulk_fleet(d, dev)),
    ("bulk_shared_3x", lambda d, dev, g: scen_bulk_shared(d, dev, g)),
    ("bulk_restart", lambda d, dev, g: scen_bulk_restart(d, dev)),
    ("observability", lambda d, dev, g: scen_observability(d, dev)),
    ("forensics", lambda d, dev, g: scen_forensics(d, dev)),
    ("scale", lambda d, dev, g: scen_scale(d, dev)),
    ("quiesce", lambda d, dev, g: scen_quiesce(d, dev)),
    ("chaos_scale", lambda d, dev, g: scen_chaos_scale(d, dev, min(g, CHAOS_SCALE_GROUPS))),
)


def phase_fleet(cuda, K, card, device="cuda", groups=WIDE_GROUPS):
    """Phase 12: the reference's last five engine-level test files' bodies
    on the port's NodeHost on `device` (FLEET_SCENARIOS, through
    run_scenarios, each at its test's shape; (f) also, and (j) only, with
    `groups` groups x 3 replicas, WIDE_GROUPS by default): bulk fleet
    bring-up and restart, observability, forensics, vector scale and chaos
    at vector scale. The kernel is held on the steps each run recorded
    and on those just after bulk starts, host stops and restarts,
    partitions, drops and the wake from quiesce."""
    t_phase = time.perf_counter()
    log(f"phase 12 card: {card}")
    before = set(sys.modules)
    with pinned_faults():
        out = run_scenarios(cuda, K, card, FLEET_SCENARIOS, 1200, device, groups)
    bad = sorted(m for m in set(sys.modules) - before
                 if m.split(".")[0] in ("jax", "dragonboat_tpu"))
    assert not bad, f"phase 12 imported {bad[:5]}"
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


# ------- phase 13: the follower catch-up and the last eleven test files

# Fault 1 at config 6's width: of WIDE_GROUPS x 3 replicas on one shared
# K=8 core, CATCHUP_JOINS first commit CATCHUP_PRE entries (past the
# 256-entry window, so the joiner is caught up from the host log) and then
# add a replica on a fourth host of the core, which joins as an empty member
CATCHUP_JOINS = 32
CATCHUP_PRE = 300
CATCHUP_JOINER = 4  # the joiners' node id (tests/torch_catchup.py)
CATCHUP_PIN_CAP = 8  # states kept after each kind of catch-up event

# tests/<file>.py and its bodies that drive the vector engine, NodeHost or
# LoopbackCluster: (test, its parameters after tmp_path)
CATCHUP_FILES = (
    ("restart", "test_restart", (
        ("test_stop_restart_cluster_rejoins_live_group", "vector"),
        ("test_crash_restart_with_snapshot_install", "vector"),
        ("test_crash_restart_cycles_every_node", "vector"),
        ("test_vector_lane_reuse_50_restarts_no_growth",),
        ("test_quorum_throughput_and_fairness_while_peer_down",))),
    ("propose_batch", "test_propose_batch", (
        ("test_propose_batch_commits_in_order", "vector"),
        ("test_propose_batch_async_handle", "vector"))),
    ("snapshotstate", "test_snapshotstate", (
        ("test_duplicate_snapshot_request_ignored", "vector"),)),
    ("snapshot_files", "test_snapshot_files", (
        ("test_external_files_transfer_on_install",),
        ("test_external_files_survive_local_restart",))),
    ("compression", "test_compression", (
        ("test_e2e_compressed_propose_apply_and_restart",),)),
    ("rate_limit", "test_rate_limit", (("test_nodehost_rate_limit_e2e", "vector"),)),
    ("storage", "test_storage", (("test_nodehost_on_sqlite_backend_restart",),)),
    ("chaos", "test_chaos", (("test_chaos_linearizable_and_converged", "vector"),)),
    # the LoopbackCluster body steps no engine: it runs beside two that do
    ("fairness_events_reads", ("test_fairness", "test_events", "test_readindex_tracker"), (
        ("test_tick_burst_clamp_preserves_election_spread",),
        ("test_nodehost_exports_starvation_gauges",),
        ("test_nodehost_health_metrics_end_to_end",),
        ("test_full_width_ctx_no_collision_kernel",))),
)


# reads of the allocated memory, 2 ms apart: a sample is their least. A
# step's tensors, or a restart's, can stay alive for tens of ms after the
# drain (10 reads kept such transients, 512 and 56,832 B above the
# resident memory, in two of four runs on the card); 50 reads span 100 ms
LANE_MEMORY_SAMPLES = 50


def _lane_memory(got):
    """A wrap for _patched: the card's allocated memory into `got` with the
    engine drained, before a stop or crash and after a restart: the least
    of LANE_MEMORY_SAMPLES reads 2 ms apart, as the loop keeps stepping
    the core's live lane and holds a step's tensors while it runs."""
    def sample(nh):
        nh.engine.core.drain()
        least = None
        for _ in range(LANE_MEMORY_SAMPLES):
            torch.cuda.synchronize()
            m = torch.cuda.memory_allocated()
            least = m if least is None else min(least, m)
            time.sleep(0.002)
        return least

    def wrap(f):
        def call(self, *a, **kw):
            if f.__name__ != "restart_cluster":
                got.append(("before_" + f.__name__, sample(self)))
            r = f(self, *a, **kw)
            if f.__name__ == "restart_cluster":
                got.append(("after_restart", sample(self)))
            return r
        return call
    return wrap


def scen_files(workdir, device, name, files, bodies):
    """The reference bodies of tests/<files>.py on the port with their
    engines on `device`, each in a directory of its own, at its test's
    shapes, ticks and seeds. On the card the 50-restart body also holds
    the card's allocated memory from growing: sampled before every stop
    or crash and after every restart, the last ten cycles hold no more
    than the first ten."""
    import inspect

    from dragonboat_tpu_torch.nodehost import NodeHost

    mods = [_reference(f, device) for f in ((files,) if isinstance(files, str) else files)]
    out = {"file": files, "verdicts": {}}
    for test, *params in bodies:
        M = next(m for m in mods if hasattr(m, test))
        fn = getattr(M, test)
        args = list(params)
        if "tmp_path" in inspect.signature(fn).parameters:
            d = pathlib.Path(workdir) / test
            d.mkdir()
            args.insert(0, d)
        fixture = getattr(M, "_clear", None)  # test_compression's autouse fixture
        with contextlib.contextmanager(fixture.__wrapped__)() if fixture else \
                contextlib.nullcontext():
            if test == "test_nodehost_rate_limit_e2e":
                # ROADMAP §3 fault 16: the in-memory log size the burst
                # reached beside max_in_mem_log_size, on a line of its own
                with _tests_module("torch_twin").in_mem_log_watch() as got:
                    _held(out, test, fn, *args)
                out["in_mem_log"] = got
                log(f"rate limit burst: {json.dumps({**got, 'passed': out['verdicts'][test]})}")
                continue
            if test != "test_vector_lane_reuse_50_restarts_no_growth" or device != "cuda":
                _held(out, test, fn, *args)
                continue
            mem = []
            with _patched([(NodeHost, n, _lane_memory(mem))
                           for n in ("stop_cluster", "crash_cluster", "restart_cluster")]):
                _held(out, test, fn, *args)
            vals = [v for _w, v in mem]
            out["lane_reuse_memory"] = {
                "before": vals[0], "after": vals[-1], "min": min(vals), "max": max(vals),
                "first_10_cycles_max": max(vals[:20]), "last_10_cycles_max": max(vals[-20:]),
                "samples": len(vals),
                "distinct": {w: sorted({v for x, v in mem if x == w}) for w, _ in mem}}
            out["verdicts"]["device_memory_no_growth_over_50_restarts"] = (
                len(vals) == 100 and max(vals[-20:]) <= max(vals[:20]))
    return out


def scen_join(workdir, device, groups):
    """ROADMAP §3 fault 1 at config 6's engine shape: `groups` groups x 3
    replicas on one shared core (K=8, W=256, inbox 4, 64 entries a
    message, 10 ms ticks, phase 11's election and heartbeat), of which
    CATCHUP_JOINS commit CATCHUP_PRE entries, then each add a replica on a
    fourth host of the core that starts with join=True. Every joiner is
    caught up from its leader's host log to the leader's last index, a
    proposal after the join applies on all four replicas, and the routing
    table never routes to a lane that keeps its sender at another slot."""
    C = _tests_module("torch_catchup")
    r = C.join_shared_core(
        "dragonboat_tpu_torch", workdir, groups=groups, joins=min(CATCHUP_JOINS, groups),
        window=256, steps=8, election=SCEN_ELECTION,
        heartbeat=SCEN_HEARTBEAT, pre_entries=CATCHUP_PRE, inbox_depth=4, entries_per_msg=64,
        device=device, elect_s=FLEET_ELECT_S, catch_s=60.0)
    r["verdicts"]["host_log_catchup_for_every_joiner"] = (
        r["catchup"]["catchup_starts"] >= r["joins"])
    r["verdicts"]["no_route_to_a_slot_the_destination_lacks"] = r["catchup"]["misrouted"] == 0
    return r


def scen_retry_storm(workdir, device):
    """ROADMAP §3 fault 6 (tests/test_torch_catchup_storm.py's recipe at
    seed 3): 4 groups x 3 replicas on one core, W=32, 5 ms ticks,
    election 50 / heartbeat 5, clients resubmitting on a 0.5 s timeout,
    30% of co-hosted messages dropped and one host stalled for seeded
    windows over 8 s; every group commits again within 30 s, its replicas
    converge, and no catch-up asks for a snapshot that cannot exist."""
    C = _tests_module("torch_catchup")
    r = C.retry_storm("dragonboat_tpu_torch", workdir, seed=3, device=device)
    r["verdicts"]["host_log_catchups"] = r["catchup"]["catchup_starts"] > 0
    r["verdicts"]["no_snapshot_requested_without_one"] = r["catchup"]["no_snapshot"] == 0
    return r


REBASE_THRESHOLD = 32  # fault 11's recipe: a window base that moves past 48 entries


@contextlib.contextmanager
def _rebase_at(threshold):
    """engine.vector._REBASE_THRESHOLD set to `threshold` during the block."""
    from dragonboat_tpu_torch.engine import vector

    saved = vector._REBASE_THRESHOLD
    vector._REBASE_THRESHOLD = threshold
    try:
        yield
    finally:
        vector._REBASE_THRESHOLD = saved


def _joiner_verdicts(r, got):
    """The save verdicts of ROADMAP §3 fault 11 on the joiners' lanes."""
    r.update(joiner_saves={k: got[k] for k in ("persisted", "acks", "wide_saves")},
             wide_save_notes=got["wide_save_notes"][:4],
             acked_unpersisted=got["acked_unpersisted"][:8],
             missing_saves=got["missing_saves"][:8])
    r["verdicts"].update(
        no_ack_above_persisted=not got["acked_unpersisted"],
        no_save_without_payload=not got["missing_saves"])


def scen_rebased(workdir, device):
    """ROADMAP §3 fault 11 (tests/test_torch_catchup_storm.py's rebased
    window): 4 groups x 3 replicas, each host on its own core, K=1, W=32,
    the rebase threshold lowered to 32, 48 entries, then 2 groups each add
    a member that joins empty and is caught up from its leader's host log
    below the rebased base. Every joiner reaches its leader's index; each
    ack a joiner sends is at or below what it has persisted, and no save
    lacks a payload."""
    C = _tests_module("torch_catchup")
    L = _tests_module("torch_log_hole")
    with _rebase_at(REBASE_THRESHOLD), \
            L._joiner_watch("dragonboat_tpu_torch", CATCHUP_JOINER) as got:
        r = C.join_shared_core("dragonboat_tpu_torch", workdir, shared=False, steps=1,
                               device=device)
    r["verdicts"]["below_window_rejects_served"] = (
        r["catchup"]["below_window_rejects"] >= r["joins"])
    r["verdicts"]["no_snapshot_requested_without_one"] = r["catchup"]["no_snapshot"] == 0
    _joiner_verdicts(r, got)
    return r


def scen_rebased_overflow(workdir, device):
    """The same window (2 groups joined) with the joiner's inbox held from
    its leaders' first below-window reject until they have sent it past
    the 48 entries, so its inbox piles up 32-entry catch-up runs and one
    step accepts more entries than its 32-slot arena ring
    (tests/torch_log_hole.py:rebased_overflow). The arena holds every
    entry to its save: the joiners are caught up, every ack is persisted,
    and the watch's notes name the wide saves (per step since the lane's
    last save: its packed inbox slots, rep_base and last_index)."""
    L = _tests_module("torch_log_hole")
    with _rebase_at(REBASE_THRESHOLD):
        r = L.rebased_overflow("dragonboat_tpu_torch", workdir, device=device)
    r["verdicts"]["a_step_saved_a_run_wider_than_the_window"] = r["wide_saves"] > 0
    r["verdicts"]["engine_running"] = r["engine_fault"] is None
    return r


# the window rebase at config 2's width: WIDE_GROUPS x 3 lanes on a K=1 core
# and on a shared K=8 core, the rebase threshold lowered to 2W, and
# REBASE_WIDE_HOT groups each driven past 3W committed entries (16-byte
# proposals, in two waves that the engine feeds in as the window frees),
# so their lanes rebase twice (near 512 and 768 entries, both mid-wave:
# at K=8 a hot leader then has entries to replicate through the last
# inner step); the other groups are elected and idle
REBASE_WIDE_THRESHOLD = 512
REBASE_WIDE_HOT = 32
REBASE_WIDE_WAVES = (416, 416)
REBASE_WIDE_ENTRIES = sum(REBASE_WIDE_WAVES)
REBASE_WIDE_CAP = 16  # rebases of one core held against the plain versions
# (core, steps_per_sync, inbox depth, entries a message): config 2's engine
# shape at K=1; config 6's lanes, P, W and K at K=8 with inbox 8 and 16
# entries a message, so that a hot leader takes in 128 entries a
# super-step and replicates them 16 an inner step through the last one,
# which parks rows in the residual inbox (at config 6's inbox 4 and 64
# entries a message its 256 go out in the first four inner steps and no
# rebase finds parked rows)
REBASE_WIDE_CORES = (("k1", 1, 4, 64), ("k8", 8, 8, 16))


@contextlib.contextmanager
def _held_rebases(kept, counts, core):
    """During the block, engine.vector.rebase_lanes keeps, on the shard's
    stream, copies of the state, the residual inbox and the delta before
    each of the first REBASE_WIDE_CAP calls of core["name"], and of the
    state and residual inbox after it; every call is counted, with and
    without a residual inbox."""
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.ops.kernel import clone_state

    def held(f):
        def call(s, delta, resid=None):
            name = core["name"]
            c = counts.setdefault(name, {"calls": 0, "with_resid": 0})
            c["calls"] += 1
            c["with_resid"] += resid is not None
            hold = sum(k[0] == name for k in kept) < REBASE_WIDE_CAP
            copy = lambda t: None if t is None else clone_state(t)
            if hold:
                before = (clone_state(s), copy(resid), delta.clone())
            out = f(s, delta, resid)
            if hold:
                kept.append((name, *before, clone_state(out), copy(resid)))
            return out
        return call

    with _patched([(vector, "rebase_lanes", held)]):
        yield


def _rebase_wide_core(workdir, device, groups, name, k, depth, entries_per_msg):
    """One core of scen_rebase_wide: 3 hosts, every group elected, the hot
    groups' load in REBASE_WIDE_WAVES, then one more proposal a hot group;
    the seconds of each part, the proposals that did not complete and the
    hot groups whose replicas agree."""
    from dragonboat_tpu_torch.config import EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    kv, reg = _kv_sm(), _Registry()
    addrs = {n: f"rw{name}{n}:1" for n in (1, 2, 3)}
    hot = range(1, min(REBASE_WIDE_HOT, groups) + 1)
    hosts, r = {}, {"lanes": 3 * groups, "inbox_depth": depth, "entries_per_msg": entries_per_msg}
    try:
        for n in (1, 2, 3):
            hosts[n] = NodeHost(NodeHostConfig(
                deployment_id=13, rtt_millisecond=SCEN_RTT_MS, nodehost_dir=f"{workdir}/{name}{n}",
                raft_address=addrs[n], raft_rpc_factory=lambda a: loopback_factory(a, reg),
                engine=EngineConfig(kind="vector", max_groups=3 * groups, max_peers=4,
                                    log_window=256, inbox_depth=depth,
                                    max_entries_per_msg=entries_per_msg, steps_per_sync=k,
                                    share_scope=f"chip-rw{name}-{id(reg)}", device=device)))
        t0 = time.monotonic()
        for n, nh in hosts.items():
            nh.start_clusters([(dict(addrs), False, lambda c, _n: kv(), _scen_cfg(n, c))
                               for c in range(1, groups + 1)])
        elect_s, leaders = _elect_all(hosts[1], groups, FLEET_ELECT_S)
        r.update(elect_all_s=round(time.monotonic() - t0, 3), elected=len(leaders))
        t1, missed = time.monotonic(), 0

        def wave(keys):
            pending = []
            for c in hot:
                lead = _leaders(hosts[1]).get(c) or leaders.get(c, 1)
                nh = hosts[lead]
                pending.append(nh.propose_batch_async(
                    nh.get_noop_session(c), [f"{x}={c}".encode() for x in keys], 60.0))
            done = 0
            for h in pending:
                h.wait(65.0)
                done += h.completed
            return len(pending) * len(keys) - done

        j = 0
        for n in REBASE_WIDE_WAVES:
            missed += wave([f"k{x}" for x in range(j, j + n)])
            j += n
        r["load_s"] = round(time.monotonic() - t1, 3)
        r["missed_proposals"] = missed
        r["last_missed"] = wave(["last"])
        deadline, agree = time.monotonic() + 30.0, 0
        while True:
            agree = sum(len({(nh.get_applied_index(c), nh.get_sm_hash(c))
                             for nh in hosts.values()}) == 1 for c in hot)
            if agree == len(hot) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        r["hot_groups_converged"] = agree
        r["hot_applied_min"] = min(hosts[1].get_applied_index(c) for c in hot)
        r["seconds"] = round(time.monotonic() - t0, 3)
        return r
    finally:
        for nh in hosts.values():
            nh.stop()


def scen_rebase_wide(workdir, device, groups):
    """The engine's window rebase (csrc/rebase.cu, through
    VectorEngine._do_rebase and engine.vector.rebase_lanes) at config 2's
    width: `groups` x 3 lanes on a K=1 core of config 2's engine shape and
    on a shared K=8 core (REBASE_WIDE_CORES), one after the other, the rebase
    threshold lowered to REBASE_WIDE_THRESHOLD, REBASE_WIDE_HOT groups each
    committing REBASE_WIDE_ENTRIES 16-byte proposals and one more. Each
    rebase keeps the state (and at K=8 the residual inbox) before it; after
    the cores stop, the plain versions run on those copies and must equal
    what the kernel left, on every plane. Verdicts: a rebase at K=1 and one
    with parked residual rows at K=8 (on the card, each call one launch of
    the kernel), 0 mismatched fields, every hot group committing after its
    last rebase and its replicas converged; phase 13's watches add no log
    hole and no save without its payload."""
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.ops import cuda
    from dragonboat_tpu_torch.ops.state import rebase

    kept, counts, core = [], {}, {"name": None}
    out = {"groups": groups, "lanes": 3 * groups, "hot": min(REBASE_WIDE_HOT, groups),
           "entries_per_hot_group": REBASE_WIDE_ENTRIES + 1}
    before = cuda.LAUNCHES["rebase"]
    with _rebase_at(REBASE_WIDE_THRESHOLD), _held_rebases(kept, counts, core):
        for name, *shape in REBASE_WIDE_CORES:
            core["name"] = name
            out[name] = _rebase_wide_core(workdir, device, groups, name, *shape)
            out[name].update(counts.get(name, {"calls": 0, "with_resid": 0}))
    out["rebase_launches"] = cuda.LAUNCHES["rebase"] - before
    bad, err = set(), 0
    for name, s, resid, delta, after, after_r in kept:
        want = rebase(s, delta)
        b, e = act_mismatches(want, after)
        if resid is not None:
            vector.rebase_resid(resid, delta)
            br, er = act_mismatches(resid, after_r)
            b, e = b + ["resid." + f for f in br], max(e, er)
        bad |= {f"{name}.{f}" for f in b}
        err = max(err, e)
    out["held"] = {n: sum(x[0] == n for x in kept) for n, *_x in REBASE_WIDE_CORES}
    out["held_with_resid"] = sum(x[2] is not None for x in kept)
    out["mismatched_fields"], out["max_abs_err"] = sorted(bad), err
    on_card = device == "cuda"
    k1, k8 = out["k1"], out["k8"]
    calls = k1["calls"] + k8["calls"]
    out["verdicts"] = {
        "every_group_elected": k1["elected"] == groups and k8["elected"] == groups,
        "k1_rebased": k1["calls"] >= 1,
        "k8_rebased_with_parked_rows": k8["with_resid"] >= 1,
        # on the card every call is one launch of the kernel
        "one_launch_a_call": out["rebase_launches"] == (calls if on_card else 0),
        "rebases_equal_plain": not bad and len(kept) >= 2,
        "hot_groups_committed_after_the_last_rebase": all(
            out[n]["missed_proposals"] == 0 and out[n]["last_missed"] == 0
            and out[n]["hot_applied_min"] > REBASE_WIDE_ENTRIES for n in ("k1", "k8")),
        "replicas_converged": all(out[n]["hot_groups_converged"] == out["hot"]
                                  for n in ("k1", "k8")),
    }
    return out


def scen_install_interleaving(workdir, device, kind):
    """ROADMAP §3 fault 9 (tests/torch_log_hole.py:install_interleaving)
    on `kind`'s engine: a follower restarted behind a compacted log gets a
    snapshot whose recovery the gate holds while the leader commits above
    it. Every replica converges to one applied index and state machine
    hash, and only the thread that applied the install (the scalar step
    worker, the vector engine's loop) moves the follower's log window."""
    L = _tests_module("torch_log_hole")
    r = L.install_interleaving("dragonboat_tpu_torch", workdir, kind, device=device)
    r["verdicts"]["window_moved_by_the_install_only"] = not L.worker_window_moves(r)
    if kind == "scalar":
        r["verdicts"]["appended_above_the_install_while_held"] = (
            r["appended_past_install_while_held"] >= 2)
    return r


# scenarios of the scalar engine: no kernel runs in them
HOST_ONLY_SCENARIOS = {"install_scalar"}

CATCHUP_SCENARIOS = (
    ("join_shared_k8", lambda d, dev, g: scen_join(d, dev, g)),
    ("retry_storm", lambda d, dev, g: scen_retry_storm(d, dev)),
    ("rebased_window", lambda d, dev, g: scen_rebased(d, dev)),
    ("rebased_overflow", lambda d, dev, g: scen_rebased_overflow(d, dev)),
    ("rebase_wide", lambda d, dev, g: scen_rebase_wide(d, dev, g)),
    ("install_scalar", lambda d, dev, g: scen_install_interleaving(d, dev, "scalar")),
    ("install_vector", lambda d, dev, g: scen_install_interleaving(d, dev, "vector")),
) + tuple(
    (name, lambda d, dev, g, f=files, b=bodies, n=name: scen_files(d, dev, n, f, b))
    for name, files, bodies in CATCHUP_FILES)


# ROADMAP §3 fault 13: three start/stop cycles of each shape in one process
# (name, steps_per_sync, one core shared by the three hosts, logical shards)
TEARDOWN_SHAPES = (("sole_k1", 1, False, 0), ("shared_k8", 8, True, 0),
                   ("shared_k8_4_shards", 8, True, 4))
TEARDOWN_GROUPS = 32
TEARDOWN_CYCLES = 3
TEARDOWN_RTT_MS = 5  # elections of 20 ticks, heartbeats of 2


def _allocated(device):
    """The card's allocated bytes once every queued kernel ran; None on the
    CPU."""
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _live_blocks():
    """address -> (bytes, allocating frames) of every allocated block on the
    card (torch.cuda.memory._snapshot; frames only where the memory
    history records them, as tree_probe.py's teardown does)."""
    out = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                frames = [f"{pathlib.Path(f['filename']).name}:{f['line']}:{f['name']}"
                          for f in b.get("frames", ())
                          if "dragonboat_tpu_torch" in f["filename"]
                          or f["filename"].endswith("chip_smoke.py")]
                out[b["address"]] = (b["size"], frames[:4])
    return out


def teardown_cycles(device, card, shapes=TEARDOWN_SHAPES, groups=TEARDOWN_GROUPS,
                    cycles=TEARDOWN_CYCLES, workdir=None):
    """ROADMAP §3 fault 13 on `device`: for each shape, `cycles` start/stop
    cycles in this process of 3 NodeHosts x `groups` groups (each host its
    own K=1 engine, or one core shared by the three at K=8, also over 4
    logical shards of the card), each cycle electing every group and
    committing a proposal before every host stops. On the card the
    allocated bytes are read before the first start and after each stop,
    first before and then after a full collection; where a stop left
    bytes, the blocks it left are summed by allocating frame
    (`left_by_stop`). `device_memory_freed_on_stop` holds for a shape when
    every read after a stop, before the collection and after it, equals the
    read before the first start: a stop frees what the engine allocated,
    without waiting for the cycle collector, and no block is kept once per
    process (PERF.md §7)."""
    import gc
    import tempfile

    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    t0 = time.perf_counter()
    out = {"groups": groups, "cycles": cycles, "card": card}
    for name, steps, shared, shards in shapes:
        gc.collect()
        before = _allocated(device)
        base = _live_blocks() if device == "cuda" else {}
        rec = {"before": before, "after_no_collect": [], "after": []}
        orig = vector.mesh_devices
        if shards:
            vector.mesh_devices = lambda d, n=shards: (d,) * n
        try:
            for cycle in range(cycles):
                reg, kv, hosts = _Registry(), _kv_sm(), {}
                addrs = {n: f"td{n}:1" for n in (1, 2, 3)}
                with tempfile.TemporaryDirectory(prefix="dbtorch-teardown-", dir=workdir) as d:
                    try:
                        for n in addrs:
                            hosts[n] = NodeHost(NodeHostConfig(
                                deployment_id=13, rtt_millisecond=TEARDOWN_RTT_MS,
                                nodehost_dir=f"{d}/td{n}", raft_address=addrs[n],
                                raft_rpc_factory=lambda a: loopback_factory(a, reg),
                                engine=EngineConfig(
                                    kind="vector", max_groups=(3 if shared else 1) * groups,
                                    max_peers=4, log_window=256, inbox_depth=4,
                                    max_entries_per_msg=64, steps_per_sync=steps,
                                    share_scope=f"teardown-{name}-{cycle}" if shared else None,
                                    shard_over_mesh=bool(shards), device=device)))
                        for n, nh in hosts.items():
                            nh.start_clusters([
                                (dict(addrs), False, lambda c, _n: kv(),
                                 Config(cluster_id=c, node_id=n, election_rtt=20,
                                        heartbeat_rtt=2))
                                for c in range(1, groups + 1)])
                        _s, leaders = _elect_all(hosts[1], groups, FLEET_ELECT_S)
                        assert len(leaders) == groups, (
                            f"teardown {name}: {len(leaders)} of {groups} elected")
                        nh = hosts[leaders[1]]
                        nh.sync_propose(nh.get_noop_session(1), b"k=v", timeout_s=30.0)
                    finally:
                        for nh in hosts.values():
                            nh.stop()
                del hosts, nh
                left = _allocated(device)
                rec["after_no_collect"].append(left)
                if left != before:
                    sites = {}
                    for addr, (size, frames) in _live_blocks().items():
                        if addr not in base:
                            site = sites.setdefault(frames[0] if frames else "?", [0, 0])
                            site[0] += 1
                            site[1] += size
                    rec.setdefault("left_by_stop", []).append({"cycle": cycle, "sites": sites})
                gc.collect()
                rec["after"].append(_allocated(device))
        finally:
            vector.mesh_devices = orig
        if device == "cuda":
            rec["verdicts"] = {"device_memory_freed_on_stop": all(
                a == before for a in rec["after_no_collect"] + rec["after"])}
        else:
            rec["verdicts"] = {"cycles_completed": len(rec["after"]) == cycles}
        out[name] = rec
    out["seconds"] = round(time.perf_counter() - t0, 2)
    log("teardown: " + json.dumps(out, default=str))
    bad = [f"{n}.{v}" for n, *_x in shapes for v, ok in out[n]["verdicts"].items() if not ok]
    assert not bad, f"teardown: verdicts failed {bad}"
    return out


@contextlib.contextmanager
def pinned_catchup():
    """The super-step (or step) just after each joiner's first reject
    ("join_reject") and first save of entries ("join_first_save"), each
    host-log catch-up start ("catchup_start") and each below-window reject
    ("below_window_reject") is kept, up to CATCHUP_PIN_CAP of each. A
    joiner's "first" is per scenario (per StepRecorder); the yielded list
    holds every joiner's first reject of the phase."""
    from dragonboat_tpu_torch.engine.vector import MT, VectorEngine

    first = []  # (scenario number, cluster) of each joiner's first reject
    seen = {"rec": None, "n": 0, "rejects": set(), "saves": set()}

    def scenario():
        # a scenario's recorder is new: its joiners' firsts start anew
        if seen["rec"] is not StepRecorder.active:
            seen.update(rec=StepRecorder.active, n=seen["n"] + 1, rejects=set(), saves=set())
        return seen

    def join_reject(engine, lane, m, *_):
        sc = scenario()
        key = lane.node.cluster_id
        if (m.type == MT.REPLICATE_RESP and m.reject and m.from_ == CATCHUP_JOINER
                and key not in sc["rejects"]):
            sc["rejects"].add(key)
            first.append((sc["n"], key))
            return "join_reject"
        return None

    def join_save(engine, updates, lane_saves):
        sc = scenario()
        for lane, ents, _state in lane_saves:
            key = lane.node.cluster_id
            if ents and lane.node.node_id() == CATCHUP_JOINER and key not in sc["saves"]:
                sc["saves"].add(key)
                return "join_first_save"
        return None

    caps = StepRecorder.PIN_CAP, SuperstepRecorder.PIN_CAP
    StepRecorder.PIN_CAP = SuperstepRecorder.PIN_CAP = CATCHUP_PIN_CAP
    try:
        with _patched((
                (VectorEngine, "_pack_wire", _pin_after(join_reject)),
                (VectorEngine, "_commit_saves", _pin_after(join_save)),
                (VectorEngine, "_start_catchup",
                 _pin_after(lambda e, lane, p, o: "catchup_start" if p in lane.catchup
                            else None)),
                (VectorEngine, "_below_window_reject",
                 _pin_after(lambda *_: "below_window_reject")))):
            yield first
    finally:
        StepRecorder.PIN_CAP, SuperstepRecorder.PIN_CAP = caps


def phase_catchup(cuda, K, card, device="cuda", groups=WIDE_GROUPS):
    """Phase 13: the vector engine's follower catch-up on `device`, the join
    of an empty member over a shared K=8 core at config 6's engine shape (fault
    1), the retry storm (fault 6), a member caught up below a rebased
    window and the same with its inbox piled up (fault 11), a snapshot
    install whose recovery waits while the step appends on the scalar and
    the vector engine (fault 9), then the reference bodies of the last
    eleven test files that drive the vector engine (CATCHUP_FILES), all
    through run_scenarios. The kernels are held on the recorded states and
    on those just after each joiner's first reject and first save and each
    host-log catch-up start. No log reader may raise a log hole and no save
    may lack its payload anywhere in the phase."""
    t_phase = time.perf_counter()
    log(f"phase 13 card: {card}")
    before = set(sys.modules)
    L = _tests_module("torch_log_hole")
    with pinned_catchup() as rejected, L.hole_watch("dragonboat_tpu_torch") as holes:
        out = run_scenarios(cuda, K, card, CATCHUP_SCENARIOS, 1300, device, groups,
                            host_only=HOST_ONLY_SCENARIOS)
    bad = sorted(m for m in set(sys.modules) - before
                 if m.split(".")[0] in ("jax", "dragonboat_tpu"))
    assert not bad, f"phase 13 imported {bad[:5]}"
    out["joins_first_rejects"] = len(rejected)
    holes = {k: [m for _n, m in v] for k, v in holes.items()}
    out["log_holes"] = len(holes["log_holes"])
    out["missing_arena_saves"] = len(holes["missing_saves"])
    log("catchup holes: " + json.dumps({
        "log_holes": holes["log_holes"][:5], "missing_arena_saves": holes["missing_saves"][:5],
        "card": card}))
    assert not holes["log_holes"], f"phase 13: log holes {holes['log_holes'][:3]}"
    assert not holes["missing_saves"], f"phase 13: saves without a payload {holes['missing_saves'][:3]}"
    if device == "cuda":
        out["teardown"] = teardown_cycles(device, card)
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from dragonboat_tpu_torch.ops import cuda, kernel as K
    from dragonboat_tpu_torch import kernel_bench as kb

    t_run = time.perf_counter()

    def at(phase):
        # each phase's start on the run's clock, for its share of the limit
        log(f"phase {phase} starts at {time.perf_counter() - t_run:.1f} s")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 0: build ----
    at("0")
    t0 = time.perf_counter()
    cuda.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f}s")
    ptxas = cuda.kernel_resources()
    for name, r in ptxas.items():
        log(f"ptxas {name}: {r['registers']} registers, {r['stack_frame']} bytes stack frame, "
            f"{r['spill_stores']}/{r['spill_loads']} bytes spill stores/loads, "
            f"{r['smem']} bytes static shared memory")
    frames = {f"P{p}_K{k}_R{r}": cuda.step_frame_bytes(p, k, r)
              for p, k, r in ((4, 4, 4), (5, 4, 4), (8, 8, 4))}
    log(f"step_batch dynamic shared memory per block: {frames}")
    assert set(ptxas) == set(cuda._KERNELS), f"ptxas reported {sorted(ptxas)}"

    # ---- phase 1: the main path ----
    at("1")
    cfg, kept, launches = phase_cluster(K, cuda)

    # ---- phase 3 state first: the 50,000-group kernel regime ----
    at("3")
    res = kb.run_kernel_bench(BENCH_GROUPS, BENCH_STEPS, 5, 512, device="cuda")
    bcfg = res["cfg"]
    big = (bcfg, res["state"], res["inbox"], res["ticks"])

    # ---- phase 2: kernel against its plain version (P=4, P=8, P=5) ----
    at("2")
    cases, bad, err = phase_compare(K, cuda, cfg, kept, big)
    p5_cases, p5_bad, p5_err, p5_cfg, p5_last = phase_compare_p5(K, cuda, kb)
    cases += p5_cases
    bad = sorted(set(bad) | {"P5." + f for f in p5_bad})
    err = max(err, p5_err)

    # ---- timings: main-path shape, then the kernel regime ----
    def kernel_vs_plain(c, st, ib, ticks, reps_k, reps_p):
        # kernel alone (its device duration in a profiler trace):
        # parameters prepared once; before each launch the state is
        # restored, so every launch does the same work on the same input
        work = K.clone_state(st)
        params, out = cuda.prepare_step(work, ib, ticks, c)
        dev = st.term.device

        def restore():
            for a, b in zip(work, st):
                a.copy_(b)

        ms = kb.device_ms(lambda: cuda.launch_step(params, dev), restore, reps_k,
                          ["step_batch_kernel"])["step_batch_kernel"]
        # the wrapper's host part (tensor checks, parameter fill, launch
        # call) on the host clock, each call made with the card idle so no
        # queued copy overlaps it
        host = []
        for _ in range(reps_k):
            restore()
            torch.cuda.synchronize()
            t = time.perf_counter()
            cuda.step_batch_cuda(work, ib, ticks, c, out=out)
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        host_ms = sorted(host)[len(host) // 2]
        plain = time_ms(lambda: K.step_batch_reference(st, ib, ticks, c), reps_p)
        after, o = cuda.step_batch_cuda(K.clone_state(st), ib, ticks, c)
        nbytes = kb.step_bytes(st, ib, ticks, o, after)
        return ms, host_ms, plain, nbytes

    st, ib, ticks = kept[len(kept) // 2]
    ms, host_ms, plain_ms, nbytes = kernel_vs_plain(cfg, st, ib, ticks, 50, 3)
    bound_ms = nbytes / kb.HBM_BYTES_PER_S * 1e3
    log(f"step_batch @ 1024 groups (P=4 W=256 K=4 E=64): kernel {ms:.4f} ms, "
        f"wrapper host part {host_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms "
        f"({nbytes} B)")
    bms, bhost_ms, bplain_ms, bbytes = kernel_vs_plain(bcfg, *big[1:], 30, 2)
    bbound_ms = bbytes / kb.HBM_BYTES_PER_S * 1e3
    step_ms = sorted(res["step_ms"])
    log(f"step_batch @ {bcfg.groups} groups (P=8 W=512 K=8 E=8): kernel {bms:.4f} ms, "
        f"wrapper host part {bhost_ms:.4f} ms, plain {bplain_ms:.2f} ms, bound {bbound_ms:.5f} ms "
        f"({bbytes} B)")
    p5_st, p5_ib = p5_last
    p5_ticks = torch.ones((p5_cfg.groups,), dtype=torch.int32, device="cuda")
    p5_ms, p5_host_ms, p5_plain_ms, p5_bytes = kernel_vs_plain(p5_cfg, p5_st, p5_ib, p5_ticks,
                                                               50, 3)
    p5_bound_ms = p5_bytes / kb.HBM_BYTES_PER_S * 1e3
    log(f"step_batch @ {p5_cfg.groups} lanes (P=5 W=256 K=4 E=64): kernel {p5_ms:.4f} ms, "
        f"wrapper host part {p5_host_ms:.4f} ms, plain {p5_plain_ms:.2f} ms, bound "
        f"{p5_bound_ms:.5f} ms ({p5_bytes} B)")
    rb = phase_rebase(cuda, kb, card)
    act = phase_activation(cuda, kb, card)
    log(json.dumps({
        "kernel_bench": {
            "groups": bcfg.groups, "steps": BENCH_STEPS,
            "kernel_proposals_per_sec": res["kernel_proposals_per_sec"],
            "loop_ms_per_step": res["loop_ms_per_step"],
            "step_ms_median": step_ms[len(step_ms) // 2],
            "final_commit": res["final_commit"], "card": card,
        }
    }))
    if bad:
        raise AssertionError(f"kernel disagrees with the plain version on {bad}")

    # ---- phase 4: the super-step path at config 6's shape ----
    at("4")
    scfg, s0, sroute, srdelta, hosts, kept4, ss_launches = phase_superstep(K, cuda, kb)
    phase_residual(K, cuda, kb)
    unsharded = time_superstep(K, cuda, kb, scfg, s0, sroute, srdelta, hosts, sharded=False)
    sharded = time_superstep(K, cuda, kb, scfg, s0, sroute, srdelta, hosts, sharded=True)
    for name, r in (("unsharded", unsharded), (f"{SS_SHARDS} logical shards", sharded)):
        log(f"superstep {name} (G={scfg.groups}, K={SS_STEPS}): wall {r['wall_ms']:.3f} ms, "
            f"device {r['device_ms']:.3f} ms, {r['inner_steps_per_s']:.0f} inner steps/s, "
            f"{r['entries_committed_per_s']:.4g} entries committed/s across leader lanes "
            f"(device clock), launches per super-step {r['launches_per_superstep']} [{card}]")
        idle = r["device_idle_share"]
        log(f"superstep {name} profile: {r['profiled_wall_ms_per_superstep']:.3f} ms wall, device "
            f"busy {r['device_busy_ms_per_superstep']} ms, idle share "
            f"{'not measured' if idle is None else f'{idle:.3f}'}, by kernel "
            f"{json.dumps(r['device_ms_by_kernel'])}")
    nk = phase_new_kernels(K, cuda, kb, scfg, kept4)
    per_ss = lambda name, r: r["launches_per_superstep"][name]

    # ---- phase 5: the engine through NodeHost, configs 2, 6, 1, 3, 4, 5, 8 ----
    at("5")
    engines = {c: phase_engine(cuda, K, c) for c in E2E_CONFIGS}

    # ---- phase 6: the fault plane on the card ----
    at("6")
    faults = phase_faults(cuda, K)

    # ---- phase 7: the operator tools against live NodeHosts ----
    at("7")
    tools = phase_tools(cuda, K, engines[2][0])
    log(f"tools: {json.dumps(tools, default=str)}")
    log(f"tools @ {tools['lanes']} lanes: top collect {tools['top']['collect_ms_median']:.3f} ms "
        f"median ({tools['top']['collects']} collects, max {tools['top']['collect_ms_max']:.3f} "
        f"ms), history sample {tools['history']['sample_cost_ms_mean']:.3f} ms mean over "
        f"{tools['history']['samples_total']} samples ({tools['history']['lanes_per_sampler']} "
        f"lanes per sampler), phase {tools['seconds']} s [{card}]")

    # ---- phase 8: tools.longhaul on the card ----
    at("8")
    lh = phase_longhaul(cuda, K)
    lh_runs = [n for n, _ in LONGHAUL_ROUNDS]
    run_s = ", ".join(f"{n} {lh[n]['seconds']} s" for n in lh_runs)
    log(f"longhaul: {len(lh_runs)} runs, {sum(len(lh[n]['rounds']) for n in lh_runs)} rounds, "
        f"phase {lh['seconds']} s ({run_s}) [{card}]")

    # ---- phase 9: native storage, C++ state machines, the C ABI ----
    at("9")
    nat = phase_native(cuda, K)
    log(f"native @ {nat['main']['lanes']} lanes over NativeWalKV with the C++ KV plugin: "
        f"{nat['main']['proposals_per_s']:.1f} proposals/s (phase 5 config 2: "
        f"{engines[2][0].get('value', 0):.1f}/s), elected {nat['main']['groups_elected']}, "
        f"hashes equal in {nat['main']['groups_hash_equal']} groups, lincheck "
        f"{nat['main']['lincheck_ok']}; on-disk plugin restart {nat['diskkv_restart']}; demos "
        f"{nat['demos']}; phase {nat['seconds']} s [{card}]")

    # ---- phase 10: the sharded path (shard_over_mesh) on logical shards ----
    at("10")
    mesh = phase_mesh(cuda, K, kb, card)
    mesh_runs = mesh["runs"]["logical"]
    log(f"mesh: {MESH_SHARDS} shards on {mesh['distinct_cards']} distinct card(s), phase "
        f"{mesh['seconds']} s [{card}]")

    # ---- phase 11: the reference's engine-level scenarios ----
    at("11")
    scen = phase_scenarios(cuda, K, card)
    scen_names = [n for n, _ in SCENARIOS]
    log(f"scenarios: {len(scen_names)} scenarios ("
        + ", ".join(f"{n} {scen[n]['seconds']} s" for n in scen_names)
        + f"), phase {scen['seconds']} s [{card}]")

    # ---- phase 12: the reference's last engine-level scenarios ----
    at("12")
    fleet = phase_fleet(cuda, K, card)
    fleet_names = [n for n, _ in FLEET_SCENARIOS]
    log(f"fleet: {len(fleet_names)} scenarios ("
        + ", ".join(f"{n} {fleet[n]['seconds']} s" for n in fleet_names)
        + f"), bulk fleet of {fleet['bulk_fleet']['lanes']} groups elected in "
        f"{fleet['bulk_fleet']['elect_all_s']} s, phase {fleet['seconds']} s [{card}]")

    # ---- phase 13: the follower catch-up and the last eleven test files ----
    at("13")
    catch = phase_catchup(cuda, K, card)
    catch_names = [n for n, _ in CATCHUP_SCENARIOS]
    log(f"catchup: {len(catch_names)} scenarios ("
        + ", ".join(f"{n} {catch[n]['seconds']} s" for n in catch_names)
        + f"), {catch['joins_first_rejects']} joiners' first rejects, teardown "
        + json.dumps({n: catch["teardown"][n]["verdicts"] for n, *_x in TEARDOWN_SHAPES})
        + f" in {catch['teardown']['seconds']} s, "
        f"{catch['log_holes']} log holes, {catch['missing_arena_saves']} saves without a "
        f"payload, phase "
        f"{catch['seconds']} s, whole run {time.perf_counter() - t_run:.1f} s [{card}]")

    # the step kernel against its plain version at the shapes the engine
    # ran in phases 5-9 (each already failed on a mismatch)
    shapes = {f"config{c}": r["kernel_vs_plain"] for c, (r, _) in engines.items()
              if "kernel_vs_plain" in r}
    shapes.update({f"faults_{n}": f["kernel_vs_plain"] for n, f in faults.items()})
    shapes.update({f"tools_{n}": tools[n]["kernel_vs_plain"]
                   for n in ("hosts", "importer", "helloworld")})
    shapes.update({f"longhaul_{n}": lh[n]["kernel_vs_plain"] for n in lh_runs
                   if "kernel_vs_plain" in lh[n]})
    shapes["native"] = nat["main"]["kernel_vs_plain"]
    shapes["mesh_config6"] = mesh_runs["config6"]["superstep_vs_plain"]
    for n in scen_names:
        for which in ("kernel_vs_plain", "superstep_vs_plain"):
            if which in scen[n]:
                shapes[f"scenario_{n}" + ("_superstep" if which[0] == "s" else "")] = scen[n][which]
    shapes.update({f"fleet_{n}": fleet[n]["kernel_vs_plain"] for n in fleet_names})
    for n in catch_names:
        for which in ("kernel_vs_plain", "superstep_vs_plain"):
            if which in catch[n]:
                shapes[f"catchup_{n}" + ("_superstep" if which[0] == "s" else "")] = \
                    catch[n][which]
    cases += sum(v["cases"] for v in shapes.values())
    err = max([err] + [v["max_abs_err"] for v in shapes.values()])
    # engine steps of the whole run (config 8: both of its runs)
    steps_of = lambda r: r["engine_steps_total"] + (r.get("readindex_run") or {}).get(
        "engine_steps_total", 0)
    per_step = lambda name: {
        f"config{c}": {"launches": ln[name],
                       "per_engine_step": ln[name] / max(1, steps_of(r))}
        for c, (r, ln) in engines.items()}

    def longhaul_launches(name):
        # per run of phase 8: launches, per round, per engine step (K=1)
        # or per inner step of the super-step (K=8)
        out = {}
        for n in lh_runs:
            r = lh[n]
            inner = r["engine_steps"] + r["supersteps"] * r["steps_per_sync"]
            out[n] = {"launches": r["launches"][name],
                      "per_round": r["launches"][name] / max(1, len(r["rounds"])),
                      "per_engine_step": r["launches"][name] / max(1, inner)}
        return out

    def mesh_launches(name):
        # phase 10: the lockstep runs' and the sharded engine's launches
        out = {f"lockstep_{x}": mesh_runs[f"lockstep_{x}"]["launches"][name]
               for x in ("3072", "50k")}
        for c in MESH_CONFIGS:
            r = mesh_runs[f"config{c}"]
            out[f"config{c}"] = {"launches": r["launches"][name],
                                 "per_inner_step": r["launches_per_inner_step"][name]}
        return out

    ring = "dragonboat_tpu_torch/csrc/"
    kernels = {"kernels": [{
        "name": "step_batch",
        "route": "cuda",
        "source": ring + "step_batch.cu",
        "replaces": "dragonboat_tpu/ops/kernel.py:962",
        "launches": launches,
        "max_abs_err": err,
        "mismatched_fields": len(bad),
        "cases": cases,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "host_ms": host_ms,
        "regime_50k": {"groups": bcfg.groups, "ms": bms, "host_ms": bhost_ms,
                       "plain_ms": bplain_ms, "bound_ms": bbound_ms},
        "p5": {"lanes": p5_cfg.groups, "cases": p5_cases, "mismatched_fields": len(p5_bad),
               "ms": p5_ms, "host_ms": p5_host_ms, "plain_ms": p5_plain_ms,
               "bound_ms": p5_bound_ms},
        "superstep": {"groups": scfg.groups, "launches": ss_launches["step_batch"],
                      "per_superstep": per_ss("step_batch", unsharded),
                      "per_superstep_sharded": per_ss("step_batch", sharded),
                      **nk["step_batch"]},
        "engine": per_step("step_batch"),
        "faults": {n: f["launches"]["step_batch"] for n, f in faults.items()},
        "tools": {n: tools[n]["launches"]["step_batch"]
                  for n in ("hosts", "importer", "helloworld")},
        "longhaul": longhaul_launches("step_batch"),
        "native": {"launches": nat["main"]["launches"]["step_batch"],
                   "per_engine_step": nat["main"]["launches"]["step_batch"]
                   / max(1, nat["main"]["engine_steps_total"]),
                   "diskkv_restart": nat["diskkv_restart"]["launches"]["step_batch"]},
        "longhaul_superstep": lh["k8"]["superstep_vs_plain"],
        "mesh": mesh_launches("step_batch"),
        "scenarios": {n: scen[n]["launches"]["step_batch"] for n in scen_names},
        "fleet": {n: fleet[n]["launches"]["step_batch"] for n in fleet_names},
        "catchup": {n: catch[n]["launches"]["step_batch"] for n in catch_names},
        "engine_shapes": shapes,
        "ptxas": ptxas["step_batch_kernel"],
        "frame_bytes": frames,
    }]}
    for name, src, line in (("route_columns", "route.cu", 1327),
                            ("route_index", "route.cu", 1495),
                            ("route_scatter", "route.cu", 1495),
                            ("ring_gather", "ring_gather.cu", 1628)):
        r = nk[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": ring + src,
            "replaces": f"dragonboat_tpu/ops/kernel.py:{line}",
            "launches": ss_launches[name], "max_abs_err": 0,
            "mismatched_fields": len(r["bad"]), "cases": r["cases"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "per_superstep": per_ss(name, unsharded),
            "per_superstep_sharded": per_ss(name, sharded),
            "engine": per_step(name),
            "longhaul": longhaul_launches(name),
            "mesh": mesh_launches(name),
            "scenarios": {n: scen[n]["launches"][name] for n in scen_names},
            "fleet": {n: fleet[n]["launches"][name] for n in fleet_names},
            "catchup": {n: catch[n]["launches"][name] for n in catch_names},
            "ptxas": ptxas[name + "_kernel"],
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "library_ms", "cases", "bad")},
        })
    # the gather's main path is the sharded engine's: its launches there
    gather_row = next(k for k in kernels["kernels"] if k["name"] == "ring_gather")
    gather_row["launches_phase4"] = gather_row["launches"]
    gather_row["launches"] = mesh_runs["config6"]["launches"]["ring_gather"]
    gather_row["superstep_50k"] = mesh_runs["lockstep_50k"]["gather"]
    kernels["superstep"] = {"unsharded": unsharded, "sharded": sharded,
                            "shards": SS_SHARDS, "card": card}
    kernels["mesh"] = {
        "distinct_cards": mesh["distinct_cards"], "seconds": mesh["seconds"], "card": card,
        "runs": {name: {k: ({x: v for x, v in r.items() if x in E2E_KEYS + (
            "msgs_in_window", "launches_per_inner_step", "superstep_vs_plain", "shard_over_mesh",
            "n_devices", "mesh_shape", "padded_groups", "lanes_total")}
            if k.startswith("config") else r) for k, r in run.items()}
            for name, run in mesh["runs"].items()}}
    main_timed = act["timed"]["3072x4096"]
    kernels["kernels"].append({
        "name": "activation", "route": "cuda", "source": ring + "activate.cu",
        "replaces": "dragonboat_tpu/engine/vector.py:192",
        # config 2's bring-up through NodeHost (the headline path)
        "launches": engines[2][1]["activate"], "max_abs_err": act["max_abs_err"],
        "mismatched_fields": len(act["mismatched_fields"]), "cases": act["cases"],
        "ms": main_timed["ms"], "plain_ms": main_timed["plain_ms"],
        "bound_ms": main_timed["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "shape": "3072 lanes, P=4, W=256, bucket 4096", "timed": act["timed"],
        "host_ms": act["host_ms"], "plain_host_ms": act["plain_host_ms"],
        "host_lanes": act["host_lanes"],
        "engine": per_step("activate"),
        "bring_up_batches": {f"config{c}": r["activation_batches"]
                             for c, (r, _) in engines.items()},
        "ptxas": ptxas["activate_kernel"],
    })
    rw = catch["rebase_wide"]
    main_rb = rb["timed"]["3072"]
    kernels["kernels"].append({
        "name": "rebase", "route": "cuda", "source": ring + "rebase.cu",
        "replaces": "dragonboat_tpu/ops/state.py:542",
        "also_replaces": "dragonboat_tpu/engine/vector.py:3383",
        # phase 13's rebase_wide (the path's run, its counts zeroed just
        # before it; phase 5 reaches no rebase: no lane nears 2^30)
        "launches": rw["launches"]["rebase"],
        "max_abs_err": max(rb["max_abs_err"], rw["max_abs_err"]),
        "mismatched_fields": len(rb["mismatched_fields"]) + len(rw["mismatched_fields"]),
        "cases": rb["cases"] + sum(rw["held"].values()),
        "ms": main_rb["ms"], "plain_ms": main_rb["plain_ms"], "bound_ms": main_rb["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": "3072 lanes, P=4, W=256",
        "timed": rb["timed"],
        "rebase_wide": {n: {k: rw[n][k] for k in ("calls", "with_resid")}
                        for n in ("k1", "k8")},
        "engine": per_step("rebase"),
        "engine_calls": {f"config{c}": r["rebase_calls"] for c, (r, _) in engines.items()},
        "catchup": {n: catch[n]["launches"]["rebase"] for n in catch_names},
        "ptxas": ptxas["rebase_kernel"],
    })
    kernels["engine"] = {f"config{c}": {k: r.get(k) for k in E2E_KEYS + E2E_TRAFFIC_KEYS
                                        if k in E2E_KEYS or k in r}
                         for c, (r, _) in engines.items()}
    kernels["faults"] = {n: {k: v for k, v in f.items()
                             if k not in ("launches", "kernel_vs_plain")}
                         for n, f in faults.items()}
    kernels["tools"] = {k: v for k, v in tools.items()
                        if k not in ("hosts", "importer", "helloworld")}
    kernels["longhaul"] = {n: {k: v for k, v in lh[n].items()
                               if k not in ("launches", "kernel_vs_plain")} for n in lh_runs}
    kernels["native"] = {k: v for k, v in nat.items() if k != "main"}
    kernels["native"]["main"] = {k: v for k, v in nat["main"].items()
                                 if k not in ("launches", "kernel_vs_plain")}
    kernels["scenarios"] = {
        n: {k: v for k, v in scen[n].items()
            if k not in ("launches", "kernel_vs_plain", "superstep_vs_plain")}
        for n in scen_names}
    kernels["scenarios"]["reference_storm"] = scen["reference_storm"]
    kernels["fleet"] = {
        n: {k: v for k, v in fleet[n].items() if k not in ("launches", "kernel_vs_plain")}
        for n in fleet_names}
    kernels["fleet"]["seconds"] = fleet["seconds"]
    kernels["catchup"] = {
        n: {k: v for k, v in catch[n].items()
            if k not in ("launches", "kernel_vs_plain", "superstep_vs_plain")}
        for n in catch_names}
    kernels["catchup"]["teardown"] = catch["teardown"]
    kernels["catchup"].update(seconds=catch["seconds"],
                              joins_first_rejects=catch["joins_first_rejects"],
                              log_holes=catch["log_holes"],
                              missing_arena_saves=catch["missing_arena_saves"])
    act_row = next(k for k in kernels["kernels"] if k["name"] == "activation")
    act_row["fleet_bring_up_batches"] = {
        n: fleet[n]["activation"] for n in fleet_names if "activation" in fleet[n]}
    act_row["fleet"] = {n: fleet[n]["launches"]["activate"] for n in fleet_names}
    act_row["catchup"] = {n: catch[n]["launches"]["activate"] for n in catch_names}
    log(f"card: {card_line()}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
