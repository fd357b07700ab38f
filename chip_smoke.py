"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
drives the port's main path (a 3-replica x 1024-group loopback cluster at
BASELINE config 2's engine shape: elect, propose, read, transfer) through
them, holds every kernel against its plain PyTorch version on the card,
and measures the step kernel at the 50,000-group kernel regime. Phase 4
drives the super-step path at BASELINE config 6's shape (3072 co-hosted
lanes, K=8 inner steps with the on-device router), unsharded and as 4
logical shards of the card exchanging candidates through the gather
kernel, in lockstep with the plain path, and times the router and gather
kernels. It exits
non-zero, printing no result, when no CUDA device is present or any phase
fails. The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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


def time_each(setup, fn, reps):
    """Median device time of fn() alone (CUDA events around each call),
    with setup() run before each call outside the events."""
    times = []
    for _ in range(reps + 1):
        setup()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times[1:])
    return ms[len(ms) // 2]


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
    """Every kernel of the path ran: per inner step one step launch
    unsharded and n sharded, one gather (sharded only), and one plain step
    on the plain path."""
    for name, c in counts.items():
        assert c > 0, f"the super-step path launched no {name} kernel"
    assert counts["step_batch"] == inner_steps * (1 + n), counts
    assert counts["ring_gather"] == inner_steps, counts
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
    busy = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:6])
    return {
        "profiled_wall_ms_per_superstep": wall / 3,
        "device_busy_ms_per_superstep": busy if busy else None,
        "device_idle_share": 1 - busy / (wall / 3) if busy else None,
        "device_ms_by_kernel": {k[:60]: v for k, v in top.items()},
    }


def time_launch(launch, reps):
    """Median device time of single launches (CUDA events around each)."""
    times = []
    for _ in range(reps + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times[1:])
    return ms[len(ms) // 2]


def phase_new_kernels(K, cuda, kb, cfg, kept):
    """Each new kernel against its plain version on its own inputs, then
    its time beside its bound, its plain version's and the library call's
    (router: 8 seeded random draws at config 6's shape, unsharded and as 4
    shards; gather: odd and even slab lengths, n in {1, 2, 4})."""
    from dragonboat_tpu_torch.ops.convert import state_from_numpy
    from dragonboat_tpu_torch.ops.state import StepOutput

    dev = torch.device("cuda", 0)
    G, P, n = cfg.groups, cfg.peers, SS_SHARDS
    K_, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    rng = np.random.default_rng(SS_SEED + 1)
    route_bad, route_cases = set(), 0
    for i in range(8):
        st, out, route, rdelta = kb.random_route_case(rng, cfg)
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
    log(f"router: {route_cases} cases, mismatched fields {sorted(route_bad) or 0}")

    gather_bad, gather_cases = set(), 0
    C = cuda.slab_rows(cfg)
    for ml in (1235, 18432):
        for k in (1, 2, 4):
            slabs = [torch.randint(-2**31, 2**31 - 1, (C, ml), dtype=torch.int32, device=dev)
                     for _ in range(k)]
            got = cuda.ring_gather_cuda(slabs)
            ref = K.ring_gather_reference(slabs)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                if not torch.equal(a, b):
                    gather_bad.add(f"Ml={ml} n={k}")
            gather_cases += 1
    log(f"ring_gather: {gather_cases} cases (C={C}, Ml in 1235, 18432; n in 1, 2, 4), "
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

    step_ms = time_each(restore, lambda: launcher("step_batch_launch", sp, "step_batch"), 100)
    step_plain = time_ms(lambda: K.step_batch_reference(st, ib, ticks, cfg), 3)
    after, o = cuda.step_batch_cuda(K.clone_state(st), ib, ticks, cfg)
    step_bound = kb.step_bytes(st, ib, ticks, o, after) / kb.HBM_BYTES_PER_S * 1e3

    # the router on the step's output (unsharded: the scatter reads a
    # gather of one shard)
    M = G * cuda.candidates_per_lane(cfg)
    slab = torch.empty((C, M), dtype=torch.int32, device=dev)
    nxt, plan = cuda._alloc_inbox(G, K_, E, dev), cuda._alloc_plan(G, P, K_, R, dev)
    _, route, rdelta = kb.superstep_cluster(SS_GROUPS, SS_REPLICAS, cfg, dev)
    cp = cuda._columns_params(after, o, route, rdelta, slab, plan, cfg)
    xp = cuda._scatter_params(slab, 1, 0, G, P, nxt, plan, cfg)
    cols_ms = time_launch(lambda: launcher("route_columns_launch", cp, "route_columns"), 100)
    scat_ms = time_launch(lambda: launcher("route_scatter_launch", xp, "route_scatter"), 100)
    torch.cuda.synchronize()
    accepted = int(sum(int(p.sum()) for p in plan))
    route_plain = time_ms(lambda: K.route_step_output_reference(after, o, route, rdelta, cfg), 3)
    cols_bound = kb.route_columns_bytes(o, route, cfg) / kb.HBM_BYTES_PER_S * 1e3
    scat_bound = kb.route_scatter_bytes(1, M, accepted, nxt, cfg) / kb.HBM_BYTES_PER_S * 1e3

    # the gather at config 6 over 4 shards: one slab per shard
    Ml = M // n
    slabs = [torch.randint(-9, 9, (C, Ml), dtype=torch.int32, device=dev) for _ in range(n)]
    outs = [torch.empty((n, C, Ml), dtype=torch.int32, device=dev) for _ in range(n)]
    gp = cuda._gather_params(slabs, outs)
    gather_ms = time_launch(lambda: launcher("ring_gather_launch", gp, "ring_gather"), 100)
    gather_plain = time_ms(lambda: K.ring_gather_reference(slabs), 20)
    gather_lib = time_ms(lambda: [torch.stack(slabs) for _ in range(n)], 20)
    gather_bound = kb.ring_gather_bytes(n, C * Ml) / kb.HBM_BYTES_PER_S * 1e3
    log(f"step_batch @ {G} lanes (config 6 window 3): kernel {step_ms:.4f} ms, "
        f"plain {step_plain:.2f} ms, bound {step_bound:.5f} ms")
    log(f"route_columns @ {M} candidates (C={C}): kernel {cols_ms:.4f} ms, bound "
        f"{cols_bound:.5f} ms; route_scatter ({accepted} accepted): kernel {scat_ms:.4f} ms, "
        f"bound {scat_bound:.5f} ms; plain router {route_plain:.2f} ms, library none")
    log(f"ring_gather n={n} x ({C}, {Ml}): kernel {gather_ms:.4f} ms, plain {gather_plain:.4f} ms, "
        f"library torch.stack x{n} {gather_lib:.4f} ms, bound {gather_bound:.5f} ms")
    if route_bad or gather_bad:
        raise AssertionError(f"router {sorted(route_bad)}, gather {sorted(gather_bad)}")
    return {
        "step_batch": dict(ms=step_ms, plain_ms=step_plain, bound_ms=step_bound),
        "route_columns": dict(ms=cols_ms, plain_ms=route_plain, bound_ms=cols_bound,
                              library_ms=None, cases=route_cases, bad=route_bad),
        "route_scatter": dict(ms=scat_ms, plain_ms=route_plain, bound_ms=scat_bound,
                              library_ms=None, cases=route_cases, bad=route_bad),
        "ring_gather": dict(ms=gather_ms, plain_ms=gather_plain, bound_ms=gather_bound,
                            library_ms=gather_lib, cases=gather_cases, bad=gather_bad),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from dragonboat_tpu_torch.ops import cuda, kernel as K
    from dragonboat_tpu_torch import kernel_bench as kb

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 0: build ----
    t0 = time.perf_counter()
    cuda.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f}s")
    for src, report in cuda.PTXAS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"ptxas {src}: {line.strip()}")

    # ---- phase 1: the main path ----
    cfg, kept, launches = phase_cluster(K, cuda)

    # ---- phase 3 state first: the 50,000-group kernel regime ----
    res = kb.run_kernel_bench(BENCH_GROUPS, BENCH_STEPS, 5, 512, device="cuda")
    bcfg = res["cfg"]
    big = (bcfg, res["state"], res["inbox"], res["ticks"])

    # ---- phase 2: kernel against its plain version ----
    cases, bad, err = phase_compare(K, cuda, cfg, kept, big)

    # ---- timings: main-path shape, then the kernel regime ----
    def kernel_vs_plain(c, st, ib, ticks, reps_k, reps_p):
        # kernel alone: parameters prepared once; before each launch the
        # state is restored (outside the timed events), so every launch
        # does the same work on the same input
        work = K.clone_state(st)
        params, out = cuda.prepare_step(work, ib, ticks, c)
        dev = st.term.device

        def restore():
            for a, b in zip(work, st):
                a.copy_(b)

        ms = time_each(restore, lambda: cuda.launch_step(params, dev), reps_k)
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
    ms, host_ms, plain_ms, nbytes = kernel_vs_plain(cfg, st, ib, ticks, 200, 3)
    bound_ms = nbytes / kb.HBM_BYTES_PER_S * 1e3
    log(f"step_batch @ 1024 groups (P=4 W=256 K=4 E=64): kernel {ms:.4f} ms, "
        f"wrapper host part {host_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms "
        f"({nbytes} B)")
    bms, bhost_ms, bplain_ms, bbytes = kernel_vs_plain(bcfg, *big[1:], 50, 2)
    bbound_ms = bbytes / kb.HBM_BYTES_PER_S * 1e3
    step_ms = sorted(res["step_ms"])
    log(f"step_batch @ {bcfg.groups} groups (P=8 W=512 K=8 E=8): kernel {bms:.4f} ms, "
        f"wrapper host part {bhost_ms:.4f} ms, plain {bplain_ms:.2f} ms, bound {bbound_ms:.5f} ms "
        f"({bbytes} B)")
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
        "superstep": {"groups": scfg.groups, "launches": ss_launches["step_batch"],
                      "per_superstep": per_ss("step_batch", unsharded),
                      "per_superstep_sharded": per_ss("step_batch", sharded),
                      **nk["step_batch"]},
    }]}
    for name, src, line in (("route_columns", "route.cu", 1327),
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
        })
    kernels["superstep"] = {"unsharded": unsharded, "sharded": sharded,
                            "shards": SS_SHARDS, "card": card}
    log(f"card: {card_line()}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
