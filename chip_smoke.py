"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
drives the port's main path (a 3-replica x 1024-group loopback cluster at
BASELINE config 2's engine shape: elect, propose, read, transfer) through
them, holds every kernel against its plain PyTorch version on the card,
and measures the step kernel at the 50,000-group kernel regime. It exits
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

    cuda.LAUNCHES["step_batch"] = 0
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

    kernels = {"kernels": [{
        "name": "step_batch",
        "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/step_batch.cu",
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
    }]}
    log(f"card: {card_line()}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
