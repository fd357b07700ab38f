"""Op counts and CPU time of the port's plain step (`ops/kernel.py`
`step_batch_reference`), per handler section of `_handle_message`.

    python3 plain_step_profile.py [--tree DIR] [--sections] [--inputs FILE]

Runs on the CPU with one torch thread, at two shapes:

- 32 lanes, P=4, W=64, K=8, E=8: the leader-heaviest replica's state after
  a seeded LoopbackCluster run (pre-vote, check-quorum, leases), stepped on
  inboxes whose slots are empty, hold HEARTBEAT in 1, 2 or all 8 slots,
  HEARTBEAT_RESP or REPLICATE_RESP in all 8, or random messages of every
  type in all 8 (`kernel_bench.random_inbox`);
- lease_lapse.py's shape (5 hosts x 4 groups on one shared core,
  election_rtt 10): the (state, inbox, ticks) of every engine step of
  tests/test_torch_engine_reads_churn.py's script on the port, replayed.
  `--inputs FILE` saves them on the first run and replays them after, so
  two checkouts step the same inputs.

Each case reports its median time over `--reps` calls and its count of
torch ops (aten calls). `--sections` also times each handler section: a
copy of `_handle_message` with a timer at each `# ---- <name>` comment.
`--tree DIR` profiles the port of another checkout (a parent unpacked
with `git archive`, say). Prints one JSON object per shape.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpCount(TorchDispatchMode):
    """Counts the aten calls made while it is entered."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        OpCount.n += 1
        return func(*args, **(kwargs or {}))


class Sections:
    """Time and ops per `# ---- <name>` section of `_handle_message`."""

    def __init__(self, K):
        self.ms, self.ops, self.cur, self.t, self.n0 = {}, {}, None, 0.0, 0
        lines = []
        for ln in inspect.getsource(K._handle_message).splitlines():
            m = re.match(r"^(\s+)# ---- (.+?) -*$", ln)
            if m:
                lines.append(f"{m.group(1)}_section({m.group(2)!r})")
            if ln.strip().startswith("return s, out"):
                lines.append(ln[: len(ln) - len(ln.lstrip())] + "_section(None)")
            lines.append(ln)
        scope = dict(vars(K), _section=self.mark)
        exec(compile("\n".join(lines), "_handle_message", "exec"), scope)
        K._handle_message = scope["_handle_message"]

    def mark(self, name):
        now = time.perf_counter()
        if self.cur is not None:
            self.ms[self.cur] = self.ms.get(self.cur, 0.0) + (now - self.t) * 1e3
            self.ops[self.cur] = self.ops.get(self.cur, 0) + OpCount.n - self.n0
        self.cur, self.t, self.n0 = name, now, OpCount.n

    def run(self, calls, per):
        """Per-call section times (without the op counter) and op counts."""
        self.ms, self.ops = {}, {}
        for fn in calls:
            fn()
        ms = {k: round(v / per, 3) for k, v in self.ms.items()}
        self.ms, self.ops = {}, {}
        with OpCount():
            for fn in calls:
                fn()
        return ms, {k: v // per for k, v in self.ops.items()}


def median_ms(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return round(float(np.median(ts)) * 1e3, 3)


def op_count(fn):
    OpCount.n = 0
    with OpCount():
        fn()
    return OpCount.n


def shape_32(K, T, LB, random_inbox):
    cfg = T.KernelConfig(groups=32, peers=4, log_window=64, inbox_depth=8,
                         max_entries_per_msg=8, readindex_depth=4)
    c = LB.LoopbackCluster(n_replicas=3, n_groups=32, cfg=cfg, seed=7, check_quorum=True,
                           prevote=True, lease_read=True, lease_margin=1, device="cpu")
    for _ in range(60):
        c.step(tick=True)
    for g in range(32):
        lead = c.leader_of(g)
        if lead is not None:
            c.propose(lead, g, n=2)
    c.step(tick=False)
    s = c.states[max(range(3), key=lambda h: int((c.states[h].role == T.ROLE.LEADER).sum()))]

    def inbox(types):
        ib = T.make_empty_inbox(cfg, device="cpu")
        for k, t in enumerate(types):
            ib.mtype[:, k] = t
            ib.from_slot[:, k] = 1
            ib.term[:, k] = s.term
            ib.log_index[:, k] = s.last_index
            ib.log_term[:, k] = 1
        return ib

    M = T.MSG
    cases = {"empty": inbox([]), "1 x HEARTBEAT": inbox([M.HEARTBEAT]),
             "2 x HEARTBEAT": inbox([M.HEARTBEAT] * 2), "8 x HEARTBEAT": inbox([M.HEARTBEAT] * 8),
             "8 x HEARTBEAT_RESP": inbox([M.HEARTBEAT_RESP] * 8),
             "8 x REPLICATE_RESP": inbox([M.REPLICATE_RESP] * 8)}
    npst = {f: getattr(s, f).numpy() for f in s._fields}
    rib = random_inbox(np.random.default_rng(0), npst, cfg)
    cases["8 x every type"] = T.Inbox(*(torch.from_numpy(np.ascontiguousarray(rib[f]))
                                        for f in T.Inbox._fields))
    ticks = torch.zeros(32, dtype=torch.int32)
    return {name: (s, ib, ticks, cfg) for name, ib in cases.items()}


def lease_lapse_inputs(K, T, path):
    """The step inputs of test_torch_engine_reads_churn.py's script on the
    port at election_rtt 10, captured (or loaded from `path`)."""
    if path and os.path.exists(path):
        z = np.load(path)
        n = int(z["n"])
        cfg = T.KernelConfig(*z["cfg"].tolist())
        out = []
        for i in range(n):
            st = T.RaftTensors(*(torch.from_numpy(z[f"s{i}.{f}"]) for f in T.RaftTensors._fields))
            ib = T.Inbox(*(torch.from_numpy(z[f"i{i}.{f}"]) for f in T.Inbox._fields))
            out.append((st, ib, torch.from_numpy(z[f"t{i}"]), cfg))
        return out
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_engine_reads_churn as script

    script.ELECTION_RTT = 10
    got, inner = [], K.step_batch_reference

    def recording(s, ib, ticks, cfg):
        got.append((K.clone_state(s), K.clone_state(ib), ticks.clone(), cfg))
        return inner(s, ib, ticks, cfg)

    K.step_batch_reference = recording
    try:
        script.run_script("dragonboat_tpu_torch")
    except AssertionError:
        pass  # a lapsed lease ends the script; the steps so far are kept
    finally:
        K.step_batch_reference = inner
    if path:
        arrays = {"n": np.asarray(len(got)), "cfg": np.asarray(tuple(got[0][3]))}
        for i, (st, ib, ticks, _c) in enumerate(got):
            arrays.update({f"s{i}.{f}": getattr(st, f).numpy() for f in st._fields})
            arrays.update({f"i{i}.{f}": getattr(ib, f).numpy() for f in ib._fields})
            arrays[f"t{i}"] = ticks.numpy()
        np.savez(path, **arrays)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose port is profiled")
    ap.add_argument("--sections", action="store_true", help="time each handler section")
    ap.add_argument("--inputs", default="", help="npz file of the lease_lapse step inputs")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    torch.set_num_threads(1)
    K = importlib.import_module("dragonboat_tpu_torch.ops.kernel")
    T = importlib.import_module("dragonboat_tpu_torch.ops.state")
    LB = importlib.import_module("dragonboat_tpu_torch.ops.loopback")
    KB = importlib.import_module("dragonboat_tpu_torch.kernel_bench")
    secs = Sections(K) if args.sections else None

    out = {"shape": "32 lanes, P=4, W=64, K=8, E=8", "tree": args.tree, "cases": {}}
    for name, (s, ib, ticks, cfg) in shape_32(K, T, LB, KB.random_inbox).items():
        fn = lambda: K.step_batch_reference(s, ib, ticks, cfg)
        r = {"ms": median_ms(fn, args.reps), "ops": op_count(fn)}
        if secs:
            r["sections_ms"], r["sections_ops"] = secs.run([fn] * 10, 10)
        out["cases"][name] = r
    print(json.dumps(out), flush=True)

    inputs = lease_lapse_inputs(K, T, args.inputs)
    calls = [lambda a=a: K.step_batch_reference(*a) for a in inputs]
    ts = []
    for fn in calls:
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    out = {"shape": "lease_lapse: 5 hosts x 4 groups on one core, K=8", "tree": args.tree,
           "steps": len(calls), "lanes": int(inputs[0][0].term.shape[0]),
           "median_ms": round(float(np.median(ts)) * 1e3, 3),
           "ops_per_step": sum(op_count(fn) for fn in calls) // len(calls)}
    if secs:
        out["sections_ms"], out["sections_ops"] = secs.run(calls, len(calls))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
