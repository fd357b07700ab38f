"""Device time of the port's hand-written kernels, for one or more checkouts,
on one NVIDIA GPU.

    python3 compare_kernels.py --tree PARENT --tree . --tree . --tree PARENT

Each --tree is the root of a checkout of this repository; each is run in a
process of its own (both define `dragonboat_tpu_torch`), in the order
given, so two versions are compared on one card in turns. A run builds
that checkout's kernels, makes the same inputs from seeds, and times every
kernel by its device duration in a torch.profiler trace (the mean over
the launches), which a host-side launch gap cannot inflate:

- step_batch at 1024 lanes on chip_smoke.py's phase-3 input (the middle
  kept (state, inbox, ticks) of replica 0 of its 3 x 1024-group loopback
  cluster, config 2's widths P=4 W=256 K=4 E=64 R=4, taken from the
  checkout's own chip_smoke.py) and on lanes 0-1023 of the config-6 state
  below, at 3072 lanes (BASELINE config 6's co-hosted state after three
  windows of kernel_bench.host_window, with window 3's inbox) and at
  50,000 lanes (kernel_bench's regime, P=8 W=512 K=8 E=8 R=4);
- the router on that 3072-lane step's output: one router call unsharded
  (route_step_output_cuda) and one over 4 lane blocks (shard_route_cuda),
  per kernel.

Each run prints one JSON line with the card's name and power limit. It
exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

REPS = 30


def _run_tree() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragonboat_tpu_torch import kernel_bench as kb
    from dragonboat_tpu_torch.ops import cuda, kernel as K
    from dragonboat_tpu_torch.ops.state import make_empty_inbox

    dev = torch.device("cuda", 0)
    cuda.build_kernels()

    import chip_smoke  # the checkout's own, for its phase-3 input

    with contextlib.redirect_stdout(io.StringIO()):
        lcfg, kept, _ = chip_smoke.phase_cluster(K, cuda)

    def device_ms(fn, setup, names):
        """Mean device ms per launch of each named kernel over REPS calls
        (kept here, not taken from the package: older checkouts lack it)."""
        setup()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                setup()
                fn()
            torch.cuda.synchronize()
        got = {n: 0.0 for n in names}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            for n in names:
                if e.key == n or e.key.startswith(n + "("):
                    got[n] = t / 1e3 / e.count
        return got

    # config 6's state after windows 0-2, and window 3's inbox
    cfg = kb.superstep_config(1024, 3)
    s0, route, rdelta = kb.superstep_cluster(1024, 3, cfg, dev)
    multi = K.make_multi_step_fn(cfg, 8)
    ticks = torch.ones((cfg.groups,), dtype=torch.int32, device=dev)
    resid = make_empty_inbox(cfg, dev)
    rc = torch.zeros((cfg.groups,), dtype=torch.int32, device=dev)
    leaders = np.zeros(1024, np.int64)
    rng = np.random.default_rng(20261016)
    st = K.clone_state(s0)
    for w in range(4):
        ib, leaders = kb.host_window(w, rc, leaders, 1024, 3, cfg, rng, dev)
        if w == 3:
            break
        st, _, _, resid, rc = multi(st, ib, ticks, resid, route, rdelta)
        kb.compact(st)
    ib = K.merge_residual(resid, ib)
    first = lambda t: type(t)(*(x[:1024].contiguous() for x in t))
    bench = kb.run_kernel_bench(50_000, 5, 5, 512, device="cuda")
    cases = {
        "1024_loopback": (lcfg, *kept[len(kept) // 2]),
        "1024": (cfg._replace(groups=1024), first(st), first(ib), ticks[:1024].contiguous()),
        "3072": (cfg, st, ib, ticks),
        "50000": (bench["cfg"], bench["state"], bench["inbox"], bench["ticks"]),
    }
    res = {"step_batch_ms": {}}
    for name, (c, s, inbox, tk) in cases.items():
        work = K.clone_state(s)
        _, out = cuda.prepare_step(work, inbox, tk, c)

        def restore(work=work, s=s):
            for a, b in zip(work, s):
                a.copy_(b)
        res["step_batch_ms"][name] = device_ms(
            lambda: cuda.step_batch_cuda(work, inbox, tk, c, out=out), restore,
            ["step_batch_kernel"])["step_batch_kernel"]

    after, o = cuda.step_batch_cuda(K.clone_state(st), ib, ticks, cfg)
    names = ["route_columns_kernel", "route_index_kernel", "route_scatter_kernel",
             "ring_gather_kernel"]
    res["router_unsharded_ms"] = device_ms(
        lambda: cuda.route_step_output_cuda(after, o, route, rdelta, cfg), lambda: None, names)
    n = 4
    parts = [K.shard_tree(x, n) for x in (after, o, route, rdelta)]
    res["router_4_shards_ms_per_launch"] = device_ms(
        lambda: cuda.shard_route_cuda(*parts, cfg), lambda: None, names)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="root of a checkout to time (repeat to compare; default: this one)")
    ap.add_argument("--run-here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run_here:
        # this checkout's package, not the one beside the script
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path[:] = [os.getcwd()] + [p for p in sys.path if os.path.abspath(p or ".") != here]
        import torch

        if not torch.cuda.is_available():
            print("compare_kernels: no CUDA device is available", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(json.dumps({"tree": os.getcwd(), "card": card, **_run_tree()}), flush=True)
        return 0
    me = os.path.abspath(__file__)
    for tree in args.tree or [os.path.dirname(me)]:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        rc = subprocess.run([sys.executable, me, "--run-here"], cwd=root, env=env).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
