"""Three of chip_smoke.py's measurements alone, on the card, against the
PyTorch port of any checkout, so that a parent and its change are read in
one call on one card.

    python3 tree_probe.py teardown [--tree DIR] [--groups G] [--cycles N]
    python3 tree_probe.py bring_up [--tree DIR] [--groups G]
    python3 tree_probe.py activation [--tree DIR]

The port is imported from DIR (default: this checkout); the measuring code
is this checkout's `chip_smoke.py`. To compare a parent, unpack it with
`git archive` into a gitignored directory and run the script once for each
tree, in turns (parent, change, change, parent).

- `teardown`: `chip_smoke.teardown_cycles` (ROADMAP §3 fault 13) with the
  card's memory history recording, so every block a stop leaves before the
  cycle collector runs is summed by its allocating frame. Exits 1 when a
  shape's `device_memory_freed_on_stop` fails.
- `bring_up`: config 2's bring-up (3 NodeHosts x G groups on one K=1 core,
  P=4, W=256, 10 ms ticks, elections of 300 ticks, heartbeats of 30): the
  activation batches by size (`ACTIVATIONS`), the host seconds the engine's
  loop spent in `_activate_batch` (the lanes' values and the batches) and
  in `_activate_rows` (the batches' copies and launches), the seconds of
  the three `start_clusters` calls, the seconds until every group has a
  leader, and the engine steps run by then.
- `activation`: the activation kernel (csrc/activate.cu) at phase 3's two
  shapes (3,072 lanes at P=4 and 50,000 at P=5, W=256, a 4,096-row
  bucket), its lane rows scattered (phase 3's) and consecutive (a
  bring-up's), bit for bit against the plain version, timed warm and with
  a cold L2 (a buffer of 4x the L2 written, or read, before each launch);
  where the tree's parameter struct has them, also in parts: every row
  skipped (the launch, the tile loads and the blocks), the [W] planes
  only, the scalar and row planes only.

Each prints its record as one JSON line and the card's name and power
limit.
"""
import argparse
import os
import sys
import tempfile
import time


def bring_up(cs, groups, device="cuda"):
    """Config 2's bring-up on `device` through NodeHost, timed."""
    from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.ops.cuda import build_kernels
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    if device == "cuda":
        build_kernels()
    spent = {"_activate_batch": 0.0, "_activate_rows": 0.0}

    def timed(name):
        def wrap(f):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    spent[name] += time.perf_counter() - t
            return call
        return wrap

    reg, kv, hosts = _Registry(), cs._kv_sm(), {}
    members = {n: f"bench:{n}" for n in (1, 2, 3)}
    vector.ACTIVATIONS.clear()
    with tempfile.TemporaryDirectory(prefix="dbtorch-bring-up-") as d, cs._patched(
            [(vector.VectorEngine, n, timed(n)) for n in spent]):
        try:
            for n, addr in members.items():
                hosts[n] = NodeHost(NodeHostConfig(
                    raft_address=addr, rtt_millisecond=10, nodehost_dir=f"{d}/nh{n}",
                    raft_rpc_factory=lambda a: loopback_factory(a, reg),
                    engine=EngineConfig(
                        kind="vector", max_groups=3 * groups, max_peers=4, log_window=256,
                        inbox_depth=4, max_entries_per_msg=64, steps_per_sync=1,
                        share_scope=f"bring-up-{id(reg)}", profile_sample_ratio=1,
                        device=device)))
            t0 = time.monotonic()
            for n, nh in hosts.items():
                nh.start_clusters([
                    (dict(members), False, lambda c, _n: kv(),
                     Config(node_id=n, cluster_id=c, election_rtt=300, heartbeat_rtt=30))
                    for c in range(1, groups + 1)])
            start_s = time.monotonic() - t0
            elect_s, leaders = cs._elect_all(hosts[1], groups, 180.0)
            steps = hosts[1].engine.step_stats()["steps"]
        finally:
            for nh in hosts.values():
                nh.stop()
    return {"groups": groups, "lanes": 3 * groups, **cs._activation_batches(),
            "activate_batch_s": round(spent["_activate_batch"], 4),
            "activate_rows_s": round(spent["_activate_rows"], 4),
            "start_clusters_s": round(start_s, 3), "elect_all_s": round(start_s + elect_s, 3),
            "elected": len(leaders), "steps": steps}


def activation(cs, reps=30):
    """The activation kernel at phase 3's two shapes, whole and in parts,
    warm and cold, its lane rows scattered and consecutive."""
    import ctypes

    import numpy as np
    import torch

    from dragonboat_tpu_torch import kernel_bench as kb
    from dragonboat_tpu_torch.engine import vector
    from dragonboat_tpu_torch.ops import cuda
    from dragonboat_tpu_torch.ops.kernel import clone_state

    cuda.build_kernels()
    rng = np.random.default_rng(cs.ACT_SEED)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    flush = torch.empty((4 * l2,), dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    parts = hasattr(cuda.ActivateParams, "n_small")
    out = {}
    for lanes, P, W, bucket in ((3072, 4, 256, 4096), (50_000, 5, 256, 4096)):
        s0 = cs._act_state(cs._act_cfg(lanes, P, W), rng)
        for order in ("scattered", "consecutive"):
            rows, vals = cs._act_batch(rng, lanes, min(bucket, lanes), P, W)
            if order == "consecutive":
                start = int(rng.integers(0, lanes - len(rows) + 1))
                rows = list(range(start, start + len(rows)))
            packed = vector.pack_activation(rows, vals, bucket, P, W).to("cuda")
            gi, v = cs._act_plain_inputs(rows, vals, bucket)
            want = vector.activate_lanes_reference(clone_state(s0), gi, v)
            got = cuda.activate_cuda(clone_state(s0), packed, bucket)
            work = clone_state(s0)

            def part(edit):
                def go():
                    p = cuda.activate_params(work, packed, bucket)
                    edit(p)
                    if cuda._lib("activate.cu").activate_launch(ctypes.byref(p), stream):
                        raise RuntimeError("activate_launch failed")
                return go

            def skip_all(p):
                p.G = 0

            def window_only(p):
                p.n_small = 1

            def small_only(p):
                p.window[0].row_bytes = p.window[1].row_bytes = 0

            cases = {"whole": lambda: cuda.activate_cuda(work, packed, bucket)}
            if parts:
                cases.update(rows_skipped=part(skip_all), window_planes_only=part(window_only),
                             small_planes_only=part(small_only))
            nbytes = cs.act_bytes(s0, rows, bucket)
            r = {"mismatched_planes": cs.act_mismatches(want, got)[0], "bytes": nbytes,
                 "bound_ms": nbytes / kb.HBM_BYTES_PER_S * 1e3}
            for name, fn in cases.items():
                r[name] = {how: kb.device_ms(fn, setup, reps, ["activate_kernel"])["activate_kernel"]
                           for how, setup in (("warm", lambda: None), ("cold", flush.zero_),
                                              ("cold_read", lambda: flush.max()))}
            out[f"{lanes}x{bucket}_{order}"] = r
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("teardown", "bring_up", "activation"))
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--groups", type=int, default=None,
                    help="groups per host (teardown 32, bring_up 1024)")
    ap.add_argument("--cycles", type=int, default=3)
    a = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("tree_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import importlib.util

    # this checkout's chip_smoke.py, whichever tree the port comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import json

    import dragonboat_tpu_torch

    tree = os.path.dirname(os.path.dirname(dragonboat_tpu_torch.__file__))
    card = cs.card_line()
    cs.log(f"tree {tree}; card: {card}")
    if a.probe == "activation":
        res = activation(cs)
        cs.log("activation: " + json.dumps({"tree": tree, "card": card, **res}))
        bad = {k: r["mismatched_planes"] for k, r in res.items() if r["mismatched_planes"]}
        return 1 if bad else 0
    if a.probe == "bring_up":
        cs.log("bring_up: " + json.dumps({"tree": tree, "card": card,
                                          **bring_up(cs, a.groups or 1024)}))
        return 0
    # Python frames only: C++ stacks make every allocation slow
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=200_000)
    try:
        cs.teardown_cycles("cuda", card, groups=a.groups or cs.TEARDOWN_GROUPS, cycles=a.cycles)
    except AssertionError as e:
        cs.log(f"tree_probe: {e}")
        return 1
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
