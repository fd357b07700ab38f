"""Two of chip_smoke.py's measurements alone, on the card, against the
PyTorch port of any checkout, so that a parent and its change are read in
one call on one card.

    python3 tree_probe.py teardown [--tree DIR] [--groups G] [--cycles N]
    python3 tree_probe.py bring_up [--tree DIR] [--groups G]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("teardown", "bring_up"))
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
