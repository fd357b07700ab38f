"""Lease lapse under a fixed stall, through both packages (ROADMAP §3
fault 5).

    JAX_PLATFORMS=cpu python3 lease_lapse.py [--stall 0.02] [--election-rtt 10]

Runs the script of tests/test_torch_engine_reads_churn.py (5 hosts on one
shared vector-engine core, 4 groups, lease reads in groups 1-2) through the
JAX package's NodeHost and then the port's, both on the CPU, with a fixed
sleep injected before every engine loop iteration (`VectorEngine._run_once`)
so that the comparison does not depend on the machine's load. Prints one
JSON line per package: engine steps, the ticks each step applied
(`_last_tick_burst`) as a histogram, the lease lanes' tick caps
(`_m_tick_cap`), the median time of one loop iteration without the stall,
how old each leader's heartbeat round was at every step (ticks since
`hb_round_tick`), the share of leader steps that held a live lease, and the
lease reads served against fallen back (`lease_stats`; the script's quiet
phase adds its own serves where a lease is live, and where none ever is the
script stops there with the counts so far).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))


def _hist(values):
    import numpy as np

    keys, counts = np.unique(np.asarray(values, dtype=np.int64), return_counts=True)
    return {int(k): int(c) for k, c in zip(keys, counts)}


def run(pkg: str, script, stall: float) -> dict:
    import numpy as np
    import torch

    V = importlib.import_module(pkg + ".engine.vector")
    ROLE_LEADER = 2
    orig = V.VectorEngine._run_once
    bursts, iteration_s, ages, live, caps, lease = [], [], [], [], set(), {}

    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def stalled(self):
        time.sleep(stall)
        t0 = time.perf_counter()
        orig(self)
        iteration_s.append(time.perf_counter() - t0)
        bursts.append(int(self._last_tick_burst))
        # the port's unsharded engine keeps its state in its one shard
        s = self._shards[0].state if hasattr(self, "_shards") else self._state
        lanes = np.nonzero(host(s.lease_on) & (host(s.role) == ROLE_LEADER))[0]
        caps.update(self._m_tick_cap[lanes].tolist())
        tick = host(s.tick_count)[lanes]
        ages.extend((tick - host(s.hb_round_tick)[lanes]).tolist())
        live.extend((host(s.lease_until)[lanes] > tick).tolist())
        lease.update(self.lease_stats())

    V.VectorEngine._run_once = stalled
    t0 = time.monotonic()
    error = None
    try:
        lease.update(script.run_script(pkg)["lease"])
    except AssertionError as e:
        error = str(e)
    finally:
        V.VectorEngine._run_once = orig
    return {
        "package": pkg, "stall_s": stall, "election_rtt": script.ELECTION_RTT,
        "seconds": round(time.monotonic() - t0, 1), "error": error,
        "engine_steps": len(bursts), "steps_without_ticks": sum(b == 0 for b in bursts),
        "ticks_per_step": _hist(bursts), "tick_caps": sorted(caps),
        "iteration_ms_median": round(1e3 * float(np.median(iteration_s)), 2),
        "round_age_ticks": _hist(ages),
        "leader_steps": len(live),
        "live_lease_share": round(float(np.mean(live)), 4) if live else None,
        "lease_served": lease.get("local"), "lease_fallback": lease.get("fallback"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stall", type=float, default=0.02,
                    help="seconds slept before every engine loop iteration")
    ap.add_argument("--election-rtt", type=int, default=10)
    args = ap.parse_args(argv)
    from dragonboat_tpu._jaxenv import pin_cpu

    pin_cpu(n_devices=8)
    import torch

    torch.set_num_threads(1)
    import test_torch_engine_reads_churn as script

    script.ELECTION_RTT = args.election_rtt
    for pkg in ("dragonboat_tpu", "dragonboat_tpu_torch"):
        print(json.dumps(run(pkg, script, args.stall)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
