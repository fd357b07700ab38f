"""Twin of tests/test_chaos.py on the PyTorch port (CPU engines).

The reference's test runs here with its names bound to the port
(`torch_twin.port_copy`), slow as there, on both engines at its seed
(0xD5A60): three hosts under client traffic while one seeded FaultPlane
drops 30% of a victim's messages, partitions hosts and kills and restarts
them from their directories; afterwards the history is linearizable, the
replicas' state machines and applied indexes agree and the persisted logs
obey Log Matching. The reference's ticks.

`test_fault_loop_matches_reference` holds that test's fault loop equal
across packages at its seed and three more: the orchestration draws
(fault kind, victim, window) and a victim's per-message wire drops."""
import importlib

import pytest

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_chaos")
globals().update(reference_tests(R))


def fault_loop(pkg, seed, rounds=60):
    F = importlib.import_module(pkg + ".faults")
    T = importlib.import_module(pkg + ".types")
    fp = F.FaultPlane(seed, F.FaultSpec(drop=0.3))
    loop = []
    for _ in range(rounds):
        fault = fp.choice("faultloop", "fault", ["partition", "drop", "restart", "none"])
        victim = fp.choice("faultloop", "victim", (1, 2, 3))
        lo, hi = {"restart": (0.1, 0.3)}.get(fault, (0.3, 0.8))
        loop.append((fault, victim, fp.uniform("faultloop", "window", lo, hi)
                     if fault != "none" else None))
    hook = fp.batch_hook("wire:h1")
    kept = []
    for i in range(40):
        b = T.MessageBatch(requests=[T.Message(type=T.MessageType.REPLICATE, cluster_id=1,
                                               to=2, from_=1, log_index=8 * i + j)
                                     for j in range(8)])
        hook(b)
        kept.append([m.log_index for m in b.requests])
    return loop, kept


@pytest.mark.parametrize("seed", [0xD5A60, 1, 2, 3])
def test_fault_loop_matches_reference(seed):
    ref = fault_loop("dragonboat_tpu", seed)
    port = fault_loop("dragonboat_tpu_torch", seed)
    assert port == ref
    assert 0 < sum(map(len, port[1])) < 320  # some, not all, dropped
