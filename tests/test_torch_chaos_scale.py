"""Twin of tests/test_chaos_scale.py on the PyTorch port (CPU engines).

The reference's test runs here with its names bound to the port
(`torch_twin.port_copy`), slow as there: 256 groups x 3 replicas in one
shared core under its fault spec at its seed (0xC0FFEE): 25% of co-hosted
REPLICATE/REPLICATE_RESP traffic dropped, host partitions, NodeHost kills
and restarts from their directories, with bulk load on the other groups.
It asserts its three invariants: every group's replicas at one applied
index and SM hash, the sampled groups' histories linearizable, and Log
Matching below the commit point of their persisted logs. The reference's
ticks.

`test_fault_schedule_matches_reference` holds that test's fault schedule
equal across packages at its seed and three more: the orchestration draws
(fault kind, victim, window) and the co-hosted drop decisions, which only
REPLICATE and REPLICATE_RESP may take."""
import importlib

import pytest

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_chaos_scale")
globals().update(reference_tests(R))


def _fault_loop(pkg, seed, rounds=60):
    """The test's orchestration draws (fault, victim, window) and its
    co-hosted drop decisions on a seeded stream of replication messages,
    from `pkg`'s FaultPlane at the test's spec."""
    F = importlib.import_module(pkg + ".faults")
    T = importlib.import_module(pkg + ".types")
    fp = F.FaultPlane(seed, F.FaultSpec(drop=0.25, only_types=F.REPLICATION_TYPES))
    loop = []
    for _ in range(rounds):
        fault = fp.choice("faultloop", "fault", ["partition", "drop", "restart", "none"])
        victim = fp.choice("faultloop", "victim", (1, 2, 3))
        lo, hi = {"restart": (0.2, 0.5)}.get(fault, (0.4, 1.0))
        loop.append((fault, victim, fp.uniform("faultloop", "window", lo, hi)
                     if fault != "none" else None))
    hook = fp.message_hook("local:core")
    kinds = [T.MessageType.REPLICATE, T.MessageType.REPLICATE_RESP, T.MessageType.HEARTBEAT]
    drops = [hook(T.Message(type=kinds[i % 3], cluster_id=1 + i % 256, to=1 + i % 3,
                            from_=1 + (i + 1) % 3)) for i in range(600)]
    return loop, drops


@pytest.mark.parametrize("seed", [0xC0FFEE, 1, 2, 3])
def test_fault_schedule_matches_reference(seed):
    ref = _fault_loop("dragonboat_tpu", seed)
    port = _fault_loop("dragonboat_tpu_torch", seed)
    assert port == ref
    assert {f for f, _v, _w in port[0]} == {"partition", "drop", "restart", "none"}
    assert any(port[1]) and not any(port[1][2::3])  # heartbeats never drop
