"""Twin of tests/test_witness_lanes.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the witness lane's zero payload and role, the
witness in the commit quorum, observer promotion, witness removal and
rejoin, and the witness on a co-hosted K>1 shared core (the router path),
at the reference's ticks. `test_witness_verdicts_match_reference` runs one
scenario through both packages' NodeHosts and holds the verdicts equal."""
import importlib
import time

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_witness_lanes")
globals().update(reference_tests(R))


def witness_verdicts(M) -> dict:
    """Two full members, a witness joined through the membership API, 20
    proposals: what the witness lane and the SMs show."""
    reg = M._Registry()
    hosts = {nid: M._mk_host(nid, reg) for nid in (1, 2, 3)}
    try:
        for nid in (1, 2):
            hosts[nid].start_cluster({1: "wl1:1", 2: "wl2:1"}, False,
                                     lambda c, n: M.KV(), M._cfg(nid))
        leader = M._wait_leader({n: hosts[n] for n in (1, 2)})
        hosts[leader].sync_request_add_witness(M.CLUSTER, 3, "wl3:1", timeout_s=10.0)
        hosts[3].start_cluster({}, True, lambda c, n: M.KV(), M._cfg(3, is_witness=True))
        M._propose_n(hosts[leader], 20, "x")
        deadline = time.monotonic() + 20
        st = None
        while time.monotonic() < deadline:
            st = hosts[3].engine.lane_stats().get(M.CLUSTER)
            if st is not None and st["leader_id"] == leader:
                break
            time.sleep(0.05)
        empty = M.KV().get_hash()
        m = hosts[leader].get_cluster_membership(M.CLUSTER)
        return {
            "witness_role": st["role"] if st else None,
            "witness_payload_bytes": st["payload_bytes"] if st else None,
            "witness_follows_leader": st is not None and st["leader_id"] == leader,
            "witness_sm_empty": hosts[3].get_sm_hash(M.CLUSTER) == empty,
            "leader_sm_applied": hosts[leader].get_sm_hash(M.CLUSTER) != empty,
            "witnesses": sorted(m.witnesses),
            "voters": sorted(m.addresses),
        }
    finally:
        for nh in hosts.values():
            nh.stop()


def test_witness_verdicts_match_reference():
    ref = witness_verdicts(importlib.import_module("test_witness_lanes"))
    port = witness_verdicts(R)
    assert port == ref
    assert port["witness_role"] == R.ROLE.WITNESS and port["witness_payload_bytes"] == 0
    assert port["witness_sm_empty"] and port["leader_sm_applied"]
