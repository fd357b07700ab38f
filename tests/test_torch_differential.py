"""Twin of tests/test_differential.py on the PyTorch port.

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the port's LoopbackCluster (the plain step on the
CPU) in lockstep with the port's scalar core through election and
replication, the counter plane against the scalar event counts, leader
transfer, and (slow, as in the reference) the randomized fault schedules of
seeds 3 and 17.

Leader transfer shares the module-scoped `clusters` with the election test,
so it found a leader only when that test had run first in the same
process; under xdist it may not have (`leader_of(0)` was None). Here it
first runs lockstep rounds, observables held equal after each, until both
sides agree on a leader (`settle_leader`), then runs the reference body.

The tests below run the same lockstep scripts through both packages and
hold every round's observables and counter planes equal."""
import importlib

from torch_twin import cluster_counters, port_copy, recording, reference_tests

R = port_copy("test_differential")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_differential")


def settle_leader(M, kc, sc, rounds=60):
    """Lockstep rounds until both sides name the same leader."""
    for rnd in range(rounds):
        slead = [nid for nid, r in sc.rafts.items() if r.is_leader()]
        if kc.leader_of(0) is not None and slead and slead[0] - 1 == kc.leader_of(0):
            return
        M.run_round(kc, sc)
        ko, so = M.kernel_observables(kc), sc.observables()
        assert ko == so, f"settle round {rnd}: kernel={ko} scalar={so}"
    raise AssertionError("no leader settled")


def test_differential_leader_transfer(clusters):
    kc, sc = clusters
    settle_leader(R, kc, sc)
    R.test_differential_leader_transfer(clusters)


def traced(M, body):
    with recording(M, ["kernel_observables"]) as obs, cluster_counters(M) as ctr:
        body()
    return obs["kernel_observables"], ctr


def fresh_clusters(M):
    kc = M.LoopbackCluster(n_replicas=M.N, n_groups=1, election=M.ELECTION,
                           heartbeat=M.HEARTBEAT)
    seed = int(M.np.asarray(kc.states[0].seed)[0])
    return kc, M.ScalarCluster(seed_of_group=seed)


def test_counters_trace_matches_reference():
    ref = traced(_ref(), _ref().test_differential_counters_match_scalar)
    port = traced(R, R.test_differential_counters_match_scalar)
    assert len(port[0]) == 32 and port == ref


def test_election_replication_and_transfer_trace_matches_reference():
    logs = {}

    def script(M):
        kc, sc = clusters = fresh_clusters(M)
        M.test_differential_election_and_replication(clusters)
        settle_leader(M, kc, sc)
        M.test_differential_leader_transfer(clusters)
        hi = sc.observables()[0]["committed"]
        logs[M.__name__] = [kc.ring_terms(h, 0, 1, hi) for h in range(M.N)]

    ref = traced(_ref(), lambda: script(_ref()))
    port = traced(R, lambda: script(R))
    assert len(port[0]) == 48 and port == ref
    assert logs[R.__name__] == logs["test_differential"]
