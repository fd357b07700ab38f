"""Twin of tests/test_prevote.py on the PyTorch port.

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the scalar pre-vote FSM (`TestScalarPreVote`),
the randomized-fault differential of the port's LoopbackCluster (plain step
on the CPU, pre-vote on) against the port's scalar core (seeds 3 and 17),
and the rejoin storm with pre-vote on and off.

The tests below run the same seeded differential through both packages and
hold every step's observables and counter planes equal, and run the rejoin
storm's schedule (chip_smoke.py's `reference_storm`) through both
packages' LoopbackClusters with equal leaders, terms and election
counters, pre-vote on and off."""
import importlib

import pytest

from torch_twin import cluster_counters, port_copy, recording, reference_tests

R = port_copy("test_prevote")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_prevote")


@pytest.mark.parametrize("seed", [3, 17])
def test_prevote_differential_traces_match_reference(seed):
    def traced(M):
        with recording(M, ["_kernel_observables"]) as obs, cluster_counters(M) as ctr:
            M.test_differential_prevote_randomized_faults(seed)
        return obs["_kernel_observables"], ctr

    ref, port = traced(_ref()), traced(R)
    assert len(port[0]) == 120 and port == ref


@pytest.mark.parametrize("prevote", [True, False], ids=["prevote-on", "prevote-off"])
def test_rejoin_storm_matches_reference(prevote, monkeypatch):
    """chip_smoke.reference_storm, the schedule of
    test_rejoin_storm_prevote_on_vs_off that phase 11 prints beside its
    own counts, through the port's LoopbackCluster and the JAX
    package's."""
    import chip_smoke
    from dragonboat_tpu.ops.loopback import LoopbackCluster as JCluster
    from dragonboat_tpu_torch.ops import loopback

    port = chip_smoke.reference_storm(prevote, "cpu")
    monkeypatch.setattr(loopback, "LoopbackCluster",
                        lambda *a, device=None, **kw: JCluster(*a, **kw))
    assert port == chip_smoke.reference_storm(prevote, "cpu")
    if prevote:
        assert port["leader_after"] == port["leader"]
        assert port["terms_after"] == port["terms_before"]
    else:
        assert port["terms_after"] != port["terms_before"]
