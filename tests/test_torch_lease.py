"""Twin of tests/test_lease.py on the PyTorch port.

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the scalar lease FSM (`TestScalarLease`), the
kernel's lease-off guard and its lease grant and local read (the port's
LoopbackCluster over the plain step on the CPU), the randomized-fault
differential of the kernel against the port's scalar core (seeds 5 and 23),
the lease probe API and fallback on both engines, and the clock-jump
degradation, at the reference's ticks.

The tests below run the kernel-level bodies through both packages on the
same seeds and hold every step's observables (role, term, leader, commit,
last index, lease validity) and counter planes (served and fallback
included) equal, and run the vector probe body through both packages'
NodeHosts in one test."""
import importlib

import pytest

from torch_twin import cluster_counters, one_thread, port_copy, recording, reference_tests  # noqa: F401,E501

R = port_copy("test_lease")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_lease")


def traced(M, body, *args):
    with recording(M, ["_kernel_observables"]) as obs, cluster_counters(M) as ctr:
        body(*args)
    return obs["_kernel_observables"], ctr


@pytest.mark.parametrize("seed", [5, 23])
def test_lease_differential_traces_match_reference(seed):
    ref = traced(_ref(), _ref().test_differential_lease_randomized_faults, seed)
    port = traced(R, R.test_differential_lease_randomized_faults, seed)
    assert len(port[0]) == 120 and port == ref
    assert any(o["lease"] for step in port[0] for o in step)


@pytest.mark.parametrize("body", ["test_kernel_lease_grant_and_local_read",
                                  "test_kernel_lease_off_tensors_never_move"])
def test_kernel_lease_counters_match_reference(body):
    ref = traced(_ref(), getattr(_ref(), body))[1]
    port = traced(R, getattr(R, body))[1]
    assert port and port == ref


def test_lease_probe_in_both_packages(tmp_path):
    _ref().test_lease_probe_api_and_fallback(tmp_path / "ref", "vector")
    R.test_lease_probe_api_and_fallback(tmp_path / "port", "vector")
