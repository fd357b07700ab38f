"""Twin of tests/test_vector_scale.py on the PyTorch port (CPU engines).

Both tests of the reference file run here with its names bound to the port
(`torch_twin.port_copy`), slow as there: 1,024 single-replica lanes on one
NodeHost elect and each commits a proposal, and 256 quiesced lanes cost no
host work (every lane quiesced, the transport's metrics unchanged over an
idle second, a fresh proposal waking its lane and committing), at the
reference's ticks.

`test_quiesced_lanes_in_both_packages` runs the quiesce body through both
packages' NodeHosts and holds their bring-ups equal: no lane left without
a leader in either. The body asserts the rest of its verdicts in each."""
import importlib

import pytest

from torch_twin import one_thread, port_copy, recording, reference_tests  # noqa: F401

R = port_copy("test_vector_scale")
globals().update(reference_tests(R))


@pytest.mark.slow
def test_quiesced_lanes_in_both_packages():
    pending = []
    for M in (importlib.import_module("test_vector_scale"), R):
        with recording(M, ["_wait_leaders"]) as got:
            M.test_idle_quiesced_lanes_cost_no_host_work()
        pending.append(got["_wait_leaders"])
    assert pending[1] == pending[0] == [set()]
