"""Twin of tests/test_snapshot_lanes.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the rate limiter's throttle and its unlimited
mode, the per-target and total snapshot lane caps failing fast on a slow
sink, and the send bandwidth cap, on a vector-engine NodeHost.
`test_bandwidth_cap_in_both_packages` runs the bandwidth-cap body through
both packages' NodeHosts in one test."""
import importlib

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_snapshot_lanes")
globals().update(reference_tests(R))


def test_bandwidth_cap_in_both_packages(tmp_path):
    importlib.import_module("test_snapshot_lanes").test_send_bandwidth_cap_applies(tmp_path / "r")
    R.test_send_bandwidth_cap_applies(tmp_path / "p")
