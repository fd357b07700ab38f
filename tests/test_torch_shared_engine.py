"""Twin of tests/test_shared_engine.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): `share_scope` core identity, commit and read
through one shared core with no wire traffic, release keeping the core
alive, and the overlapped (pipelined) decode, at the reference's ticks.
`test_overlapped_decode_in_both_packages` runs the pipelined-decode body
through both packages' NodeHosts in one test."""
import importlib

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_shared_engine")
globals().update(reference_tests(R))


def test_overlapped_decode_in_both_packages(tmp_path):
    importlib.import_module("test_shared_engine").test_overlapped_decode_pipeline(tmp_path / "ref")
    R.test_overlapped_decode_pipeline(tmp_path / "port")
