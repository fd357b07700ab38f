"""Twin of tests/test_crash_safety.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the NodeHost directory lock, the ref-counted SM
offload, the SM destroyed exactly once on stop, and a node crashed mid
`save_snapshot`, restarted with the save still parked, rejoining with
converged replicas and a linearizable history, at the reference's ticks.
`test_destroy_counts_match_reference` runs the stop body through both
packages' NodeHosts and holds the close counts equal."""
import importlib

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_crash_safety")
globals().update(reference_tests(R))


def destroyed(M, root) -> int:
    M.test_sm_destroyed_exactly_once_on_stop(root)
    return M.DestroySM.destroyed


def test_destroy_counts_match_reference(tmp_path):
    ref = destroyed(importlib.import_module("test_crash_safety"), tmp_path / "ref")
    assert destroyed(R, tmp_path / "port") == ref
