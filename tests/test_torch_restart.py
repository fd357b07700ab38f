"""Twin of tests/test_restart.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`), at the reference's ticks: a group stopped and
restarted, or crashed and restarted, rejoining its live peers; a crash
restart that installs a snapshot; every node crash-restarted in cycles
(slow); the FaultPlane's crash schedule and WAL tears; 50 restarts of one
vector lane leaking nothing; the quorum's throughput while a peer is down.

The test below runs the 50-restart body through both packages' NodeHosts
and holds equal, after every stop, crash and restart, the engine's free
list and the lane the group holds."""
import importlib

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_restart")
globals().update(reference_tests(R))


def lanes(nh, _result):
    """The core's free list length and its lanes' indexes."""
    core = nh.engine.core
    with core._lanes_mu:
        return len(core._free), sorted(lane.g for lane in core._lanes.values())


def lane_cycles(M, pkg, path):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    with calls(NH, ("stop_cluster", "crash_cluster", "restart_cluster"), lanes) as got:
        M.test_vector_lane_reuse_50_restarts_no_growth(path)
    return got


def test_lane_reuse_matches_reference(tmp_path):
    ref = lane_cycles(importlib.import_module("test_restart"), "dragonboat_tpu",
                      tmp_path / "ref")
    port = lane_cycles(R, "dragonboat_tpu_torch", tmp_path / "port")
    assert len(port) == 100
    assert port == ref
