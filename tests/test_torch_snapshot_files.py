"""Twin of tests/test_snapshot_files.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`), at the reference's ticks: a snapshot's external
files shipped to a replica that installs it (slow), and handed back to the
state machine on a restart from a local snapshot.

The test below runs the local-restart body through both packages' vector
engines and holds equal the snapshot's index and what the restarted host
reads back."""
import importlib

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_snapshot_files")
globals().update(reference_tests(R))


def restart_reads(M, pkg, path):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    with calls(NH, ("sync_request_snapshot", "stale_read")) as got:
        M.test_external_files_survive_local_restart(path)
    reads = [r for n, r in got if n == "stale_read"]
    # the body polls its first read, then asserts both
    return [r for n, r in got if n == "sync_request_snapshot"], reads[-2:]


def test_local_restart_matches_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = restart_reads(importlib.import_module("test_snapshot_files"), "dragonboat_tpu",
                        tmp_path / "ref")
    port = restart_reads(R, "dragonboat_tpu_torch", tmp_path / "port")
    assert port[0][0] > 0 and port[1][0] == b"ext-meta-v1"
    assert port == ref
