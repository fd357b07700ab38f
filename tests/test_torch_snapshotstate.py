"""Twin of tests/test_snapshotstate.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`), at the reference's ticks: the snapshot task slot
and state flags, a second snapshot request with nothing newly applied
rejected on either engine, and a periodic snapshot finalized through the
step loop.

The test below runs the duplicate-request body on the vector engine through
both packages' NodeHosts and holds equal the indexes of the snapshots that
were taken."""
import importlib

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_snapshotstate")
globals().update(reference_tests(R))


def snapshot_indexes(M, pkg, path):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    with calls(NH, ("sync_request_snapshot",)) as got:
        M.test_duplicate_snapshot_request_ignored(path, "vector")
    return [r for _n, r in got]


def test_snapshot_indexes_match_reference(tmp_path):
    ref = snapshot_indexes(importlib.import_module("test_snapshotstate"), "dragonboat_tpu",
                           tmp_path / "ref")
    port = snapshot_indexes(R, "dragonboat_tpu_torch", tmp_path / "port")
    assert len(port) == 2 and port[1] > port[0] > 0
    assert port == ref
