"""Twin of tests/test_streamed_install.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the Chunks resume protocol (resume skips durable
chunks, a torn tail is truncated, an incompatible partial starts clean, a
failed validation purges the partial, an abort notifies the NodeHost), the
typed `ErrSnapshotStreamAborted` and its retry hint, the engine's cadence
while a lane's install takes seconds (`_send_snapshot` and the snapshot
worker), the parked scalar remote, and (slow, as in the reference) the
install resumed after a host crash mid-stream, at the reference's ticks.

The tests below run the Chunks bodies through both packages and hold
every tracker's stats and what each receiver got equal, and run the
typed-abort body through both packages' NodeHosts in one test."""
import importlib
import os

from torch_twin import instances, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_streamed_install")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_streamed_install")


CHUNK_TESTS = ("test_chunks_resume_skips_durable_chunks",
               "test_chunks_resume_truncates_torn_tail",
               "test_chunks_incompatible_partial_starts_clean",
               "test_chunks_validation_failure_purges_partial",
               "test_chunks_abort_notifies_nodehost")


def chunk_trace(M, root):
    """The reference's Chunks bodies: every tracker's stats and what each
    fake NodeHost received (snapshot index and image size, aborts)."""
    with instances(M, ["Chunks", "_FakeNH"]) as made:
        for name in CHUNK_TESTS:
            d = root / name
            d.mkdir(parents=True)
            getattr(M, name)(d)
    return ([c.stats() for c in made["Chunks"]],
            [([(m.snapshot.index, os.path.getsize(m.snapshot.filepath)) for m in nh.delivered],
              nh.aborts) for nh in made["_FakeNH"]])


def test_chunk_traces_match_reference(tmp_path):
    port = chunk_trace(R, tmp_path / "port")
    assert port == chunk_trace(_ref(), tmp_path / "ref")
    assert any(st["resumed_streams"] and st["skipped_chunks"] for st in port[0])


def test_aborted_install_fails_reads_fast_in_both_packages(tmp_path):
    _ref().test_err_snapshot_stream_aborted_fails_reads_fast(tmp_path / "ref")
    R.test_err_snapshot_stream_aborted_fails_reads_fast(tmp_path / "port")
