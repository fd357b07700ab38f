"""Twin of tests/test_propose_batch.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`), at the reference's ticks: a batch of proposals
applied in submission order on either engine, a batch past the proposal
queue dropping its tail, and the one-handle asynchronous batch.

The test below runs the in-order body on the vector engine through both
packages' NodeHosts and holds equal what each proposal of the batch
returned and what the stale reads saw."""
import importlib

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_propose_batch")
globals().update(reference_tests(R))


def applied(M, pkg, path):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    with calls(NH, ("propose_batch", "stale_read")) as got:
        M.test_propose_batch_commits_in_order(path, "vector")
    batches = [[(rs.result.code, rs.result.result.value) for rs in r]
               for n, r in got if n == "propose_batch"]
    return batches, [r for n, r in got if n == "stale_read"]


def test_batch_results_match_reference(tmp_path):
    ref = applied(importlib.import_module("test_propose_batch"), "dragonboat_tpu",
                  tmp_path / "ref")
    port = applied(R, "dragonboat_tpu_torch", tmp_path / "port")
    assert [v for _c, v in port[0][0]] == list(range(1, 51))
    assert port == ref
