"""Twin of tests/test_readindex_tracker.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the ReadIndex tracker's queue, quorum and reset
rules, and two reads whose contexts share their low 24 bits released
independently through the port's LoopbackCluster (the kernel carries the
upper half in the ri_ctx2 plane).

The test below runs the LoopbackCluster body through both packages and
holds equal every step's counter planes and the reads each replica
released."""
import importlib

import numpy as np

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_readindex_tracker")
globals().update(reference_tests(R))


def counters(c, _result):
    return [np.asarray(x).tolist() for x in c.counters]


def traced(M, pkg):
    L = importlib.import_module(pkg + ".ops.loopback").LoopbackCluster
    with calls(L, ("__init__",), lambda c, _r: c) as made, \
            calls(L, ("step",), counters) as steps:
        M.test_full_width_ctx_no_collision_kernel()
    reads = [[list(map(int, r)) for r in rs] for rs in made[0][1].ready_reads]
    return [s for _n, s in steps], reads


def test_full_width_reads_match_reference():
    ref = traced(importlib.import_module("test_readindex_tracker"), "dragonboat_tpu")
    port = traced(R, "dragonboat_tpu_torch")
    assert len(port[0]) > 40 and any(port[1])
    assert port == ref
