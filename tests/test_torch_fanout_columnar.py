"""Twin of tests/test_fanout_columnar.py on the PyTorch port.

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the port's columnar fan-out (`gather_replicate_sends`,
`gather_post_sends`, `gather_resp_sends`) and save updates
(`build_save_updates`) against the per-element reference transcriptions
over the reference's 12 seeds each, the deferred write wave against
individual saves, and the pack staging (`VectorEngine._stage_row`,
`_flush_staged_rows`) against direct per-row stores. The tests below also
run the same seeded StepOutputs and wire traffic through both packages and
hold the encoded messages, the save updates and the staged inbox planes
byte for byte equal."""
import importlib

import numpy as np
import pytest

from torch_twin import instances, port_copy, recording, reference_tests

R = port_copy("test_fanout_columnar")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_fanout_columnar")


def fanout_trace(M, seed):
    """The reference's two fan-out bodies for `seed`: the encoded message
    streams they compared (columnar, then per-element) and the columnar
    save updates, encoded."""
    with recording(M, ["_encode_stream", "build_save_updates"]) as got:
        M.test_fanout_messages_byte_identical(seed)
        M.test_save_updates_identical(seed)
    updates = got["build_save_updates"][0][0]
    return got["_encode_stream"], [
        (u.cluster_id, u.node_id, M.codec.encode_state(u.state),
         [M.codec.encode_entry(e) for e in u.entries_to_save]) for u in updates]


@pytest.mark.parametrize("seed", range(12))
def test_fanout_and_saves_match_reference_package(seed):
    port = fanout_trace(R, seed)
    assert port[0][0] and port == fanout_trace(_ref(), seed)


def staged_planes(M):
    """The inbox planes the reference's pack-staging body staged."""
    with instances(M, ["_PackHarness"]) as made:
        M.test_pack_staging_matches_direct_stores()
    return {p: np.asarray(v) for p, v in made["_PackHarness"][0]._buf.items()}


def test_pack_staging_matches_reference_package():
    ref, port = staged_planes(_ref()), staged_planes(R)
    assert ref.keys() == port.keys()
    for p in ref:
        assert ref[p].dtype == port[p].dtype and np.array_equal(ref[p], port[p]), p
    assert (port["mtype"] != R.MSG.NONE).sum() > 20
