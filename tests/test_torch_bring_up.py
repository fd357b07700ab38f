"""Twin of tests/test_bring_up.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): 2,048 single-replica groups brought up by one
`start_clusters` call, each electing itself, and a fleet started in bulk
restarting through the incremental `start_cluster` path, at the
reference's ticks.

The tests below run both bodies through both packages' NodeHosts: the bulk
fleet's final leadership (every group led by its only replica) and the
bootstrap records that the bulk start left on disk, read back field for
field, with the restart's reads, and the bootstrap record's bytes for a
few member sets, each package decoding the other's."""
import contextlib
import dataclasses
import importlib

import pytest

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_bring_up")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_bring_up")


@contextlib.contextmanager
def observed_hosts(M):
    """Record, for every NodeHost that `M` makes during the block, its
    groups' leaders when it stops and the values its stale reads return."""
    base = M.NodeHost
    got = {"leaders": [], "reads": []}

    class Observed(base):
        def stale_read(self, cluster_id, query):
            v = super().stale_read(cluster_id, query)
            got["reads"].append((cluster_id, v))
            return v

        def stop(self):
            snap = self.engine.leader_snapshot()
            got["leaders"].append({c: lid for c, (lid, _t) in snap.items()})
            return super().stop()

    M.NodeHost = Observed
    try:
        yield got
    finally:
        M.NodeHost = base


def bootstrap_records(M, root, clusters):
    """The bootstrap records in the logdb that `M`'s NodeHost "bu2:1" left
    under `root`, one dict of fields per cluster."""
    pkg = M.NodeHost.__module__.split(".")[0]
    db = importlib.import_module(pkg + ".storage.logdb").ShardedLogDB(
        str(root / "nh" / "bu2-1" / "logdb"))
    try:
        return {c: dataclasses.asdict(db.get_bootstrap_info(c, 1)) for c in clusters}
    finally:
        db.close()


def bulk_then_incremental(M, root):
    with observed_hosts(M) as got:
        M.test_bulk_start_matches_incremental(root)
    last = dict(got["reads"])  # the restart's final read of each group
    # the bulk-started host's leaders (the restarted one may stop before
    # its groups re-elect: its reads replay the log)
    return bootstrap_records(M, root, (1, 2)), last, got["leaders"][0]


def test_bulk_start_records_match_reference(tmp_path):
    ref = bulk_then_incremental(_ref(), tmp_path / "ref")
    port = bulk_then_incremental(R, tmp_path / "port")
    assert port[0] == ref[0]
    assert set(port[0][1]) >= {"addresses", "join", "type"}
    assert port[0][1]["addresses"] == {1: "bu2:1"} and not port[0][1]["join"]
    assert port[1] == ref[1] == {1: 1, 2: 1}
    assert port[2] == ref[2] == {1: 1, 2: 1}


def test_bulk_fleet_led_by_its_only_replica_in_both_packages(tmp_path):
    leaders = []
    for M, root in ((_ref(), tmp_path / "ref"), (R, tmp_path / "port")):
        with observed_hosts(M) as got:
            M.test_bulk_fleet_bring_up(root)
        leaders.append(got["leaders"])
    ref, port = leaders
    assert port == ref
    assert len(port) == 1 and len(port[0]) == 2048 and set(port[0].values()) == {1}


@pytest.mark.parametrize("members,join,smtype", [
    ({1: "bu:1"}, False, 0),
    ({1: "a:1", 2: "b:2", 3: "c:3"}, False, 1),
    ({}, True, 2),
    ({n: f"h{n}:{9000 + n}" for n in range(1, 8)}, False, 3),
])
def test_bootstrap_record_bytes_match_reference(members, join, smtype):
    """The bootstrap record a bulk start writes is the same bytes in both
    packages, and each package decodes the other's."""
    pkgs = ("dragonboat_tpu", "dragonboat_tpu_torch")
    codec = [importlib.import_module(p + ".codec") for p in pkgs]
    boots = [importlib.import_module(p + ".types").Bootstrap(
        addresses=dict(members), join=join, type=smtype) for p in pkgs]
    raw = [c.encode_bootstrap(b) for c, b in zip(codec, boots)]
    assert raw[1] == raw[0]
    for c, other in zip(codec, reversed(raw)):
        assert dataclasses.asdict(c.decode_bootstrap(other)[0]) == dataclasses.asdict(boots[0])
