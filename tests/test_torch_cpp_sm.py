"""The port's C++ state machine loader (`dragonboat_tpu_torch.cpp_sm`, a
copy of the reference's) over the plugins built from native/examples by
`make -C native all`: the reference's C++ SM tests on the port (its two
cluster tests on the port's vector engine on the CPU, marked slow as
there), and the same plugin through both packages' loaders."""
import io
import os
import threading
import time

import pytest

_BUILD = os.path.join(os.path.dirname(__file__), "..", "native", "build")
_SO = os.path.join(_BUILD, "libkvstore_sm.so")
_SO_CONCURRENT = os.path.join(_BUILD, "libconcurrent_sm.so")
_SO_ONDISK = os.path.join(_BUILD, "libdiskkv_sm.so")


@pytest.fixture(scope="module", autouse=True)
def _plugins():
    """The plugins of `make -C native all`, built before the module's first
    test under the port's build lock (dragonboat_tpu_torch.native), never
    while the module is collected; skips where there is no toolchain, and
    a failed build fails loudly."""
    import shutil

    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("native toolchain unavailable")
    from dragonboat_tpu_torch import native

    native.build_plugins()

# the cluster tests run the vector engine the reference's NodeHost
# defaults to, on the CPU (the port's default device is the card), at the
# suite's CPU shape; its plain CPU step takes a few ms, so ticks are 50 ms
# (the reference's 5 ms would churn elections)
CPU_RTT_MS = 50


def _cpu_engine():
    from dragonboat_tpu_torch.config import EngineConfig

    return EngineConfig(kind="vector", max_groups=32, max_peers=4, log_window=64,
                        device="cpu")


class _Abort:
    def check(self):
        pass


def _propose_retry(hosts, leader, cluster_id, cmd, attempts=4):
    """Propose with leader re-resolution on timeout: on a 1-cpu box an
    election can churn between the leader probe and the propose, and a
    proposal handed to a just-deposed leader times out — real clients
    (and the reference's tests) retry against the new leader. Returns
    (result, leader)."""
    from dragonboat_tpu_torch.requests import ErrTimeout

    last = None
    for _ in range(attempts):
        try:
            s = hosts[leader].get_noop_session(cluster_id)
            return hosts[leader].sync_propose(s, cmd, timeout_s=5.0), leader
        except ErrTimeout as e:
            last = e
            for nid, nh in hosts.items():
                lid, ok = nh.get_leader_id(cluster_id)
                if ok and lid in hosts:
                    leader = lid
                    break
    raise last


def _factory(so=_SO):
    from dragonboat_tpu_torch.cpp_sm import CppStateMachineFactory

    return CppStateMachineFactory(os.path.abspath(so))


def test_update_lookup_hash():
    sm = _factory()(1, 1)
    assert sm.update(b"a=1").value == 1
    assert sm.update(b"b=2").value == 2
    assert sm.update(b"a=3").value == 2  # overwrite, size unchanged
    assert sm.lookup(b"a") == b"3"
    assert sm.lookup(b"missing") is None
    h1 = sm.get_hash()
    sm.update(b"c=4")
    assert sm.get_hash() != h1
    sm.close()


def test_hash_is_content_deterministic():
    f = _factory()
    a, b = f(1, 1), f(1, 2)
    for cmd in (b"x=1", b"y=2"):
        a.update(cmd)
    for cmd in (b"y=2", b"x=1"):  # different order, same content
        b.update(cmd)
    assert a.get_hash() == b.get_hash()
    a.close()
    b.close()


def test_snapshot_roundtrip_across_abi():
    f = _factory()
    src = f(1, 1)
    for i in range(100):
        src.update(f"key{i:03d}=value{i}".encode())
    buf = io.BytesIO()
    src.save_snapshot(buf, None, _Abort())
    assert buf.tell() > 0

    dst = f(1, 2)
    dst.update(b"junk=state")  # must be cleared by recover
    buf.seek(0)
    dst.recover_from_snapshot(buf, None, _Abort())
    assert dst.lookup(b"key042") == b"value42"
    assert dst.lookup(b"junk") is None
    assert dst.get_hash() == src.get_hash()
    src.close()
    dst.close()


def test_writer_error_propagates():
    f = _factory()
    sm = f(1, 1)
    sm.update(b"k=v")

    class Boom(io.RawIOBase):
        def write(self, data):
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        sm.save_snapshot(Boom(), None, _Abort())
    sm.close()


def test_concurrent_plugin_detected_and_batched():
    """The concurrent plugin exports dbtpu_sm_type()=CONCURRENT; the loader
    returns an IConcurrentStateMachine whose update takes SMEntry batches
    (cf. reference concurrent.h BatchedUpdate)."""
    from dragonboat_tpu_torch.statemachine import (
        SM_TYPE_CONCURRENT,
        IConcurrentStateMachine,
        SMEntry,
    )

    f = _factory(_SO_CONCURRENT)
    assert f.sm_type == SM_TYPE_CONCURRENT
    sm = f(1, 1)
    assert isinstance(sm, IConcurrentStateMachine)
    ents = [
        SMEntry(index=1, cmd=b"a=1"),
        SMEntry(index=2, cmd=b"b=2"),
        SMEntry(index=3, cmd=b"bad"),
    ]
    sm.update(ents)
    assert [e.result.value for e in ents] == [1, 2, 0]
    assert sm.lookup(b"b") == b"2"
    sm.close()


def test_concurrent_plugin_snapshot_is_point_in_time():
    """prepare_snapshot captures the state; updates applied between prepare
    and save must not leak into the image."""
    from dragonboat_tpu_torch.statemachine import SMEntry

    f = _factory(_SO_CONCURRENT)
    src = f(1, 1)
    src.update([SMEntry(index=1, cmd=b"k=old")])
    ctx = src.prepare_snapshot()
    src.update([SMEntry(index=2, cmd=b"k=new"),
                SMEntry(index=3, cmd=b"late=1")])
    buf = io.BytesIO()
    src.save_snapshot(ctx, buf, None, _Abort())

    dst = f(1, 2)
    buf.seek(0)
    dst.recover_from_snapshot(buf, None, _Abort())
    assert dst.lookup(b"k") == b"old"
    assert dst.lookup(b"late") is None
    src.close()
    dst.close()


def test_ondisk_plugin_open_replays_and_survives_restart(tmp_path):
    """The on-disk plugin persists applies under DBTPU_DISKKV_DIR; a fresh
    instance's open() replays them and reports the last applied index
    (cf. reference ondisk.h Open contract)."""
    from dragonboat_tpu_torch.statemachine import (
        SM_TYPE_ONDISK,
        AbortSignal,
        IOnDiskStateMachine,
        SMEntry,
    )

    os.environ["DBTPU_DISKKV_DIR"] = str(tmp_path)
    try:
        f = _factory(_SO_ONDISK)
        assert f.sm_type == SM_TYPE_ONDISK
        sm = f(7, 1)
        assert isinstance(sm, IOnDiskStateMachine)
        assert sm.open(AbortSignal()) == 0
        sm.update([SMEntry(index=i, cmd=f"k{i}=v{i}".encode())
                   for i in range(1, 11)])
        sm.sync()
        h = sm.get_hash()
        sm.close()

        again = f(7, 1)
        assert again.open(AbortSignal()) == 10
        assert again.lookup(b"k10") == b"v10"
        assert again.get_hash() == h
        again.close()
    finally:
        del os.environ["DBTPU_DISKKV_DIR"]


def test_ondisk_plugin_snapshot_roundtrip(tmp_path):
    from dragonboat_tpu_torch.statemachine import AbortSignal, SMEntry

    os.environ["DBTPU_DISKKV_DIR"] = str(tmp_path)
    try:
        f = _factory(_SO_ONDISK)
        src = f(8, 1)
        src.open(AbortSignal())
        src.update([SMEntry(index=i, cmd=f"k{i}=v{i}".encode())
                    for i in range(1, 6)])
        ctx = src.prepare_snapshot()
        src.update([SMEntry(index=6, cmd=b"k1=mutated")])
        buf = io.BytesIO()
        src.save_snapshot(ctx, buf, _Abort())

        dst = f(8, 2)
        dst.open(AbortSignal())
        buf.seek(0)
        dst.recover_from_snapshot(buf, _Abort())
        assert dst.lookup(b"k1") == b"v1"  # point-in-time, pre-mutation
        # the install rebuilt dst's local log: a restart must see it
        dst.sync()
        dst.close()
        back = f(8, 2)
        assert back.open(AbortSignal()) == 5
        assert back.lookup(b"k3") == b"v3"
        back.close()
        src.close()
    finally:
        del os.environ["DBTPU_DISKKV_DIR"]


@pytest.mark.slow
def test_ondisk_cluster_restart_resumes_from_applied(tmp_path):
    """3-host cluster on the C++ on-disk plugin: propose, restart one host,
    its SM reopens at the persisted applied index and serves reads."""
    from dragonboat_tpu_torch.config import Config, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    os.environ["DBTPU_DISKKV_DIR"] = str(tmp_path / "diskkv")
    try:
        factory = _factory(_SO_ONDISK)
        reg = _Registry()
        hosts = {}

        def mk(nid, restart=False):
            cfg = NodeHostConfig(
                deployment_id=32, rtt_millisecond=CPU_RTT_MS,
                nodehost_dir=f"{tmp_path}/h{nid}", raft_address=f"d{nid}:1",
                raft_rpc_factory=lambda l, reg=reg: loopback_factory(l, reg),
                engine=_cpu_engine(),
            )
            nh = NodeHost(cfg)
            nh.start_cluster(
                {} if restart else {1: "d1:1", 2: "d2:1", 3: "d3:1"},
                False, factory,
                Config(cluster_id=1, node_id=nid, election_rtt=20,
                       heartbeat_rtt=2),
            )
            return nh

        for nid in (1, 2, 3):
            hosts[nid] = mk(nid)

        leader = None
        deadline = time.time() + 60
        while time.time() < deadline and leader is None:
            for nid, nh in hosts.items():
                lid, ok = nh.get_leader_id(1)
                if ok and lid == nid:
                    leader = nid
            time.sleep(0.02)
        assert leader

        for i in range(20):
            _, leader = _propose_retry(hosts, leader, 1,
                                       f"k{i}=v{i}".encode())
        assert hosts[leader].sync_read(1, b"k19", timeout_s=5.0) == b"v19"

        victim = [n for n in hosts if n != leader][0]
        hosts[victim].stop()
        hosts[victim] = mk(victim, restart=True)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if hosts[victim].stale_read(1, b"k19") == b"v19":
                    break
            except Exception:
                pass
            time.sleep(0.05)
        else:
            raise AssertionError("restarted on-disk C++ SM did not recover")

        for nh in hosts.values():
            nh.stop()
    finally:
        del os.environ["DBTPU_DISKKV_DIR"]


@pytest.mark.slow
def test_cpp_sm_cluster_end_to_end(tmp_path):
    """3-host cluster running the C++ KV plugin: propose, linearizable
    read, cross-replica hash equality, restart + replay."""
    from dragonboat_tpu_torch.config import Config, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory

    factory = _factory()
    reg = _Registry()
    hosts = {}

    def mk(nid, restart=False):
        cfg = NodeHostConfig(
            deployment_id=31, rtt_millisecond=CPU_RTT_MS,
            nodehost_dir=f"{tmp_path}/h{nid}", raft_address=f"q{nid}:1",
            raft_rpc_factory=lambda l, reg=reg: loopback_factory(l, reg),
            engine=_cpu_engine(),
        )
        nh = NodeHost(cfg)
        nh.start_cluster(
            {} if restart else {1: "q1:1", 2: "q2:1", 3: "q3:1"},
            False, factory,
            Config(cluster_id=1, node_id=nid, election_rtt=20,
                   heartbeat_rtt=2, snapshot_entries=30,
                   compaction_overhead=5),
        )
        return nh

    for nid in (1, 2, 3):
        hosts[nid] = mk(nid)

    leader = None
    # generous: the first user of this engine shape pays the jit compile
    deadline = time.time() + 60
    while time.time() < deadline and leader is None:
        for nid, nh in hosts.items():
            lid, ok = nh.get_leader_id(1)
            if ok and lid == nid:
                leader = nid
        time.sleep(0.02)
    assert leader

    for i in range(60):  # crosses the snapshot_entries=30 threshold
        _, leader = _propose_retry(hosts, leader, 1, f"k{i}=v{i}".encode())
    assert hosts[leader].sync_read(1, b"k59", timeout_s=5.0) == b"v59"

    deadline = time.time() + 20
    while time.time() < deadline:
        hashes = {n: hosts[n].get_sm_hash(1) for n in hosts}
        if len(set(hashes.values())) == 1:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"C++ SM replicas diverged: {hashes}")

    # restart one host: C++ SM state rebuilt from snapshot + log replay
    victim = [n for n in hosts if n != leader][0]
    hosts[victim].stop()
    hosts[victim] = mk(victim, restart=True)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            if hosts[victim].stale_read(1, b"k59") == b"v59":
                break
        except Exception:
            pass
        time.sleep(0.05)
    else:
        raise AssertionError("restarted C++ SM host did not recover")

    for nh in hosts.values():
        nh.stop()


# ------------------------------------------------- across the two packages


def _ref_factory(so):
    from dragonboat_tpu.cpp_sm import CppStateMachineFactory

    return CppStateMachineFactory(os.path.abspath(so))


@pytest.mark.parametrize("so", [_SO, _SO_CONCURRENT, _SO_ONDISK])
def test_both_loaders_agree_on_the_plugin(so, tmp_path, monkeypatch):
    """One plugin through both packages' loaders: the same SM kind, and
    the same applies give the same results, reads and hash; a snapshot
    one package's wrapper saved recovers through the other's."""
    from dragonboat_tpu.statemachine import AbortSignal as RefAbort
    from dragonboat_tpu.statemachine import SMEntry as RefEntry
    from dragonboat_tpu_torch.statemachine import (
        SM_TYPE_CONCURRENT, SM_TYPE_ONDISK, SM_TYPE_REGULAR, AbortSignal, SMEntry,
    )

    monkeypatch.setenv("DBTPU_DISKKV_DIR", str(tmp_path))
    ref_f, port_f = _ref_factory(so), _factory(so)
    assert port_f.sm_type == ref_f.sm_type
    ref, port = ref_f(3, 1), port_f(4, 1)
    cmds = [f"k{i % 7}=v{i}".encode() for i in range(1, 30)]
    if port_f.sm_type == SM_TYPE_REGULAR:
        assert [port.update(c).value for c in cmds] == [ref.update(c).value for c in cmds]
    else:
        if port_f.sm_type == SM_TYPE_ONDISK:
            assert port.open(AbortSignal()) == ref.open(RefAbort()) == 0
        pe = [SMEntry(index=i + 1, cmd=c) for i, c in enumerate(cmds)]
        re_ = [RefEntry(index=i + 1, cmd=c) for i, c in enumerate(cmds)]
        port.update(pe)
        ref.update(re_)
        assert [e.result.value for e in pe] == [e.result.value for e in re_]
    assert [port.lookup(f"k{i}".encode()) for i in range(8)] == \
        [ref.lookup(f"k{i}".encode()) for i in range(8)]
    assert port.get_hash() == ref.get_hash()
    # the port's snapshot recovers through the reference's wrapper
    buf = io.BytesIO()
    if port_f.sm_type == SM_TYPE_REGULAR:
        port.save_snapshot(buf, None, _Abort())
    elif port_f.sm_type == SM_TYPE_CONCURRENT:
        port.save_snapshot(port.prepare_snapshot(), buf, None, _Abort())
    else:
        port.save_snapshot(port.prepare_snapshot(), buf, _Abort())
    other = ref_f(5, 2)
    if port_f.sm_type == SM_TYPE_ONDISK:
        other.open(RefAbort())
    buf.seek(0)
    if port_f.sm_type == SM_TYPE_ONDISK:
        other.recover_from_snapshot(buf, _Abort())
    else:
        other.recover_from_snapshot(buf, None, _Abort())
    assert other.get_hash() == port.get_hash()
    for sm in (ref, port, other):
        sm.close()
