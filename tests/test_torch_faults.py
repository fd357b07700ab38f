"""The fault plane of the PyTorch port against the JAX package's.

First, exact checks across the two packages on the same seeds (drawn with
numpy): FaultPlane decision streams and the partition, crash/restart and
overload-storm schedules with their signatures, ClockPlane chaos
schedules, the batch hook's output on equal seeded MessageBatches, and
the WAL bytes that tear_wal_tail and FaultyKV leave.

Then the twins of tests/test_faultplane.py (deterministic replay, wire
faults at the batch hook, storage faults, the clock plane and the
acceptance chaos run: a 3-host cluster under a 30% drop + partition
schedule converges with zero linearizability violations and no
heartbeat-class message dropped from a full send queue) and of
tests/test_chaos_matrix.py's seed matrix (through chip_smoke.py's
`phase_chaos`, the body its fault phase runs on the card), on the port's
vector engine on the CPU (`device="cpu"`). The plain CPU step costs a few ms, so the hosts
tick every 50 ms where the reference's tick every 5 ms (as in the port's
other engine tests); fault probabilities, schedule lengths and seeds are
the reference's."""
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke

import dragonboat_tpu.codec as ref_codec
import dragonboat_tpu.faults as ref_faults
import dragonboat_tpu.storage.kv as ref_kv
import dragonboat_tpu.types as ref_types
import dragonboat_tpu_torch.codec as port_codec
import dragonboat_tpu_torch.faults as port_faults
import dragonboat_tpu_torch.storage.kv as port_kv
import dragonboat_tpu_torch.types as port_types

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.faults import REPLICATION_TYPES, FaultPlane, FaultSpec
from dragonboat_tpu_torch.lincheck import HistoryRecorder, check_kv_history
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.storage.kv import WalKV, WriteBatch
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory
from dragonboat_tpu_torch.types import Entry, Message, MessageBatch, MessageType


@pytest.fixture(autouse=True)
def one_thread():
    # the plain step is thousands of tiny ops: torch's intra-op pool only
    # adds overhead at these widths, and several engines share the process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the two packages' modules side by side
PACKAGES = {
    "ref": (ref_faults, ref_types, ref_codec, ref_kv),
    "port": (port_faults, port_types, port_codec, port_kv),
}
SEEDS = [int(x) for x in np.random.default_rng(20261017).integers(1, 2**31, size=4)]


# ------------------------------------------- the two packages, exactly equal
def _schedules(F, seed):
    """Every seeded draw a FaultPlane offers, in one thread: the raw
    decision streams, the partition, crash/restart and overload-storm
    schedules, the log and the signatures."""
    fp = F.FaultPlane(seed, F.FaultSpec(tear_tail=0.5))
    out = {"decide": [fp.decide(f"wire:h{i % 3}", "drop", 0.3) for i in range(60)],
           "uniform": [fp.uniform("faultloop", "window", 0.3, 0.8) for _ in range(20)],
           "choice": [fp.choice("faultloop", "fault", ["a", "b", "c"]) for _ in range(20)]}
    out["partition"] = list(fp.partition_schedule("part", (1, 2, 3), total_s=6.0))
    out["crash"] = list(fp.crash_restart_schedule("crash", ("h1", "h2", "h3"), total_s=4.0))
    out["storm"] = list(fp.overload_storm_schedule("storm", (1, 2, 3), 3.0))
    out["log"] = fp.schedule_log()
    out["signature"] = fp.schedule_signature()
    out["storm_signature"] = fp.schedule_signature(sites=("storm",))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_schedules_equal_across_packages(seed):
    ref, port = _schedules(ref_faults, seed), _schedules(port_faults, seed)
    assert port == ref
    assert ref["partition"] and ref["crash"] and ref["storm"]


@pytest.mark.parametrize("seed", SEEDS)
def test_clock_chaos_schedule_equal_across_packages(seed):
    def draw(F):
        fp = F.FaultPlane(seed)
        sched = list(F.ClockPlane(fp).chaos_schedule("clock", ["h1", "h2", "h3"], total_s=3.0))
        return sched, fp.schedule_signature()

    assert draw(port_faults) == draw(ref_faults)


def _seeded_batches(T, seed, n=30):
    rng = random.Random(seed)
    types = list(T.MessageType)
    out = []
    for b in range(n):
        msgs = []
        for i in range(rng.randrange(1, 8)):
            msgs.append(T.Message(
                type=rng.choice(types) if rng.random() < 0.5 else T.MessageType.REPLICATE,
                cluster_id=rng.randrange(1, 5), to=rng.randrange(1, 4),
                from_=rng.randrange(1, 4), term=rng.randrange(1, 9),
                entries=[T.Entry(index=b * 10 + i, term=1, cmd=rng.randbytes(4))]))
        out.append(T.MessageBatch(requests=msgs, deployment_id=7, source_address="h1:1"))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("only_replication", [False, True])
def test_batch_hook_output_equal_across_packages(seed, only_replication):
    """Drop, duplicate and reorder over equal seeded batches ship equal
    batches (as wire bytes) in both packages."""
    def run(F, T, C):
        spec = F.FaultSpec(drop=0.2, duplicate=0.2, reorder=0.2, reorder_hold=2,
                           only_types=F.REPLICATION_TYPES if only_replication else None)
        fp = F.FaultPlane(seed, spec)
        hook = fp.batch_hook("wire:h1")
        shipped = []
        for b in _seeded_batches(T, seed):
            ok = hook(b)
            shipped.append((ok, C.encode_message_batch(b) if ok else b""))
        fp.set_spec(F.FaultSpec())  # the pen drains on the next batch
        tail = _seeded_batches(T, seed + 1, n=1)[0]
        assert hook(tail)
        shipped.append((True, C.encode_message_batch(tail)))
        faults = sum(1 for _site, _kind, _n, hit in fp.schedule_log() if hit)
        return shipped, fp.schedule_signature(), faults

    ref = run(ref_faults, ref_types, ref_codec)
    assert run(port_faults, port_types, port_codec) == ref
    assert ref[2] > 0  # the hook dropped, duplicated or held something


def _wal_bytes(d):
    with open(os.path.join(d, "wal.log"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", SEEDS)
def test_wal_tear_and_faulty_kv_bytes_equal_across_packages(seed, tmp_path):
    """Equal record groups through FaultyKV (seeded append and fsync
    errors), then a seeded torn tail: both packages leave the same WAL
    bytes, refuse the same batches and recover the same keys."""
    def run(name, F, KV):
        d = str(tmp_path / name)
        fp = F.FaultPlane(seed, F.FaultSpec(append_error=0.15, fsync_error=0.15))
        kv = fp.wrap_kv(KV.WalKV(d, fsync=False), "crash:h1")
        refused = []
        for i in range(12):
            wb = KV.WriteBatch()
            for j in range(1 + i % 3):
                wb.put(b"k%d.%d" % (i, j), b"v%d" % (seed % 997 + i))
            try:
                kv.commit_write_batch(wb)
            except IOError:
                refused.append(i)
            try:
                kv.sync()
            except IOError:
                refused.append(("sync", i))
        kv.close()
        before = _wal_bytes(d)
        cut = F.FaultPlane(seed).tear_wal_tail(d, "tear")
        kv2 = KV.WalKV(d)
        keys = {b"k%d.%d" % (i, j): kv2.get_value(b"k%d.%d" % (i, j))
                for i in range(12) for j in range(3)}
        kv2.close()
        return before, cut, _wal_bytes(d), refused, keys, fp.schedule_signature()

    ref = run("ref", ref_faults, ref_kv)
    assert run("port", port_faults, port_kv) == ref
    assert ref[1] > 0


# ------------------------------------------------------ deterministic replay
def _drive(fp: FaultPlane) -> list:
    """A fixed multi-site query sequence, partly from worker threads (each
    site is only ever touched by one thread, like the real seams)."""
    out = []

    def worker(site):
        for i in range(200):
            fp.decide(site, "drop", 0.3)
            if i % 7 == 0:
                fp.uniform(site, "delay_s", 0.001, 0.02)

    threads = [
        threading.Thread(target=worker, args=(f"wire:h{i}",)) for i in (1, 2, 3)
    ]
    for t in threads:
        t.start()
    for _ in range(50):
        out.append(fp.choice("faultloop", "fault", ["a", "b", "c", "none"]))
        fp.uniform("faultloop", "window", 0.3, 0.8)
    for t in threads:
        t.join()
    return out


def test_same_seed_identical_schedule():
    fp1, fp2 = FaultPlane(1234), FaultPlane(1234)
    seq1, seq2 = _drive(fp1), _drive(fp2)
    assert seq1 == seq2
    assert fp1.schedule_signature() == fp2.schedule_signature()
    # per-site logs are identical element-for-element, not just as a set
    def by_site(fp):
        d = {}
        for site, kind, n, v in fp.schedule_log():
            d.setdefault(site, []).append((kind, n, v))
        return d

    assert by_site(fp1) == by_site(fp2)


def test_different_seed_different_schedule():
    fp1, fp2 = FaultPlane(1234), FaultPlane(4321)
    _drive(fp1), _drive(fp2)
    assert fp1.schedule_signature() != fp2.schedule_signature()


# ----------------------------------------------------------- wire semantics
def mk_batch(n=6, mtype=MessageType.REPLICATE):
    return MessageBatch(
        requests=[
            Message(
                type=mtype,
                cluster_id=1,
                to=2,
                from_=1,
                entries=[Entry(index=i + 1, term=1, cmd=b"p%d" % i)],
            )
            for i in range(n)
        ]
    )


def test_batch_hook_drop_duplicate_reorder_replay():
    spec = FaultSpec(drop=0.3, duplicate=0.2, reorder=0.2, reorder_hold=1)

    def run(seed):
        fp = FaultPlane(seed, spec)
        hook = fp.batch_hook("wire:h1")
        shipped = []
        for _ in range(40):
            b = mk_batch()
            if hook(b):
                shipped.append([m.entries[0].index for m in b.requests])
            else:
                shipped.append([])
        return shipped

    a, b = run(99), run(99)
    assert a == b  # bit-identical replay of the shipped sequence
    c = run(100)
    assert c != a
    flat = [i for batch in a for i in batch]
    assert flat, "everything was dropped"
    # duplicates happened and total drop rate is in a plausible band
    total_in = 40 * 6
    assert len(flat) < total_in  # some drops
    assert any(flat[i] == flat[i + 1] for i in range(len(flat) - 1)) or (
        len(set(flat)) < len(flat)
    )


def test_batch_hook_only_types_shields_control_plane():
    fp = FaultPlane(7, FaultSpec(drop=1.0, only_types=REPLICATION_TYPES))
    hook = fp.batch_hook("wire:h1")
    b = mk_batch(3, MessageType.HEARTBEAT)
    assert hook(b) and len(b.requests) == 3  # heartbeats untouched
    b2 = mk_batch(3, MessageType.REPLICATE)
    assert not hook(b2)  # replication all dropped


def test_reordered_messages_resurface():
    fp = FaultPlane(5, FaultSpec(reorder=1.0, reorder_hold=1))
    hook = fp.batch_hook("wire:h1")
    b1 = mk_batch(2)
    assert not hook(b1)  # both held back
    fp.set_spec(FaultSpec())  # close the fault window
    # the pen drains on the next batch: a held message is never leaked
    b2 = mk_batch(1)
    assert hook(b2)
    got = [m.entries[0].index for m in b2.requests]
    assert got == [1, 2, 1]  # held messages jump the queue, then the new one


# ---------------------------------------------------------- storage faults
def test_faulty_kv_fsync_error_and_stall(tmp_path):
    fp = FaultPlane(3, FaultSpec(fsync_error=1.0))
    kv = fp.wrap_kv(WalKV(str(tmp_path / "w"), fsync=False), "fsync:h1")
    wb = WriteBatch()
    wb.put(b"a", b"1")
    with pytest.raises(IOError):
        kv.commit_write_batch(wb)
    fp.set_spec(FaultSpec())  # heal
    kv.commit_write_batch(wb)
    assert kv.get_value(b"a") == b"1"
    fp.set_spec(FaultSpec(fsync_stall=1.0, fsync_stall_s=(0.01, 0.011)))
    t0 = time.monotonic()
    kv.sync()
    assert time.monotonic() - t0 >= 0.009
    kv.close()


def test_tear_wal_tail_rolls_back_to_sealed_group(tmp_path):
    d = str(tmp_path / "w")
    for seed in (1, 2, 3, 4):
        kv = WalKV(d, fsync=False)
        wb = WriteBatch()
        wb.put(b"stable", b"yes")
        kv.commit_write_batch(wb)
        wb2 = WriteBatch()
        wb2.put(b"tail", b"maybe")
        wb2.put(b"tail2", b"maybe")
        kv.commit_write_batch(wb2)
        kv.close()
        fp = FaultPlane(seed)
        assert fp.tear_wal_tail(d, "tear") > 0
        kv2 = WalKV(d)
        assert kv2.get_value(b"stable") == b"yes"
        # group atomicity: the second batch is either fully there or gone
        assert (kv2.get_value(b"tail") is None) == (
            kv2.get_value(b"tail2") is None
        )
        kv2.close()
        import shutil

        shutil.rmtree(d)


# ------------------------------------------------- acceptance: chaos run
# the KV state machine of chip_smoke.py's fault phase: `key=value` puts,
# key lookups, a hash of the whole map
HashKV = chip_smoke._kv_sm()


CLUSTER = 1
HOSTS = (1, 2, 3)
# the port's CPU step is eager torch ops: 50 ms ticks (the reference: 5)
RTT_MS = 50


def _mk_host(nid, reg, tmp):
    nh = NodeHost(
        NodeHostConfig(
            deployment_id=9,
            rtt_millisecond=RTT_MS,
            nodehost_dir=f"{tmp}/h{nid}",
            raft_address=f"fp{nid}:1",
            raft_rpc_factory=lambda l, reg=reg: loopback_factory(l, reg),
            engine=EngineConfig(
                kind="vector", max_groups=32, max_peers=4, log_window=64,
                device="cpu",
            ),
        )
    )
    nh.start_cluster(
        {h: f"fp{h}:1" for h in HOSTS},
        False,
        lambda c, n: HashKV(),
        Config(
            cluster_id=CLUSTER,
            node_id=nid,
            election_rtt=20,
            heartbeat_rtt=4,
            snapshot_entries=50,
            compaction_overhead=10,
        ),
    )
    return nh


def _find_leader(hosts, deadline_s=20):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        for nid, nh in list(hosts.items()):
            if nh is None:
                continue
            try:
                lid, ok = nh.get_leader_id(CLUSTER)
            except Exception:
                continue
            if ok and lid == nid and not nh.is_partitioned():
                return nid
        time.sleep(0.02)
    return None


@pytest.mark.chaos
def test_acceptance_drop_and_partition_schedule(tmp_path):
    """Acceptance: 30% drop + partitions from one seed; converge,
    linearizable, and no heartbeat-class message dropped from a full
    queue."""
    seed = 0xACCE97
    print(f"CHAOS SEED=0x{seed:X} (rerun: FaultPlane({seed}))")
    fp = FaultPlane(seed, FaultSpec(drop=0.30))
    reg = _Registry()
    hosts = {nid: _mk_host(nid, reg, str(tmp_path)) for nid in HOSTS}
    rec = HistoryRecorder()
    stop = threading.Event()
    seq = [0]
    seq_mu = threading.Lock()

    def client_main(client_id):
        import random as _r

        crng = _r.Random(seed + client_id)
        while not stop.is_set():
            leader = _find_leader(hosts, deadline_s=1)
            nh = hosts.get(leader)
            if nh is None:
                continue
            key = crng.choice(["a", "b", "c"])
            if crng.random() < 0.6:
                with seq_mu:
                    seq[0] += 1
                    val = f"v{seq[0]}"
                op = rec.invoke(client_id, ("put", key, val))
                try:
                    nh.sync_propose(
                        nh.get_noop_session(CLUSTER),
                        f"{key}={val}".encode(),
                        timeout_s=2.0,
                    )
                    rec.complete(op, None)
                except Exception:
                    rec.unknown(op)
            else:
                op = rec.invoke(client_id, ("get", key))
                try:
                    rec.complete(op, nh.sync_read(CLUSTER, key, timeout_s=2.0))
                except Exception:
                    rec.fail(op)
            time.sleep(crng.random() * 0.01)

    clients = [
        threading.Thread(target=client_main, args=(i,), daemon=True)
        for i in range(3)
    ]
    for t in clients:
        t.start()

    # 30% drop on every host's wire for the whole schedule
    for nid, nh in hosts.items():
        fp.install(nh, f"h{nid}")
    # plus partitions from the seeded schedule
    for victim, window, idle in fp.partition_schedule(
        "faultloop", HOSTS, total_s=8.0
    ):
        nh = hosts[victim]
        nh.set_partitioned(True)
        time.sleep(window)
        nh.set_partitioned(False)
        time.sleep(idle)

    fp.uninstall_all()
    for nh in hosts.values():
        nh.set_partitioned(False)
    # a healed tail window so the recorded history also carries clean ops;
    # adaptive: a loaded CI box needs longer for the ops to land
    deadline = time.time() + 30
    while len(rec.history()) < 30 and time.time() < deadline:
        time.sleep(0.5)
    stop.set()
    for t in clients:
        t.join(timeout=5)

    # settle: one final write must commit
    deadline = time.time() + 60
    while True:
        leader = _find_leader(hosts, deadline_s=30)
        assert leader is not None, "cluster did not recover a leader"
        try:
            hosts[leader].sync_propose(
                hosts[leader].get_noop_session(CLUSTER), b"final=done", 5.0
            )
            break
        except Exception:
            if time.time() > deadline:
                raise
            time.sleep(0.2)

    deadline = time.time() + 30
    while time.time() < deadline:
        idx = {n: hosts[n].get_applied_index(CLUSTER) for n in HOSTS}
        if len(set(idx.values())) == 1:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"applied indexes never converged: {idx}")
    hashes = {n: hosts[n].get_sm_hash(CLUSTER) for n in HOSTS}
    assert len(set(hashes.values())) == 1, f"replica SMs diverged: {hashes}"

    history = rec.history()
    assert len(history) > 20, f"too few ops ({len(history)})"
    assert check_kv_history(history, max_states=5_000_000), (
        f"linearizability violation (CHAOS SEED=0x{seed:X})"
    )

    # the hardened send queue never sacrificed control-plane traffic
    for nid, nh in hosts.items():
        m = nh.transport.metrics()
        assert m["queue_dropped_urgent"] == 0, (nid, m)
    for nh in hosts.values():
        nh.stop()


def test_faulty_kv_append_error_never_half_seals_group(tmp_path):
    """A write-path EIO mid-batch (append_error, not
    fsync_error) must never leave a half-sealed record group — after the
    failure AND after reopen the failed batch is invisible as a unit,
    earlier data is intact, and the store keeps working."""
    from dragonboat_tpu_torch.faults import FaultPlane as FP

    d = str(tmp_path / "w")
    kv = WalKV(d, fsync=False)
    wb0 = WriteBatch()
    wb0.put(b"stable", b"yes")
    kv.commit_write_batch(wb0)
    # a counting fault: fail on the SECOND record of the batch, so the
    # first record is already in the file when the group unwinds
    calls = {"n": 0}

    def fault():
        calls["n"] += 1
        if calls["n"] == 2:
            raise IOError("injected append error")

    kv.set_append_fault(fault)
    wb = WriteBatch()
    wb.put(b"half", b"a")
    wb.put(b"half2", b"b")
    with pytest.raises(IOError):
        kv.commit_write_batch(wb)
    kv.set_append_fault(None)
    # in the LIVE store: nothing of the failed group is visible and the
    # unwind did not eat the earlier sealed group
    assert kv.get_value(b"half") is None and kv.get_value(b"half2") is None
    assert kv.get_value(b"stable") == b"yes"
    # the truncated tail accepts new groups cleanly
    wb2 = WriteBatch()
    wb2.put(b"after", b"ok")
    kv.commit_write_batch(wb2)
    kv.close()
    # after REOPEN (the WAL replay): same story, no half-sealed group
    kv2 = WalKV(d)
    assert kv2.get_value(b"half") is None and kv2.get_value(b"half2") is None
    assert kv2.get_value(b"stable") == b"yes"
    assert kv2.get_value(b"after") == b"ok"
    kv2.close()
    # the seeded plane arms the same seam through wrap_kv
    fp = FP(9, FaultSpec(append_error=1.0))
    kv3 = fp.wrap_kv(WalKV(d, fsync=False), "crash:h1")
    wb3 = WriteBatch()
    wb3.put(b"nope", b"x")
    with pytest.raises(IOError):
        kv3.commit_write_batch(wb3)
    fp.set_spec(FaultSpec())  # heal
    kv3.commit_write_batch(wb3)
    assert kv3.get_value(b"nope") == b"x"
    kv3.close()


# ------------------------------------------------------------- clock plane
def test_clock_plane_skew_drift_jump_math():
    """ClockPlane.now continuity rules: mutations re-anchor first (no
    retroactive jumps), clear() heals the RATE but keeps the accrued
    offset (heal without a jump), reset() drops state (and IS a jump)."""
    from dragonboat_tpu_torch.faults import ClockPlane, FaultPlane as FP

    cp = ClockPlane(FP(1))
    h = "h1"
    t0 = cp.now(h)
    assert abs(t0 - time.monotonic()) < 0.05  # default: real monotonic
    cp.step_jump(h, 2.0)
    assert cp.now(h) - time.monotonic() > 1.9
    cp.set_drift(h, 3.0)  # 3x fast from NOW (offset preserved)
    base = cp.now(h)
    time.sleep(0.05)
    faulted = cp.now(h) - base
    assert faulted > 0.12  # ~3x of >=0.05 real elapsed
    cp.clear(h)  # rate back to 1.0, offset KEPT
    still_ahead = cp.now(h) - time.monotonic()
    assert still_ahead > 1.9
    before = cp.now(h)
    time.sleep(0.02)
    assert 0.015 < cp.now(h) - before < 0.2  # 1x rate again
    cp.reset(h)  # drop state: back to real time = a backward jump
    assert abs(cp.now(h) - time.monotonic()) < 0.05


@pytest.mark.chaos
def test_clock_plane_chaos_schedule_replays_bit_identical():
    """The ClockPlane rides its owning FaultPlane's decision streams:
    two same-seeded planes draw the IDENTICAL chaos schedule (the
    crash_restart_schedule replay contract, extended to clocks)."""
    from dragonboat_tpu_torch.faults import ClockPlane, FaultPlane as FP

    def draw(seed):
        fp = FP(seed)
        cp = ClockPlane(fp)
        gen = cp.chaos_schedule("longhaul", ["h1", "h2", "h3"], total_s=3.0)
        return [ev for ev in gen]

    a, b = draw(0x77), draw(0x77)
    assert a == b and len(a) > 0
    kinds = {ev[1] for ev in a}
    assert kinds <= {"skew", "drift", "jump"}
    c = draw(0x78)
    assert c != a  # a different seed draws a different schedule


# ------------------------------------------- the chaos matrix's seed matrix
@pytest.mark.chaos
@pytest.mark.parametrize("seed", [11, 29, 47])
def test_seed_matrix_drop_partition_converges(tmp_path, seed):
    """The twin of tests/test_chaos_matrix.py's seed matrix, through the
    body chip_smoke.py's fault phase runs on the card (`phase_chaos`): a
    short drop + partition schedule against 3 hosts on one shared CPU
    core; the cluster recovers, commits, converges, keeps its control
    plane and leaves a linearizable history. The schedule the seed draws
    is the reference's."""
    ref_sched = list(ref_faults.FaultPlane(seed).partition_schedule(
        "faultloop", HOSTS, total_s=4.0, min_window_s=0.2, max_window_s=0.5))
    r = chip_smoke.phase_chaos(str(tmp_path), seed, device="cpu", rtt_ms=RTT_MS)
    assert r["schedule"] == ref_sched
    assert r["committed"] > 0 and r["ops"] > 0
