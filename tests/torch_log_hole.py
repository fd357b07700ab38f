"""The log-hole family (ROADMAP §3 faults 9 and 11), written once for
either package (`pkg` is "dragonboat_tpu" or "dragonboat_tpu_torch"), so a
test can hold the port against the reference on one recipe and
chip_smoke.py can run the port's half on the card.

`install_interleaving` (fault 9): three replicas of one group on the
scalar or the vector engine, `snapshot_entries` 20 and
`compaction_overhead` 5. A follower crashes, the leader commits past a
snapshot and compacts past it, and the follower restarts, so the leader
ships it the snapshot. A gate on the follower's state machine holds the
installed snapshot where the task worker hands it to the snapshot worker
(the recovery that follows is the worker's), while the leader commits
more: on the scalar engine until the follower's step thread has appended
PAST entries above the installed index, on the vector engine for
VECTOR_HOLD_S (its loop holds a recovering lane's traffic). Then the
gate opens and the leader commits AFTER more. Every replica must end
at one applied index with one state machine hash. Recorded: each log
hole that `LogReader.set_range` raised, and each move of the follower's
log window to a snapshot (`LogReader.apply_snapshot`) with the thread
that made it and the window it replaced.

`rebased_overflow` (fault 11): two groups x 3 replicas, each host on its
own core, K=1, a 32-entry window, `_REBASE_THRESHOLD` lowered to 32 so
the leaders' window base moves past 48 committed entries; then each
group adds a member on a fourth host that joins empty. The joiner's
inbox is kept from its engine while its leaders' host-log catch-ups
stream more than a window of the log to it, so one step packs more
entries than the window has slots.
Recorded: what the joiner's lanes saved (the persisted prefix of each
lane), every ack it sent, the indexes it acked above what it had
persisted, the saves that lacked a payload ("missing arena entry") and
the log holes.

`save_fault`: three replicas of one group on the vector engine, each
host on its own core; a follower's arena is made to miss the next run it
is asked to save, and the follower proposes one entry. Recorded: whether
the follower acked or saved that run, its engine's fault and `faults`
gauge, and how its proposal and a request made after it ended.

Each returns a dict with "verdicts" and what was recorded."""
from __future__ import annotations

import contextlib
import importlib
import io
import re
import threading
import time

import torch_catchup as TC

CID = 16
SNAPSHOT_ENTRIES, COMPACTION_OVERHEAD = 20, 5
SCALAR_RTT_MS, VECTOR_RTT_MS = 5, 20
GATE_S = 20.0  # the longest the gate holds the install
PAST, AFTER, VECTOR_HOLD_S = 2, 10, 1.0
# fault 11's recipe: groups, window, entries before the join, inbox slots
# and entries a message (a window's worth: two catch-up runs exceed the
# window, so the heartbeats that share the inbox cannot crowd them out),
# election and heartbeat ticks (the catch-up's resend waits two
# heartbeats: long ones let it stream), and the longest the joiner's inbox
# is held (until its leaders have sent past the entries before the join)
OVF_GROUPS, OVF_WINDOW, OVF_PRE, OVF_INBOX, OVF_ENTRIES = 2, 32, 48, 8, 32
OVF_ELECTION, OVF_HEARTBEAT, OVF_HOLD_S = 100, 20, 10.0
WIDE_NOTES = 8  # the wide saves _joiner_watch notes in full
FAULT_RTT_MS = 10  # save_fault's tick


class _Gate:
    """Holds one node's installed snapshot at the hand-off from its state
    machine's task worker to the snapshot worker."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.held = threading.Event()
        self.open = threading.Event()
        self.index = 0

    def hold(self, sm, task):
        if (task is None or task.snapshot_requested or not task.init_done
                or sm._node.node_id() != self.node_id or self.open.is_set()):
            return
        self.index = task.index
        self.held.set()
        self.open.wait(GATE_S)


@contextlib.contextmanager
def hole_watch(pkg):
    """Record, during the block, every log hole a log reader of `pkg`
    raises and every save its vector engines log as lacking a payload
    ("missing arena entry"), on any node: lists of (node id, message)."""
    V = importlib.import_module(f"{pkg}.engine.vector")
    LR = importlib.import_module(f"{pkg}.storage.logreader").LogReader
    set_range, errorf = LR.set_range, V._plog.errorf
    got = {"log_holes": [], "missing_saves": []}

    def checked(self, first, length):
        try:
            return set_range(self, first, length)
        except RuntimeError as e:
            if "log hole" in str(e):
                got["log_holes"].append((self.node_id, f"node {self.node_id}: {e}"))
            raise

    def logged(fmt, *a):
        msg = fmt % a if a else fmt
        if "missing arena entry" in msg:
            # the lane's describe(): "[<cluster>:<node>]"
            m = re.search(r"\[\d+:(\d+)\]", msg)
            got["missing_saves"].append((int(m.group(1)) if m else None, msg))
        return errorf(fmt, *a)

    LR.set_range, V._plog.errorf = checked, logged
    try:
        yield got
    finally:
        LR.set_range, V._plog.errorf = set_range, errorf


@contextlib.contextmanager
def _watched(pkg, node_id, gate):
    """Patch `pkg`'s state machine manager with the gate, and record the
    log holes (of any node) and each move of node `node_id`'s log window
    to a snapshot."""
    SMM = importlib.import_module(f"{pkg}.rsm.manager").StateMachineManager
    LR = importlib.import_module(f"{pkg}.storage.logreader").LogReader
    saved = {(SMM, "handle"): SMM.handle, (LR, "apply_snapshot"): LR.apply_snapshot}
    got = {"log_holes": [], "window_moves": []}

    def handle(self, batch, apply):
        t = saved[SMM, "handle"](self, batch, apply)
        gate.hold(self, t)
        return t

    def apply_snapshot(self, ss):
        if self.node_id == node_id:
            got["window_moves"].append({
                "thread": threading.current_thread().name, "index": ss.index,
                "marker": self._marker, "length": self._length,
                "after_gate": gate.held.is_set()})
        return saved[LR, "apply_snapshot"](self, ss)

    SMM.handle, LR.apply_snapshot = handle, apply_snapshot
    try:
        with hole_watch(pkg) as holes:
            yield got
    finally:
        for (cls, n), f in saved.items():
            setattr(cls, n, f)
        got["log_holes"] = [m for _n, m in holes["log_holes"]]


def _leader(hosts, cid=CID):
    """The host that runs and leads group `cid`, or None."""
    return TC._leader_host({n: nh for n, nh in hosts.items() if nh.has_node(cid)}, cid)


def _propose(hosts, n, tag, timeout_s=20.0):
    """Commit `n` entries in one batch through whichever host leads,
    retrying while leadership moves; whether they committed."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        nh = _leader(hosts)
        if nh is None:
            time.sleep(0.02)
            continue
        try:
            rs = nh.propose_batch_async(nh.get_noop_session(CID),
                                        [f"{tag}{i}=v".encode() for i in range(n)], 5.0)
            rs.wait(6.0)
            if rs.completed == rs.n:
                return True
        except Exception:
            pass
        time.sleep(0.05)
    return False


def install_interleaving(pkg, workdir, kind, *, device=None, converge_s=30.0):
    C, NH, _, LB, *_ = TC._mods(pkg)
    KV = TC._kv(pkg)
    reg = LB._Registry()
    addrs = {n: f"li{n}:1" for n in (1, 2, 3)}
    engine = dict(kind=kind, max_groups=8, max_peers=4, log_window=64)
    if device is not None:
        engine["device"] = device
    rtt = VECTOR_RTT_MS if kind == "vector" else SCALAR_RTT_MS
    out = {"kind": kind, "verdicts": {}}
    v = out["verdicts"]
    hosts = {}
    try:
        for n in (1, 2, 3):
            hosts[n] = NH.NodeHost(C.NodeHostConfig(
                deployment_id=16, rtt_millisecond=rtt, nodehost_dir=f"{workdir}/li{n}",
                raft_address=addrs[n],
                raft_rpc_factory=lambda a: LB.loopback_factory(a, reg),
                engine=C.EngineConfig(**engine)))
        for n, nh in hosts.items():
            nh.start_cluster(dict(addrs), False, lambda c, _n: KV(), C.Config(
                cluster_id=CID, node_id=n, election_rtt=10, heartbeat_rtt=2,
                check_quorum=True, snapshot_entries=SNAPSHOT_ENTRIES,
                compaction_overhead=COMPACTION_OVERHEAD))
        v["elected"] = TC._until(lambda: _leader(hosts) is not None, 60.0)
        v["first_entries_committed"] = _propose(hosts, 5, "a")
        found = []
        TC._until(lambda: found.append(_leader(hosts)) or found[-1] is not None, 30.0)
        lead = next(n for n, nh in hosts.items() if nh is found[-1])
        victim = next(n for n in hosts if n != lead)
        out["victim"] = victim
        victim_last = hosts[victim]._get_node(CID).log_reader.get_range()[1]
        hosts[victim].crash_cluster(CID)
        # past a snapshot, and every live replica's log compacted past the
        # victim's last index, so only a snapshot can bring it back
        v["fill_committed"] = _propose(hosts, 40, "f")
        live = [nh for n, nh in hosts.items() if n != victim]

        def compacted():
            for nh in live:
                if nh._get_node(CID).log_reader.get_range()[0] <= victim_last + 1:
                    try:
                        nh.sync_request_snapshot(CID, timeout_s=5.0)
                    except Exception:
                        pass  # one in flight, or a periodic one covers it
            return all(nh._get_node(CID).log_reader.get_range()[0] > victim_last + 1
                       for nh in live)

        v["compacted_past_victim"] = TC._until(compacted, 30.0, poll=0.1)
        gate = _Gate(victim)
        t0 = time.monotonic()
        with _watched(pkg, victim, gate) as got:
            hosts[victim].restart_cluster(CID)
            v["install_reached_the_gate"] = gate.held.wait(60.0)
            out["restart_to_gate_s"] = round(time.monotonic() - t0, 3)
            out["installed_index"] = gate.index
            reader = hosts[victim]._get_node(CID).log_reader
            # commit above the install while the gate holds it
            held = 0
            t_hold = time.monotonic()
            while v["install_reached_the_gate"] and time.monotonic() - t_hold < GATE_S / 2:
                if kind == "scalar" and reader.get_range()[1] >= gate.index + PAST:
                    break
                if kind == "vector" and time.monotonic() - t_hold >= VECTOR_HOLD_S:
                    break
                held += _propose(hosts, 1, f"h{held}_", 5.0)
            out["committed_while_held"] = held
            out["appended_past_install_while_held"] = max(
                reader.get_range()[1] - gate.index, 0)
            gate.open.set()
            v["after_entries_committed"] = _propose(hosts, AFTER, "z")

            def converged():
                applied = {hosts[n].get_applied_index(CID) for n in hosts}
                hashes = {hosts[n].get_sm_hash(CID) for n in hosts}
                return len(applied) == 1 and len(hashes) == 1

            t1 = time.monotonic()
            v["replicas_converged"] = TC._until(converged, converge_s)
            out["converge_s"] = round(time.monotonic() - t1, 3)
            out["applied"] = {n: hosts[n].get_applied_index(CID) for n in hosts}
            out["hashes"] = {n: hosts[n].get_sm_hash(CID) for n in hosts}
        out.update(got)
        v["no_log_hole"] = not got["log_holes"]
    finally:
        for nh in hosts.values():
            nh.stop()
    return out


def worker_window_moves(r):
    """The moves of the follower's window to a snapshot, after the gate,
    that a snapshot worker made."""
    return [m for m in r["window_moves"]
            if m["after_gate"] and m["thread"].startswith(("snap-", "vsnap-"))]


@contextlib.contextmanager
def _joiner_watch(pkg, node_id):
    """Record, for node `node_id`'s vector lanes: the persisted prefix of
    each lane (entries whose save wave returned, contiguous from the
    lane's first save), every ack it sent, the saves wider than the lane's
    arena ring, the saves without a payload and the log holes its log
    reader raised. The first WIDE_NOTES wide saves are noted with what the
    lane's steps since its last save placed: per step, the inbox rows the
    host packed for the lane (slot -> kind and the index range of its
    entries), the step's `rep_base` row, `last_index` and save range."""
    V = importlib.import_module(f"{pkg}.engine.vector")
    E = V.VectorEngine
    saved = {"_commit_saves": E._commit_saves, "_dispatch_sends": E._dispatch_sends,
             "_decode_place": E._decode_place}
    got = {"persisted": {}, "acks": 0, "acked_unpersisted": [], "missing_saves": [],
           "log_holes": [], "wide_saves": 0, "wide_save_notes": []}
    steps = {}  # cluster id -> the lane's steps placed since its last save

    def decode_place(self, o, packs):
        for lane in list(self._lanes.values()):
            if lane.node.node_id() != node_id or not lane.active:
                continue
            g = lane.g
            rows = {}
            for k, info in ((packs or {}).get(lane) or {}).items():
                ents = info[1] if info[0] in ("rep", "prop") else ()
                rows[k] = [info[0]] + ([ents[0].index, ents[-1].index] if ents else [])
            steps.setdefault(lane.node.cluster_id, []).append({
                "base": int(self._m_base[g]), "packed": rows,
                "rep_base": o["rep_base"][g].tolist(),
                "last_index": int(o["last_index"][g]),
                "save": [int(o["save_from"][g]), int(o["save_to"][g])]})
        return saved["_decode_place"](self, o, packs)

    def commit_saves(self, updates, lane_saves):
        r = saved["_commit_saves"](self, updates, lane_saves)
        for lane, ents, _state in lane_saves:
            if lane.node.node_id() != node_id or not ents:
                continue
            cid = lane.node.cluster_id
            placed = steps.pop(cid, [])
            if len(ents) > lane.arena.w:
                got["wide_saves"] += 1
                if len(got["wide_save_notes"]) < WIDE_NOTES:
                    got["wide_save_notes"].append(
                        {"node": lane.node.describe(), "saved": [ents[0].index, ents[-1].index],
                         "steps": placed})
            top = got["persisted"].get(cid, 0)
            # a run that starts above the persisted prefix leaves a hole:
            # the prefix does not grow past it
            if ents[0].index <= top + 1:
                got["persisted"][cid] = ents[-1].index
        return r

    def dispatch_sends(self, sends):
        for lane, m in sends:
            if (lane.node.node_id() == node_id and m.type == V.MT.REPLICATE_RESP
                    and not m.reject):
                got["acks"] += 1
                top = got["persisted"].get(lane.node.cluster_id, 0)
                if m.log_index > top:
                    got["acked_unpersisted"].append(
                        (lane.node.cluster_id, m.log_index, top))
        return saved["_dispatch_sends"](self, sends)

    E._commit_saves, E._dispatch_sends = commit_saves, dispatch_sends
    E._decode_place = decode_place
    try:
        with hole_watch(pkg) as holes:
            yield got
    finally:
        for n, f in saved.items():
            setattr(E, n, f)
        for k in ("log_holes", "missing_saves"):
            got[k] = [m for n, m in holes[k] if n == node_id]


@contextlib.contextmanager
def _held_inbox(pkg, node_id, upto, hold_s):
    """Keep each group's message queue of node `node_id`'s vector nodes from
    their engine, from the group's first below-window reject that a leader
    serves (its host-log catch-up of the node starts there, before it sends
    a run) until the catch-up has sent the group entries up to index
    `upto`, or for at most `hold_s` seconds. Yields a dict with each
    group's hold start ("began") and the highest index sent it ("sent")."""
    V = importlib.import_module(f"{pkg}.engine.vector")
    MQ = importlib.import_module(f"{pkg}.engine.queue").MessageQueue
    E, N = V.VectorEngine, V.VectorNode
    saved = {(MQ, "has_pending"): MQ.has_pending, (N, "__init__"): N.__init__,
             (E, "_below_window_reject"): E._below_window_reject,
             (E, "_run_catchups"): E._run_catchups}
    got = {"began": {}, "sent": {}}
    queues = {}  # id of a held queue -> its group

    def has_pending(self):
        c = queues.get(id(self))
        t0 = got["began"].get(c)
        if (t0 is not None and time.monotonic() - t0 < hold_s
                and got["sent"].get(c, 0) < upto):
            return False
        return saved[MQ, "has_pending"](self)

    def init(self, *a, **kw):
        saved[N, "__init__"](self, *a, **kw)
        if self.node_id() == node_id:
            queues[id(self.mq)] = self.cluster_id

    def rejected(self, lane, p, m):
        got["began"].setdefault(lane.node.cluster_id, time.monotonic())
        return saved[E, "_below_window_reject"](self, lane, p, m)

    def run_catchups(self, lane, o):
        r = saved[E, "_run_catchups"](self, lane, o)
        cid = lane.node.cluster_id
        for cu in lane.catchup.values():
            got["sent"][cid] = max(got["sent"].get(cid, 0), cu[0] - 1)
        return r

    MQ.has_pending, N.__init__ = has_pending, init
    E._below_window_reject, E._run_catchups = rejected, run_catchups
    try:
        yield got
    finally:
        for (cls, n), f in saved.items():
            setattr(cls, n, f)


def _leader_base(hosts, cid):
    """The window base of group `cid`'s lane on its leader's core."""
    nh = TC._leader_host(hosts, cid)
    if nh is None:
        return None
    core = nh.engine.core
    for lane in list(core._lanes.values()):
        if lane.node.cluster_id == cid:
            return int(core._m_base[lane.g])
    return None


def rebased_overflow(pkg, workdir, *, device=None, catch_s=30.0):
    """Fault 11's recipe with the joiner's inbox held from the start of its
    leaders' catch-ups until they have sent it past the entries committed
    before the join (at most OVF_HOLD_S seconds): the runs pile up there
    and its next step takes them together."""
    groups, window, pre_entries = OVF_GROUPS, OVF_WINDOW, OVF_PRE
    C, NH, *_ = TC._mods(pkg)
    LB = importlib.import_module(f"{pkg}.transport.loopback")
    KV = TC._kv(pkg)
    reg = LB._Registry()
    lanes = 3 * groups + groups
    addrs = {n: f"j{n}:1" for n in (1, 2, 3)}

    def cfg(nid, cid):
        return C.Config(cluster_id=cid, node_id=nid, election_rtt=OVF_ELECTION,
                        heartbeat_rtt=OVF_HEARTBEAT, check_quorum=True, snapshot_entries=0)

    hosts = {}
    out = {"groups": groups, "log_window": window, "pre_entries": pre_entries,
           "verdicts": {}}
    v = out["verdicts"]
    jg = list(range(1, groups + 1))
    with _joiner_watch(pkg, 4) as got, \
            _held_inbox(pkg, 4, pre_entries + 1, OVF_HOLD_S) as hold:
        try:
            for n in (1, 2, 3, 4):
                hosts[n] = TC._host(pkg, "j", n, reg, workdir, lanes, window, 1,
                                    TC.JOIN_RTT_MS, device, False, inbox_depth=OVF_INBOX,
                                    max_entries_per_msg=OVF_ENTRIES)
            for n in (1, 2, 3):
                hosts[n].start_clusters([(dict(addrs), False, lambda c, _n: KV(), cfg(n, c))
                                         for c in range(1, groups + 1)])
            v["every_group_elected"] = TC._until(
                lambda: len(TC._leaders(hosts[1])) >= groups, 60.0)
            for c in jg:
                nh = TC._leader_host(hosts, c)
                rs = nh.propose_batch_async(
                    nh.get_noop_session(c),
                    [f"p{i}=v{c}".encode() for i in range(pre_entries)], 20.0)
                rs.wait(30.0)
            out["leader_base"] = {c: _leader_base(hosts, c) for c in jg}
            for c in jg:
                TC._leader_host(hosts, c).request_add_node(c, 4, "j4:1", timeout_s=20.0).wait(30.0)
            hosts[4].start_clusters([({}, True, lambda c, _n: KV(), cfg(4, c)) for c in jg])
            v["catchup_started"] = TC._until(lambda: bool(hold["began"]), 30.0)
            TC._until(lambda: all(hold["sent"].get(c, 0) > pre_entries for c in jg),
                      OVF_HOLD_S + 1.0)
            out["catchup_sent_while_held"] = dict(hold["sent"])
            for c in jg:
                nh = TC._leader_host(hosts, c)
                if nh is not None:
                    try:
                        nh.sync_propose(nh.get_noop_session(c), b"after=join", 20.0)
                    except Exception:
                        pass

            def caught_up():
                for c in jg:
                    nh = TC._leader_host(hosts, c)
                    if nh is None:
                        return False
                    want = nh.get_applied_index(c)
                    if any(hosts[n].get_applied_index(c) != want for n in (1, 2, 3, 4)):
                        return False
                return True

            v["every_joiner_caught_up"] = TC._until(caught_up, catch_s)
            out["joiner_applied"] = {c: hosts[4].get_applied_index(c) for c in jg}
            core = hosts[4].engine.core
            # whether the port's loop stopped on a save it could not make
            out["engine_fault"] = str(getattr(core, "fault", None) or "") or None
        finally:
            for nh in hosts.values():
                nh.stop()
    out.update(got)
    v["no_ack_above_persisted"] = not got["acked_unpersisted"]
    v["no_save_without_payload"] = not got["missing_saves"]
    v["no_log_hole"] = not got["log_holes"]
    return out


def save_fault(pkg, workdir, *, device=None):
    """A save whose payload the follower's arena lacks: three replicas of
    group CID on the vector engine, each host on its own core (K=1). Once
    the group has committed and every replica applied it, the follower's
    `_Arena.get_run` answers the next run it is asked to save with a hole, and the follower proposes one
    entry (forwarded to the leader, replicated back). Recorded: the run
    that missed, the follower's acks and saves at or above it, its
    engine's `fault` and `faults` step stat and the exported
    `engine_step_faults` gauge, how the follower's proposal ended and after
    how long, and how a proposal and a read made after that ended."""
    C, NH, _, LB, *_ = TC._mods(pkg)
    V = importlib.import_module(f"{pkg}.engine.vector")
    R = importlib.import_module(f"{pkg}.requests")
    E = V.VectorEngine
    KV = TC._kv(pkg)
    reg = LB._Registry()
    addrs = {n: f"sf{n}:1" for n in (1, 2, 3)}
    saved = {"get_run": V._Arena.get_run, "_commit_saves": E._commit_saves,
             "_dispatch_sends": E._dispatch_sends, "build": V.build_save_updates}
    # "arena": the follower's arena, "saving": a save wave is being built,
    # "hit": the run it missed
    arm = {}
    seen = {"saves": [], "acks": []}
    out = {"verdicts": {}}
    v = out["verdicts"]

    def get_run(self, lo, hi):
        if arm.get("arena") is self and arm.get("saving") and "hit" not in arm:
            arm["hit"] = (lo, hi)
            return None, lo
        return saved["get_run"](self, lo, hi)

    def build_save_updates(*a):
        # only a save misses: the apply and send paths read the arena too
        arm["saving"] = True
        try:
            return saved["build"](*a)
        finally:
            arm["saving"] = False

    def commit_saves(self, updates, lane_saves):
        for lane, ents, _state in lane_saves:
            if lane.node.node_id() == arm.get("node") and ents:
                seen["saves"].append((ents[0].index, ents[-1].index))
        return saved["_commit_saves"](self, updates, lane_saves)

    def dispatch_sends(self, sends):
        for lane, m in sends:
            if (lane.node.node_id() == arm.get("node") and m.type == V.MT.REPLICATE_RESP
                    and not m.reject):
                seen["acks"].append(m.log_index)
        return saved["_dispatch_sends"](self, sends)

    def outcome(rs, timeout_s):
        r = rs.wait(timeout_s)
        for k in ("completed", "terminated", "dropped", "timeout", "rejected"):
            if getattr(r, k, False):
                return k
        return "pending"

    def attempt(fn):
        try:
            return outcome(fn(), 5.0)
        except R.ErrClusterClosed:
            return "ErrClusterClosed"
        except Exception as e:  # noqa: BLE001 - recorded, not raised
            return type(e).__name__

    V._Arena.get_run, E._commit_saves = get_run, commit_saves
    E._dispatch_sends, V.build_save_updates = dispatch_sends, build_save_updates
    hosts = {}
    try:
        for n in (1, 2, 3):
            hosts[n] = TC._host(pkg, "sf", n, reg, workdir, 4, 32, 1, FAULT_RTT_MS, device,
                                shared=False)
        for n, nh in hosts.items():
            nh.start_cluster(dict(addrs), False, lambda c, _n: KV(), C.Config(
                cluster_id=CID, node_id=n, election_rtt=10, heartbeat_rtt=2,
                check_quorum=True))
        v["elected"] = TC._until(lambda: _leader(hosts) is not None, 60.0)
        v["first_entries_committed"] = _propose(hosts, 5, "a")
        # every replica has applied them, so the next save is the proposal's
        v["caught_up_before_the_miss"] = TC._until(
            lambda: len({nh.get_applied_index(CID) for nh in hosts.values()}) == 1, 30.0)
        lead = _leader(hosts)
        f = next(n for n, nh in hosts.items() if nh is not lead and lead is not None)
        fh = hosts[f]
        core = fh.engine.core
        lane = next(ln for ln in list(core._lanes.values()) if ln.node.cluster_id == CID)
        arm.update(node=f, arena=lane.arena)
        t0 = time.monotonic()
        out["proposal"] = outcome(fh.propose(fh.get_noop_session(CID), b"x=1", 10.0), 11.0)
        out["proposal_s"] = round(time.monotonic() - t0, 3)
        v["the_save_missed"] = "hit" in arm
        lo = arm.get("hit", (0, 0))[0]
        out["missed_run"] = arm.get("hit")
        out["acked_missing"] = [i for i in seen["acks"] if i >= lo]
        out["saved_missing"] = [r for r in seen["saves"] if r[1] >= lo]
        out["fault"] = str(getattr(core, "fault", None) or "") or None
        out["faults_stat"] = fh.engine.step_stats().get("faults")
        fh._export_health_gauges()
        buf = io.StringIO()
        fh.write_health_metrics(buf)
        out["faults_gauge"] = [line for line in buf.getvalue().splitlines()
                               if line.startswith("dragonboat_tpu_engine_step_faults")]
        out["propose_after"] = attempt(
            lambda: fh.propose(fh.get_noop_session(CID), b"y=1", 5.0))
        out["read_after"] = attempt(lambda: fh.read_index(CID, 5.0))
    finally:
        V._Arena.get_run, E._commit_saves = saved["get_run"], saved["_commit_saves"]
        E._dispatch_sends, V.build_save_updates = saved["_dispatch_sends"], saved["build"]
        for nh in hosts.values():
            nh.stop()
    return out
