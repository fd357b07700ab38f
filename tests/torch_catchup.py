"""Two scenarios of the vector engine's follower catch-up, written once for
either package (`pkg` is "dragonboat_tpu" or "dragonboat_tpu_torch"), so a
test can run the same seeded scenario through both and chip_smoke.py can
run it on the card through the port alone.

`join_shared_core`: hosts 1-3 share one vector core at K steps a sync
(or, with shared=False, each runs its own) and run `groups` three-replica
groups; the first `joins` groups each add a fourth replica on host 4 of
the same core, which starts with join=True as an empty member. Before the
join each of those groups commits `pre_entries` entries, so with
`pre_entries` above the log window the joiner is caught up from the
leader's host log (or by a snapshot when `snapshot_entries` compacted it).
Verdicts: every group elected, every add committed, every joiner at its
leader's last index with the post-join entry applied on all four
replicas.

`retry_storm`: three hosts on one core with a 32-entry log window run 4
groups under clients that resubmit a proposal whenever it times out
(0.5 s), while a seeded FaultPlane drops 30% of co-hosted messages and
one host is stalled (partitioned) for seeded windows of 0.5-1.5 s over
8 s; afterwards every group must commit again within 30 s, with its
replicas at one applied index and state machine hash.

Each returns a dict with "verdicts" and what the engines did on the
catch-up path ("catchup", from `catchup_counts`)."""
from __future__ import annotations

import contextlib
import importlib
import random
import threading
import time

import numpy as np


def _mods(pkg):
    m = lambda n: importlib.import_module(f"{pkg}.{n}")
    return (m("config"), m("nodehost"), m("statemachine"), m("transport.loopback"),
            m("engine.vector"), m("faults"), m("requests"))


def _kv(pkg):
    """A KV state machine class of `pkg` ("k=v" commands)."""
    SM = importlib.import_module(f"{pkg}.statemachine")

    class KV(SM.IStateMachine):
        def __init__(self, cluster_id=0, node_id=0):
            self.d = {}

        def update(self, cmd):
            k, v = cmd.decode().split("=", 1)
            self.d[k] = v
            return SM.Result(value=len(self.d))

        def lookup(self, q):
            return self.d.get(q)

        def get_hash(self):
            import zlib

            return zlib.crc32(repr(sorted(self.d.items())).encode())

        def save_snapshot(self, w, files, done):
            import json

            w.write(json.dumps(self.d).encode())

        def recover_from_snapshot(self, r, files, done):
            import json

            self.d = json.loads(r.read().decode())

    return KV


@contextlib.contextmanager
def catchup_counts(pkg):
    """Count, during the block, what `pkg`'s vector engines do on the
    catch-up path: host-log catch-ups started, below-window rejects served,
    snapshots sent, snapshot requests that found no snapshot, and the
    multi-step routing table's rebuilds with the device routes they left
    to a lane that keeps the sender at another slot ("misrouted": such a
    lane cannot answer what the router delivers)."""
    V = importlib.import_module(f"{pkg}.engine.vector").VectorEngine
    got = {"catchup_starts": 0, "below_window_rejects": 0, "snapshots_sent": 0,
           "no_snapshot": 0, "route_rebuilds": 0, "misrouted": 0}
    saved = {n: getattr(V, n) for n in ("_start_catchup", "_below_window_reject",
                                        "_send_snapshot", "_rebuild_routes")}

    def routes(self):
        # each device route the rebuild leaves from a lane to a lane that
        # keeps its sender at another slot than the one the router stamps
        saved["_rebuild_routes"](self)
        got["route_rebuilds"] += 1
        for g, p in zip(*np.nonzero(self._np_route >= 0)):
            src, dst = self._lane_by_g[g], self._lane_by_g[self._np_route[g, p]]
            if src is not None and dst is not None and (
                    dst.slots.get(src.node.node_id()) != src.self_slot()):
                got["misrouted"] += 1

    def start(self, lane, p, o):
        had = p in lane.catchup
        saved["_start_catchup"](self, lane, p, o)
        got["catchup_starts"] += int(not had and p in lane.catchup)

    def reject(self, lane, p, m):
        got["below_window_rejects"] += 1
        saved["_below_window_reject"](self, lane, p, m)

    def send(self, lane, p):
        saved["_send_snapshot"](self, lane, p)
        ent = lane.snap_inflight.get(p)
        if ent is not None and ent[1] == 0:
            got["no_snapshot"] += 1
        elif ent is not None:
            got["snapshots_sent"] += 1

    V._start_catchup, V._below_window_reject, V._send_snapshot = start, reject, send
    V._rebuild_routes = routes
    try:
        yield got
    finally:
        for n, f in saved.items():
            setattr(V, n, f)


def _host(pkg, tag, nid, reg, workdir, groups, window, steps, rtt_ms, device, shared=True,
          **engine):
    C, NH, _, LB, *_ = _mods(pkg)
    if device is not None:
        engine["device"] = device
    return NH.NodeHost(C.NodeHostConfig(
        deployment_id=14, rtt_millisecond=rtt_ms, nodehost_dir=f"{workdir}/{tag}{nid}",
        raft_address=f"{tag}{nid}:1", raft_rpc_factory=lambda a: LB.loopback_factory(a, reg),
        engine=C.EngineConfig(kind="vector", max_groups=groups, max_peers=4,
                              log_window=window, steps_per_sync=steps,
                              share_scope=f"catchup-{tag}-{id(reg)}" if shared else None,
                              **engine)))


def _leaders(nh):
    return {c: lid for c, (lid, _t) in nh.engine.leader_snapshot().items() if lid}


def _leader_host(hosts, cid):
    """The host that leads group `cid` and is not partitioned, or None."""
    for n, nh in hosts.items():
        if nh.is_partitioned():
            continue
        lid, ok = nh.get_leader_id(cid)
        if ok and lid == n:
            return nh
    return None


def _until(pred, timeout_s, poll=0.05):
    deadline = time.monotonic() + timeout_s
    while True:
        if pred():
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(poll)


def _sm_value(nh, cid, key):
    try:
        return nh.stale_read(cid, key)
    except Exception:
        return None


JOIN_RTT_MS = 10
STORM_RTT_MS = 5
STORM_GROUPS, STORM_WINDOW = 4, 32
STORM_S, STORM_DROP, STORM_STALL_S = 8.0, 0.3, (0.5, 1.5)
STORM_ELECTION, STORM_HEARTBEAT = 50, 5
CLIENT_TIMEOUT_S = 0.5
RECOVER_S = 30.0


def join_shared_core(pkg, workdir, *, groups=4, joins=2, window=32, steps=8,
                     election=20, heartbeat=4, pre_entries=48, snapshot_entries=0,
                     inbox_depth=8, entries_per_msg=8, device=None, elect_s=60.0,
                     catch_s=60.0, shared=True):
    C, NH, *_ = _mods(pkg)
    LB = importlib.import_module(f"{pkg}.transport.loopback")
    KV = _kv(pkg)
    reg = LB._Registry()
    lanes = 3 * groups + joins
    addrs = {n: f"j{n}:1" for n in (1, 2, 3)}

    def cfg(nid, cid):
        return C.Config(cluster_id=cid, node_id=nid, election_rtt=election,
                        heartbeat_rtt=heartbeat, check_quorum=True,
                        snapshot_entries=snapshot_entries,
                        compaction_overhead=4 if snapshot_entries else 0)

    hosts = {}
    out = {"groups": groups, "joins": joins, "lanes": lanes, "log_window": window,
           "steps_per_sync": steps, "pre_entries": pre_entries, "verdicts": {}}
    v = out["verdicts"]
    t0 = time.monotonic()
    with catchup_counts(pkg) as counts:
        try:
            for n in (1, 2, 3, 4):
                hosts[n] = _host(pkg, "j", n, reg, workdir, lanes, window, steps, JOIN_RTT_MS,
                                 device, shared, inbox_depth=inbox_depth,
                                 max_entries_per_msg=entries_per_msg)
            for n in (1, 2, 3):
                hosts[n].start_clusters([(dict(addrs), False, lambda c, _n: KV(), cfg(n, c))
                                         for c in range(1, groups + 1)])
            v["every_group_elected"] = _until(
                lambda: len(_leaders(hosts[1])) >= groups, elect_s)
            out["elect_s"] = round(time.monotonic() - t0, 3)
            jg = list(range(1, joins + 1))

            def via_leader(fn, timeout_s):
                # each join group's request through its current leader,
                # retried while leadership moves
                left = set(jg)
                deadline = time.monotonic() + timeout_s
                while left and time.monotonic() < deadline:
                    lead = _leaders(hosts[1])
                    pend = [(c, fn(hosts[lead[c]], c)) for c in sorted(left)
                            if lead.get(c) in (1, 2, 3)]
                    for c, rs in pend:
                        r = rs.wait(timeout_s)
                        # a batch's wait returns whether it finished
                        ok = rs.completed == rs.n if hasattr(rs, "n") else r.completed
                        if ok:
                            left.discard(c)
                    if left:
                        time.sleep(0.1)
                return not left

            # the leaders' logs run past the window before the join
            v["pre_entries_committed"] = via_leader(
                lambda nh, c: nh.propose_batch_async(
                    nh.get_noop_session(c), [f"p{i}=v{c}".encode() for i in range(pre_entries)],
                    20.0), 30.0) if pre_entries else True
            v["every_add_committed"] = via_leader(
                lambda nh, c: nh.request_add_node(c, 4, "j4:1", timeout_s=20.0), 60.0)
            t_join = time.monotonic()
            hosts[4].start_clusters([({}, True, lambda c, _n: KV(), cfg(4, c)) for c in jg])
            v["post_join_entry_committed"] = via_leader(
                lambda nh, c: nh.propose(nh.get_noop_session(c), b"after=join", 20.0), 60.0)

            def caught_up():
                lead = _leaders(hosts[1])
                for c in jg:
                    if lead.get(c) not in hosts:
                        return False
                    want = hosts[lead[c]].get_applied_index(c)
                    for n in (1, 2, 3, 4):
                        if (hosts[n].get_applied_index(c) != want
                                or _sm_value(hosts[n], c, "after") != "join"):
                            return False
                return True

            v["every_joiner_caught_up"] = _until(caught_up, catch_s)
            out["join_to_caught_up_s"] = round(time.monotonic() - t_join, 3)
            out["replicas_with_post_join_entry"] = {
                c: sum(_sm_value(hosts[n], c, "after") == "join" for n in (1, 2, 3, 4))
                for c in jg}
            out["joiner_applied"] = {c: hosts[4].get_applied_index(c) for c in jg}
            lead = _leaders(hosts[1])
            out["leader_applied"] = {c: hosts[lead[c]].get_applied_index(c) for c in jg
                                     if lead.get(c) in hosts}
        finally:
            for nh in hosts.values():
                nh.stop()
    out["catchup"] = dict(counts)
    out["seconds"] = round(time.monotonic() - t0, 3)
    return out


def retry_storm(pkg, workdir, *, seed, device=None):
    C, NH, _, LB, _, F, RQ = _mods(pkg)
    groups = STORM_GROUPS
    KV = _kv(pkg)
    reg = LB._Registry()
    addrs = {n: f"r{n}:1" for n in (1, 2, 3)}
    hosts = {}
    out = {"groups": groups, "lanes": 3 * groups, "log_window": STORM_WINDOW, "seed": seed,
           "storm_s": STORM_S, "drop": STORM_DROP, "verdicts": {}}
    v = out["verdicts"]
    fp = F.FaultPlane(seed, F.FaultSpec(drop=STORM_DROP))
    stop = threading.Event()
    done = {c: 0 for c in range(1, groups + 1)}
    commit_at = {c: [] for c in range(1, groups + 1)}
    resubmits = [0]

    def client(c):
        # resubmit a timed-out proposal until it commits, then the next
        rng = random.Random(seed * 1000 + c)
        n = 0
        while not stop.is_set():
            nh = _leader_host(hosts, c)
            if nh is None:
                time.sleep(0.01)
                continue
            try:
                rs = nh.propose(nh.get_noop_session(c), f"c{n % 8}=v{n}".encode(),
                                CLIENT_TIMEOUT_S)
                r = rs.wait(CLIENT_TIMEOUT_S + 1.0)
            except RQ.RequestError:
                r = None
            if r is not None and r.completed:
                done[c] += 1
                commit_at[c].append(time.monotonic())
                n += 1
            else:
                resubmits[0] += 1
            time.sleep(rng.random() * 0.005)

    t0 = time.monotonic()
    with catchup_counts(pkg) as counts:
        try:
            for n in (1, 2, 3):
                hosts[n] = _host(pkg, "r", n, reg, workdir, 3 * groups, STORM_WINDOW, 1, STORM_RTT_MS,
                                 device)
                hosts[n].start_clusters([
                    (dict(addrs), False, lambda c, _n: KV(),
                     C.Config(cluster_id=c, node_id=n, election_rtt=STORM_ELECTION,
                              heartbeat_rtt=STORM_HEARTBEAT, check_quorum=True, snapshot_entries=0))
                    for c in range(1, groups + 1)])
            v["every_group_elected"] = _until(lambda: len(_leaders(hosts[1])) >= groups, 60.0)
            clients = [threading.Thread(target=client, args=(c,), daemon=True)
                       for c in range(1, groups + 1)]
            for t in clients:
                t.start()
            # the storm: co-hosted drops armed on the whole core, and one
            # host stalled for seeded windows
            fp.install(hosts[1], "h1")
            t_storm = time.monotonic()
            victim = fp.choice("storm", "victim", (1, 2, 3))
            end = time.monotonic() + STORM_S
            stalls = 0
            while time.monotonic() < end:
                hosts[victim].set_partitioned(True)
                stalls += 1
                time.sleep(fp.uniform("storm", "stall", *STORM_STALL_S))
                hosts[victim].set_partitioned(False)
                time.sleep(fp.uniform("storm", "gap", 0.1, 0.5))
            fp.uninstall_all()
            stop.set()
            for t in clients:
                t.join(timeout=5)
            t_end = time.monotonic()
            # the longest time each group went without a commit in the storm
            gaps = {c: round(max(b - a for a, b in zip([t_storm] + ts, ts + [t_end])), 3)
                    for c, ts in commit_at.items()}
            out.update(victim=victim, stalls=stalls, committed_in_storm=dict(done),
                       resubmits=resubmits[0], longest_commit_gap_s=gaps)
            # after the storm: every group commits again, on every replica
            t_rec = time.monotonic()
            recovered = {}

            def commit_all():
                for c in range(1, groups + 1):
                    nh = None if c in recovered else _leader_host(hosts, c)
                    if nh is None:
                        continue
                    try:
                        r = nh.propose(nh.get_noop_session(c), b"after=storm", 2.0).wait(3.0)
                    except RQ.RequestError:
                        continue
                    if r is not None and r.completed:
                        recovered[c] = round(time.monotonic() - t_rec, 3)
                return len(recovered) == groups

            v["every_group_commits_after_storm"] = _until(commit_all, RECOVER_S)
            v["replicas_converged"] = _until(lambda: all(
                len({hosts[n].get_applied_index(c) for n in (1, 2, 3)}) == 1
                and len({hosts[n].get_sm_hash(c) for n in (1, 2, 3)}) == 1
                for c in range(1, groups + 1)), RECOVER_S)
            out["recovered_s"] = recovered
            out["applied"] = {c: [hosts[n].get_applied_index(c) for n in (1, 2, 3)]
                              for c in range(1, groups + 1)}
        finally:
            stop.set()
            for nh in hosts.values():
                nh.stop()
    out["catchup"] = dict(counts)
    out["seconds"] = round(time.monotonic() - t0, 3)
    return out
