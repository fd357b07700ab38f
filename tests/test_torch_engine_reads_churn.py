"""One seeded script with reads, lease reads, drops, snapshots and
membership changes through the JAX package's NodeHost and the port's (on
the CPU): 5 hosts sharing one vector-engine core (`max_peers=5`), 4 groups.
Groups 1-2 read through leader leases (`Config.lease_read`), groups 3-4
through ReadIndex; a seeded hook drops 5% of the co-hosted REPLICATE and
REPLICATE_RESP messages from the start of the script; each group's client
writes its keys in batches with a linearizable read after each, takes a
snapshot midway, adds a never-started observer as node 6 and deletes it
again, and finishes its writes; then each lease group's leader serves a
read off its lease on the quiet cluster. Both packages must end with the same KV
in every group on all five replicas (the script fixes it), the same
applied membership and the same count of successful changes, a snapshot
index above 0, lease reads served off the lease, and a linearizable
history."""
import importlib
import random
import threading
import time

import torch

GROUPS, PROPOSALS, KEYS, BATCH = 4, 40, 3, 5
MEMBERS = {n: f"rc:{n}" for n in range(1, 6)}
LEASE_GROUPS = (1, 2)
# a lease lives election_rtt - heartbeat_rtt ticks (8 at 50 ms) from the
# start of the heartbeat round a quorum acked, which spans about three
# engine steps: it lapses once steps pass ~130 ms
ELECTION_RTT = 10
OBSERVER = 6


def run_script(pkg):
    C = importlib.import_module(pkg + ".config")
    NH = importlib.import_module(pkg + ".nodehost")
    SM = importlib.import_module(pkg + ".statemachine")
    LB = importlib.import_module(pkg + ".transport.loopback")
    L = importlib.import_module(pkg + ".lincheck")
    T = importlib.import_module(pkg + ".types")
    replicas = []

    class KV(SM.IStateMachine):
        def __init__(self, cluster_id, node_id):
            self.cluster_id, self.node_id, self.data = cluster_id, node_id, {}
            replicas.append(self)

        def update(self, cmd):
            k, v = cmd.decode().split("=", 1)
            self.data[k] = v
            return SM.Result(value=len(self.data))

        def lookup(self, q):
            return self.data.get(q)

        def save_snapshot(self, w, files, done):
            import json

            w.write(json.dumps(self.data).encode())

        def recover_from_snapshot(self, r, files, done):
            import json

            self.data = json.loads(r.read().decode())

    reg = LB._Registry()
    kw = dict(kind="vector", max_groups=5 * GROUPS, max_peers=5, log_window=32,
              share_scope=f"rc-{pkg}-{id(reg)}")
    if pkg == "dragonboat_tpu_torch":
        kw["device"] = "cpu"
    hosts = {
        nid: NH.NodeHost(C.NodeHostConfig(
            deployment_id=1, rtt_millisecond=50, raft_address=addr,
            raft_rpc_factory=lambda listen: LB.loopback_factory(listen, reg),
            engine=C.EngineConfig(**kw)))
        for nid, addr in MEMBERS.items()
    }
    rec = L.HistoryRecorder()
    drops = [0]
    rnd = random.Random(1234)
    rep = (T.MessageType.REPLICATE, T.MessageType.REPLICATE_RESP)

    def drop(m):
        if m.type in rep and rnd.random() < 0.05:
            drops[0] += 1
            return True
        return False

    try:
        for nid, nh in hosts.items():
            nh.start_clusters([
                (dict(MEMBERS), False, KV,
                 C.Config(cluster_id=c, node_id=nid, election_rtt=ELECTION_RTT,
                          heartbeat_rtt=2, check_quorum=True, lease_read=c in LEASE_GROUPS))
                for c in range(1, GROUPS + 1)])

        def leader(c):
            for nid, nh in hosts.items():
                lid, ok = nh.get_leader_id(c)
                if ok and lid == nid:
                    return nh
            return None

        deadline = time.monotonic() + 60
        while any(leader(c) is None for c in range(1, GROUPS + 1)):
            assert time.monotonic() < deadline, "groups never elected"
            time.sleep(0.05)
        hosts[1].engine.core.set_local_drop_hook(drop)
        errors, snaps, changes = [], {}, {}

        def retry(c, fn):
            for _attempt in range(40):
                nh = leader(c) or hosts[1]
                try:
                    return fn(nh)
                except Exception:
                    time.sleep(0.05)
            errors.append((c, fn))
            return None

        def put(c, k, v):
            def fn(nh):
                op = rec.invoke(c, ("put", f"g{c}{k}", v))
                try:
                    nh.sync_propose(nh.get_noop_session(c), f"{k}={v}".encode(), timeout_s=5.0)
                except Exception:
                    rec.unknown(op)  # may or may not have applied
                    raise
                rec.complete(op, None)

            retry(c, fn)

        def get(c, k):
            nh = leader(c) or hosts[1]
            op = rec.invoke(c, ("get", f"g{c}{k}"))
            try:
                rec.complete(op, nh.sync_read(c, k, timeout_s=5.0))
            except Exception:
                rec.fail(op)  # a read that failed changed nothing

        def client(c):
            for j0 in range(0, PROPOSALS, BATCH):
                for j in range(j0, j0 + BATCH):
                    put(c, f"k{j % KEYS}", str(j))
                get(c, f"k{j0 % KEYS}")
                if j0 == PROPOSALS // 2:
                    snaps[c] = retry(c, lambda nh: nh.sync_request_snapshot(c, timeout_s=10.0))
                    # one attempt each (a retried change could apply twice)
                    n = 0
                    for change in (
                        lambda nh: nh.sync_request_add_observer(
                            c, OBSERVER, "rc:absent", timeout_s=10.0),
                        lambda nh: nh.sync_request_delete_node(c, OBSERVER, timeout_s=10.0),
                    ):
                        try:
                            change(leader(c) or hosts[1])
                            n += 1
                        except Exception as e:
                            errors.append((c, repr(e)))
                    changes[c] = n

        threads = [threading.Thread(target=client, args=(c,)) for c in range(1, GROUPS + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        want = {f"k{k}": str(max(j for j in range(PROPOSALS) if j % KEYS == k))
                for k in range(KEYS)}
        deadline = time.monotonic() + 30
        while True:
            by_group = {}
            for sm in replicas:
                if sm.data:
                    by_group.setdefault(sm.cluster_id, {})[sm.node_id] = dict(sm.data)
            done = (len(by_group) == GROUPS
                    and all(len(v) == 5 and all(d == want for d in v.values())
                            for v in by_group.values()))
            if done or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        # the script's lease reads ran beside its writes and may all have
        # fallen back to ReadIndex on a loaded host (still linearizable);
        # on the quiet cluster each lease group's leader must serve a read
        # off its lease (NodeHost.lease_read refuses without a live lease)
        core = hosts[1].engine.core
        for c in LEASE_GROUPS:
            served = core.lease_stats()["local"]
            deadline = time.monotonic() + 30
            while core.lease_stats()["local"] == served:
                assert time.monotonic() < deadline, f"group {c}: no lease serve"
                nh = leader(c)
                if nh is None:
                    time.sleep(0.05)
                    continue
                op = rec.invoke(c, ("get", f"g{c}k0"))
                try:
                    rec.complete(op, nh.lease_read(c, "k0", timeout_s=5.0))
                except Exception:
                    rec.fail(op)
                    time.sleep(0.05)
        members = {}
        for c in range(1, GROUPS + 1):
            views = set()
            for nh in hosts.values():
                m = nh.get_cluster_membership(c)
                views.add((tuple(sorted(m.addresses)), tuple(sorted(m.observers)),
                           tuple(sorted(m.witnesses)), tuple(sorted(m.removed))))
            members[c] = views
        lease = core.lease_stats()
        return dict(kv={c: v for c, v in sorted(by_group.items())}, hist=rec.history(),
                    snaps=snaps, changes=changes, members=members, lease=lease,
                    drops=drops[0])
    finally:
        for nh in hosts.values():
            nh.stop()


def test_reads_drops_snapshots_and_churn_reach_the_same_verdicts():
    from dragonboat_tpu.lincheck import check_kv_history
    from dragonboat_tpu_torch.lincheck import check_kv_history as port_check

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref, port = (run_script(pkg) for pkg in ("dragonboat_tpu", "dragonboat_tpu_torch"))
    finally:
        torch.set_num_threads(n)
    for r in (ref, port):
        # five equal replicas per group holding the script's final KV
        assert sorted(r["kv"]) == list(range(1, GROUPS + 1))
        for c, by_node in r["kv"].items():
            assert sorted(by_node) == list(MEMBERS), c
        # every replica agrees on the applied membership: the five
        # members, no observer left, node 6 removed
        for c, views in r["members"].items():
            assert views == {(tuple(MEMBERS), (), (), (OBSERVER,))}, (c, views)
        assert all(i > 0 for i in r["snaps"].values()) and len(r["snaps"]) == GROUPS
        assert r["changes"] == {c: 2 for c in range(1, GROUPS + 1)}
        assert r["drops"] > 0
        # the lease groups' reads were served off a live lease
        assert r["lease"]["local"] > 0, r["lease"]
    assert port["kv"] == ref["kv"]
    assert port["members"] == ref["members"]
    assert port["changes"] == ref["changes"]
    assert check_kv_history(ref["hist"]) and port_check(ref["hist"])
    assert check_kv_history(port["hist"]) and port_check(port["hist"])
