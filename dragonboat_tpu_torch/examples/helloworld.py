"""helloworld: a 3-replica ordered-KV Raft group end to end, on the
PyTorch port.

The twin of the JAX package's `examples/helloworld.py`: start three
NodeHosts, let them elect a leader, make linearizable proposals and reads,
move leadership, kill a replica and watch the survivors keep serving, then
restart it and watch it catch up from its durable state. Each NodeHost
runs the port's vector engine, whose protocol step is the CUDA kernel
`csrc/step_batch.cu` on the card (the default) or its plain PyTorch
version with `--device cpu`.

Run:

    python -m dragonboat_tpu_torch.examples.helloworld
    python -m dragonboat_tpu_torch.examples.helloworld --device cpu

Three NodeHosts live in this one process and talk over real TCP on
localhost ports 26111-26113; each persists under `--data` (default
./helloworld-data/), which is removed at the end.
"""
import argparse
import json
import os
import shutil
import sys
import time

from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.requests import RequestError
from dragonboat_tpu_torch.statemachine import IStateMachine, Result

CLUSTER_ID = 128
BASE_PORT = 26110


class KVStore(IStateMachine):
    """The replicated state machine: an ordered map of str -> str.

    Commands are "key=value" bytes; lookups are the key. Snapshots write
    the whole table; recover rebuilds it. The framework guarantees update
    is applied in log order on every replica."""

    def __init__(self, cluster_id: int, node_id: int):
        self.table = {}

    def update(self, data: bytes) -> Result:
        key, value = data.decode().split("=", 1)
        self.table[key] = value
        return Result(value=len(self.table))

    def lookup(self, query):
        q = query.decode() if isinstance(query, bytes) else query
        v = self.table.get(q)
        return v.encode() if v is not None else None

    def save_snapshot(self, w, files, done) -> None:
        w.write(json.dumps(self.table).encode())

    def recover_from_snapshot(self, r, files, done) -> None:
        self.table = json.loads(r.read().decode())

    def close(self) -> None:
        pass


class Cluster:
    """The three hosts of the example and how to (re)start one."""

    def __init__(self, data: str, device: str):
        self.data, self.device = data, device
        self.addrs = {n: f"127.0.0.1:{BASE_PORT + n}" for n in (1, 2, 3)}
        # the plain step on the CPU costs milliseconds: slower ticks there
        self.rtt_ms = 10 if device != "cpu" else 50
        self.hosts = {}

    def start(self, node_id: int, restart: bool = False) -> NodeHost:
        nh = NodeHost(NodeHostConfig(
            deployment_id=2026,
            rtt_millisecond=self.rtt_ms,
            raft_address=self.addrs[node_id],
            nodehost_dir=os.path.join(self.data, f"node{node_id}"),
            engine=EngineConfig(kind="vector", max_groups=4, max_peers=4,
                                log_window=64, device=self.device),
        ))
        nh.start_cluster(
            {} if restart else dict(self.addrs),  # {} = restart from durable state
            False,
            KVStore,
            Config(cluster_id=CLUSTER_ID, node_id=node_id,
                   election_rtt=20, heartbeat_rtt=2,
                   snapshot_entries=100, compaction_overhead=20),
        )
        self.hosts[node_id] = nh
        return nh

    def wait_leader(self, timeout_s=60.0) -> int:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            for nh in self.hosts.values():
                if nh is None:
                    continue
                leader, ok = nh.get_leader_id(CLUSTER_ID)
                if ok and self.hosts.get(leader) is not None:
                    return leader
            time.sleep(0.05)
        raise SystemExit("no leader elected")

    def propose_retry(self, leader: int, cmd: bytes, attempts=5):
        """Propose with leader re-resolution: real Raft clients retry
        dropped or timed-out proposals against the current leader — a
        proposal handed to a just-deposed leader is rejected, not silently
        re-routed."""
        last = None
        for _ in range(attempts):
            try:
                s = self.hosts[leader].get_noop_session(CLUSTER_ID)
                return self.hosts[leader].sync_propose(s, cmd, timeout_s=10.0), leader
            except RequestError as e:
                last = e
                time.sleep(0.2)
                leader = self.wait_leader()
        raise last

    def stop(self) -> None:
        for nh in self.hosts.values():
            if nh is not None:
                nh.stop()


def run(cluster: Cluster) -> None:
    hosts = cluster.hosts
    for nid in cluster.addrs:
        cluster.start(nid)
    leader = cluster.wait_leader()
    print(f"leader elected: node {leader}")

    # --- linearizable writes (retrying across leadership churn, as any
    # real Raft client does)
    for i in range(10):
        r, leader = cluster.propose_retry(
            leader, f"greeting{i}=hello world {i}".encode())
        print(f"proposed greeting{i}; table size on apply: {r.value}")

    # --- linearizable read from a FOLLOWER host (ReadIndex)
    follower = next(n for n in hosts if n != leader)
    v = hosts[follower].sync_read(CLUSTER_ID, b"greeting7", timeout_s=10.0)
    print(f"linearizable read via follower node {follower}: {v}")
    if v != b"hello world 7":
        raise SystemExit(f"follower read returned {v!r}")

    # --- move leadership
    hosts[leader].request_leader_transfer(CLUSTER_ID, follower)
    deadline = time.time() + 30
    while time.time() < deadline:
        lid, ok = hosts[follower].get_leader_id(CLUSTER_ID)
        if ok and lid == follower:
            break
        time.sleep(0.05)
    else:
        raise SystemExit("leader transfer did not complete")
    print(f"leadership transferred to node {follower}")

    # --- kill one replica: quorum of 2 keeps the group available
    victim = next(n for n in hosts if n != follower)
    print(f"stopping node {victim} ...")
    hosts[victim].stop()
    hosts[victim] = None
    leader = cluster.wait_leader()
    _, leader = cluster.propose_retry(leader, b"during_outage=still here")
    print("proposed during the outage: ok")

    # --- restart it from durable state; it replays and catches up
    print(f"restarting node {victim} ...")
    cluster.start(victim, restart=True)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if hosts[victim].stale_read(CLUSTER_ID, b"during_outage") == b"still here":
                break
        except Exception:
            pass
        time.sleep(0.1)
    else:
        raise SystemExit(f"node {victim} never caught up after restart")
    print(f"node {victim} caught up after restart")
    print("HELLOWORLD PASS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.examples.helloworld",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engines' tensors live (default: the card)")
    ap.add_argument("--data", default="helloworld-data",
                    help="directory the three hosts persist under (removed at the end)")
    args = ap.parse_args(argv)
    shutil.rmtree(args.data, ignore_errors=True)
    cluster = Cluster(args.data, args.device)
    try:
        run(cluster)
    finally:
        cluster.stop()
        shutil.rmtree(args.data, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
