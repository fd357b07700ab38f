"""End-to-end benchmark of the port: NodeHosts, the vector engine on a torch
device, quorum, fsync and apply.

This is the JAX package's `bench.py` (`bench_e2e` with shared=True and
`_run_ladder_config`) for the BASELINE configs 1-8: N NodeHosts share ONE
engine core (`EngineConfig.share_scope`), G groups x N replicas, each group
keeping one async batch of `wave` proposals in flight and resubmitting the
moment it completes. The traffic of each config is bench.py's: R ReadIndex
reads per write (`read_ratio`, configs 3 and 8), leader-lease reads
(`read_mode="lease"`, config 8's second run), seeded drops of replication
traffic over the co-hosted path (`drop_rate`, config 4), and a snapshot plus
an observer add or delete every 0.5 s (`churn`, config 5); config 7
(`through_front`) sends its waves through each host's serving front, per
tenant, with an at-most-once session lane and a placement plane live
(bench.py `_front_measure`). The report keeps
every key of bench.py's record for the config (its stamps and its folds:
reads, census and counters, history sampler, attribution, lanes, mesh,
serving, latency and host stages) and adds what a card run needs: the
`host`, `backend` and card stamps, engine steps per second, the window's
out-of-seam syncs and kernel builds, a device busy share over a profiler
window, the drop hook's own count, a replica-convergence check and a
linearizability check of a recorded propose/read history whose reads take
the run's read path.

Run one config on the card at its nominal width, or on the CPU cut down:

    python3 -m dragonboat_tpu_torch.e2e --config 3
    python3 -m dragonboat_tpu_torch.e2e --config 3 --device cpu --groups 4 --duration 3
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import random
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

from .config import Config, EngineConfig, NodeHostConfig
from .events import Histogram
from .lincheck import HistoryRecorder, check_kv_history
from .statemachine import IConcurrentStateMachine, Result

#: BASELINE configs (bench.py LADDER, `:1124-1182`): `nominal_groups` is the
#: regime the config names, `groups` the cut bench.py's own runs make
LADDER = {
    1: dict(
        label="3-node, 1 group, 16B (benchmark_test.go baseline)",
        nominal_groups=1, groups=1, replicas=3, payload=16, wave=512,
        duration=6.0,
    ),
    2: dict(
        label="3-node, 1024 groups, 16B, batched step",
        nominal_groups=1024, groups=1024, replicas=3, payload=16,
        wave=128, duration=10.0,
    ),
    3: dict(
        label="5-node, 10k groups, 9:1 ReadIndex:write, elections on",
        nominal_groups=10_000, groups=256, replicas=5, payload=16,
        wave=8, duration=8.0, read_ratio=9,
    ),
    4: dict(
        label="5-node, 50k groups, 128B, randomized follower drops",
        nominal_groups=50_000, groups=256, replicas=5, payload=128,
        wave=64, duration=8.0, drop_rate=0.01,
    ),
    5: dict(
        label="5-node, 50k groups, membership + snapshot interleave",
        nominal_groups=50_000, groups=128, replicas=5, payload=16,
        wave=64, duration=8.0, churn=True,
    ),
    6: dict(
        label="3-node, 1024 groups, 16B, K=8 device-resident super-steps",
        nominal_groups=1024, groups=1024, replicas=3, payload=16,
        wave=128, duration=10.0, steps_per_sync=8,
    ),
    7: dict(
        label="3-node, 64 groups, 16B, through_front: sessions + "
              "admission + placement",
        nominal_groups=64, groups=64, replicas=3, payload=16,
        wave=32, duration=8.0, through_front=True, tenants=4,
    ),
    8: dict(
        label="3-node, 1024 groups, 16B, read_heavy 9:1, "
              "lease vs ReadIndex reads",
        nominal_groups=1024, groups=1024, replicas=3, payload=16,
        wave=8, duration=10.0, read_ratio=9, both_read_modes=True,
    ),
}

# the keys of the ReadIndex run that config 8's record carries beside the
# lease run's own (bench.py `_run_ladder_config`)
_READINDEX_MODE_KEYS = (
    "value", "reads_per_sec", "read_latency_p50_s", "read_latency_p99_s",
    "read_latency_samples", "committed", "seconds", "bring_up_s",
)

# the load's proposal and read timeout. bench.py's 15 s suits steps of
# milliseconds; at 5120 lanes a wave takes 6-16 s on the card's host, and
# waves that time out leave their entries replicating while the client
# sends new ones, so the load stops being one wave per group in flight
# and backs up the engine. 60 s keeps the load closed-loop as bench.py
# intends
CLIENT_TIMEOUT_S = 60.0

# commands of the lincheck clients: b"kv:<key>=<value>"; every other
# command only advances the counter
_KV = b"kv:"

class BenchSM(IConcurrentStateMachine):
    """In-memory counter SM (bench.py's `_BenchSM`): update() takes the
    whole committed batch in ONE call. It also keeps the b"kv:" writes of
    the lincheck clients, and registers itself by (cluster, node) on its
    first update or snapshot restore (the NodeHost also makes one probe
    instance that never runs), so a run can compare the replicas of every
    group."""

    replicas: Dict[tuple, "BenchSM"] = {}
    _mu = threading.Lock()

    def __init__(self, cluster_id, node_id):
        self.key = (cluster_id, node_id)
        self.n = 0
        self.kv: Dict[str, str] = {}
        self._registered = False

    def _register(self):
        self._registered = True
        with BenchSM._mu:
            BenchSM.replicas[self.key] = self

    def update(self, entries):
        if not self._registered:
            self._register()
        n = self.n
        for e in entries:
            n += 1
            if e.cmd[:3] == _KV:
                k, v = e.cmd[3:].decode().split("=", 1)
                self.kv[k] = v
            e.result = Result(value=n)
        self.n = n
        return entries

    def lookup(self, q):
        return self.kv.get(q) if isinstance(q, str) else self.n

    def prepare_snapshot(self):
        return (self.n, dict(self.kv))

    def save_snapshot(self, ctx, w, fc, done):
        w.write(json.dumps(ctx).encode())

    def recover_from_snapshot(self, r, fc, done):
        self.n, self.kv = json.loads(r.read().decode())
        if not self._registered:
            self._register()

    def close(self):
        pass


# ------------------------------------------------------------------ stamps

def card_stamp() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if not out:
        return {"card": "not measured", "power_limit": "not measured"}
    name, _, limit = out[0].partition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def host_stamp() -> dict:
    """bench.py's `_host_stamp`: the box's identity (hostname and cpu
    count) and the seconds of a fixed numpy spin, a load indicator."""
    t0 = time.perf_counter()
    a = np.random.default_rng(0).random((256, 256))
    for _ in range(20):
        a = (a @ a) % 1.0
    return {
        "id": f"{platform.node() or 'unknown'}/{os.cpu_count()}cpu",
        "calib_s": round(time.perf_counter() - t0, 4),
    }


# ------------------------------------------------------------------- folds
# the port's copies of bench.py's report folds (`:594-1042`), key for key;
# each is zero-filled on the bring-up-failed path

def _merged(hosts, name: str) -> Histogram:
    agg = Histogram()
    for nh in hosts.values():
        m = getattr(nh, "metrics", None)
        if m is None:
            continue
        for h in m.histograms(name):
            agg.merge(h)
    return agg


def latency_report(hosts) -> dict:
    """Proposal commit/apply, fsync and read latency percentiles merged
    across hosts (bench.py `_latency_report`). The read keys are always
    present; `readindex_latency_p99_s` only when a read was sampled."""
    commit = _merged(hosts, "proposal_commit_latency_seconds")
    apply_ = _merged(hosts, "proposal_apply_latency_seconds")
    fsync = _merged(hosts, "fsync_latency_seconds")
    out = {
        "commit_latency_p50_s": round(commit.quantile(0.5), 6),
        "commit_latency_p99_s": round(commit.quantile(0.99), 6),
        "commit_latency_samples": commit.count,
        "apply_latency_p99_s": round(apply_.quantile(0.99), 6),
        "fsync_latency_p99_s": round(fsync.quantile(0.99), 6),
    }
    reads = _merged(hosts, "readindex_latency_seconds")
    out["read_latency_p50_s"] = round(reads.quantile(0.5), 6)
    out["read_latency_p99_s"] = round(reads.quantile(0.99), 6)
    out["read_latency_samples"] = reads.count
    if reads.count:
        out["readindex_latency_p99_s"] = round(reads.quantile(0.99), 6)
    return out


# stages of the host fan-out (bench.py `_FANOUT_STAGES`; "deliver" nests
# inside the send/apply/reads phases and is kept out of the wall sum)
_FANOUT_STAGES = ("place", "send_rep", "send_resp", "apply", "reads")


def _stage_totals(engine) -> Dict[str, float]:
    return {n: s["total_s"] for n, s in engine.profiler.summary().items()}


def _engine_profilers(hosts) -> dict:
    """Every distinct engine profiler across the hosts (a shared core hands
    every host the same one)."""
    profs = {}
    for nh in hosts.values():
        prof = getattr(getattr(nh, "engine", None), "profiler", None)
        if prof is not None:
            profs[id(prof)] = prof
    return profs


def host_stage_report(hosts) -> dict:
    """Seconds per engine stage over the engines' lives and the fan-out +
    pack share of their sum (bench.py `_host_stage_report`)."""
    raw: Dict[str, float] = {}
    for prof in _engine_profilers(hosts).values():
        for name, s in prof.summary().items():
            raw[name] = raw.get(name, 0.0) + s["total_s"]
    if not raw:
        return {}
    wall = sum(v for n, v in raw.items() if n != "deliver")
    out = {"host_stage_total_s": {n: round(v, 4) for n, v in raw.items()}}
    if wall > 0:
        fan = sum(raw.get(n, 0.0) for n in _FANOUT_STAGES) + raw.get("pack", 0.0)
        out["fanout_pack_share"] = round(fan / wall, 4)
    return out


def _attribution_report(hosts, sync_mark, compile_mark) -> dict:
    """`phase_breakdown` over every canonical phase (zero when it never
    ran) and the window's `device_syncs` and `compile_events` deltas
    (bench.py `_attribution_report`; the port's compile events are its
    kernel builds). Marks of None report zero deltas."""
    from .profile import (
        VECTOR_PHASES,
        compile_watch,
        diff_compiles,
        diff_sync,
        sync_audit,
    )

    phases = {p: 0.0 for p in VECTOR_PHASES}
    for prof in _engine_profilers(hosts).values():
        for name, s in prof.summary().items():
            phases[name] = round(phases.get(name, 0.0) + s["total_s"], 4)
    out = {"phase_breakdown": phases}
    if sync_mark is None:
        out["device_syncs"] = {"in_seam": 0, "out_of_seam": 0, "sites": {}}
    else:
        out["device_syncs"] = diff_sync(sync_mark, sync_audit().snapshot())
    if compile_mark is None:
        out["compile_events"] = {"total": 0, "total_s": 0.0, "per_function": {}}
    else:
        out["compile_events"] = diff_compiles(compile_mark, compile_watch().snapshot())
    return out


def _lane_report(hosts) -> dict:
    """Lane count, leader coverage and the commit gap (bench.py
    `_lane_report`, from the engines' numpy mirrors)."""
    lanes_total = lanes_with_leader = gap_max = 0
    gaps = []
    for nh in hosts.values():
        lane_stats = getattr(getattr(nh, "engine", None), "lane_stats", None)
        if lane_stats is None:
            continue
        for _cid, s in lane_stats().items():
            lanes_total += 1
            if s["leader_id"]:
                lanes_with_leader += 1
            gaps.append(s["commit_gap"])
            gap_max = max(gap_max, s["commit_gap"])
    gaps.sort()
    return {
        "lanes_total": lanes_total,
        "lanes_with_leader": lanes_with_leader,
        "lane_commit_gap_max": gap_max,
        "lane_commit_gap_p50": gaps[len(gaps) // 2] if gaps else 0,
    }


def _serving_report(hosts) -> dict:
    """Admit, shed and wake totals over every host's serving front, the
    urgent and bulk serving latency percentiles merged across hosts (and
    per tenant for bulk), and the placement planes' migration ledger with
    the migration-tagged install streams (bench.py `_serving_report`);
    zero wherever no front or plane was created."""
    from .serving import KLASS_BULK, KLASS_URGENT

    admitted = shed = wakes = 0
    lat = {KLASS_URGENT: Histogram(), KLASS_BULK: Histogram()}
    per_tenant: Dict[str, Histogram] = {}
    for nh in hosts.values():
        front = getattr(nh, "_serving", None)
        if front is not None:
            for c in front.admission.counters().values():
                admitted += sum(c["admitted"].values())
                shed += sum(c["shed"].values())
                wakes += c["wakes"]
        m = getattr(nh, "metrics", None)
        if m is None:
            continue
        for (tid, klass), h in m.histogram_items("serving_latency_seconds"):
            if klass in lat:
                lat[klass].merge(h)
            if klass == KLASS_BULK and h.count:
                per_tenant.setdefault(str(tid), Histogram()).merge(h)
    mig = {"started": 0, "completed": 0, "aborted": 0}
    mig_streams = 0
    for nh in hosts.values():
        plane = getattr(nh, "_placement", None)
        if plane is not None:
            c = plane.counters()
            for k in mig:
                mig[k] += c[f"migrations_{k}"]
        chunks = getattr(nh, "_chunks", None)
        if chunks is not None:
            mig_streams += chunks.stats().get("migration_streams", 0)
    return {
        "serving_admitted_total": admitted,
        "serving_shed_total": shed,
        "serving_wakes_total": wakes,
        "serving_urgent_p99_s": round(lat[KLASS_URGENT].quantile(0.99), 6),
        "serving_bulk_p50_s": round(lat[KLASS_BULK].quantile(0.5), 6),
        "serving_bulk_p99_s": round(lat[KLASS_BULK].quantile(0.99), 6),
        "serving_tenant_latency": {
            tid: {"p50_s": round(h.quantile(0.5), 6), "p99_s": round(h.quantile(0.99), 6)}
            for tid, h in sorted(per_tenant.items())
        },
        "migrations_started": mig["started"],
        "migrations_completed": mig["completed"],
        "migrations_aborted": mig["aborted"],
        "migration_streams": mig_streams,
    }


def _read_report(hosts, reads_done: int, dt: float, read_mode: str) -> dict:
    """The read path the run measured, reads per second and the engines'
    lease serve/fallback counts, distinct engines only (bench.py
    `_read_report`)."""
    seen = {}
    for nh in hosts.values():
        eng = getattr(nh, "engine", None)
        fn = getattr(eng, "lease_stats", None)
        if fn is not None:
            seen[id(getattr(eng, "core", eng))] = fn
    local = fallback = 0
    for fn in seen.values():
        d = fn()
        local += d["local"]
        fallback += d["fallback"]
    return {
        "read_mode": read_mode,
        "reads_per_sec": round(reads_done / dt, 1) if dt > 0 else 0.0,
        "lease_reads_local": local,
        "lease_reads_fallback": fallback,
    }


def _census_report(hosts) -> dict:
    """Device census and protocol-event counter totals over distinct
    engines (bench.py `_census_report`, over the port's CENSUS_KEYS and
    ops/state.CTR_NAMES): bytes sum, fill and waste take the worst."""
    from .ops.state import CTR_NAMES
    from .profile import CENSUS_KEYS, DeviceCensus

    seen = {}
    for nh in hosts.values():
        eng = getattr(nh, "engine", None)
        if getattr(eng, "device_census", None) is not None:
            seen[id(getattr(eng, "core", eng))] = eng
    empty = DeviceCensus.empty()
    out = {k: empty[k] for k in CENSUS_KEYS}
    counters = {name: 0 for name in CTR_NAMES}
    for eng in seen.values():
        c = eng.device_census()
        out["hbm_bytes_total"] += int(c["hbm_bytes_total"])
        out["hbm_log_bytes"] += int(c["hbm_log_bytes"])
        for k in ("log_fill_p50", "log_fill_p99", "hbm_waste_ratio"):
            out[k] = max(out[k], float(c[k]))
        for name, v in eng.counter_stats().items():
            if name in counters:
                counters[name] += int(v)
    out["counters"] = counters
    return out


def _history_report(sampler) -> dict:
    """The history sampler's stats as `history_*` keys (bench.py
    `_history_report`), zero-filled when no sampler ran."""
    from .profile import HistorySampler

    stats = sampler.stats() if sampler is not None else HistorySampler.empty_stats()
    return {f"history_{k}": v for k, v in stats.items()}


def _start_history(workdir: str, hosts):
    """A live HistorySampler over the hosts for the measured window
    (bench.py `_start_history`); telemetry never blocks the run."""
    from .profile import HistorySampler

    try:
        return HistorySampler(os.path.join(workdir, "history.ring"), lambda: hosts).start()
    except Exception:
        return None


def _mesh_report(hosts, shard_over_mesh: bool = False) -> dict:
    """Devices the engine sharded over (1: unsharded), the mesh shape and
    the padded lanes (bench.py `_mesh_report`): what the engine reports,
    beside what the run asked for."""
    n_dev = padded = 0
    if 1 in hosts:
        ss = hosts[1].engine.step_stats()
        n_dev = int(ss.get("mesh_devices", 0) or 0)
        padded = int(ss.get("padded_groups", 0) or 0)
    n_dev = n_dev or 1
    return {
        "shard_over_mesh": bool(shard_over_mesh),
        "n_devices": n_dev,
        "mesh_shape": [n_dev],
        "padded_groups": padded,
    }


def _empty_folds(hosts, read_mode: str, shard_over_mesh: bool = False) -> dict:
    """What bench.py's bring-up-failed record carries beside its error."""
    out = _mesh_report(hosts, shard_over_mesh)
    out.update(_attribution_report(hosts, None, None))
    out.update(_read_report(hosts, 0, 0.0, read_mode))
    out.update(_census_report(hosts))
    out.update(_history_report(None))
    return out


# -------------------------------------------------------------------- load

class _Load:
    """bench.py's per-group pipelined waves: every group keeps ONE async
    batch of `wave` proposals in flight and resubmits as soon as it
    completes, with `read_ratio` x wave ReadIndex reads riding each cycle;
    leaders are re-read every 0.5 s. With `churn`, every 0.5 s the next
    group round-robin takes a snapshot request and, alternately, adds a
    never-started observer as node replicas+1 or deletes it."""

    def __init__(self, hosts, leaders, snap_fn, wave: int, cmd: bytes,
                 read_ratio: int = 0, churn: bool = False, replicas: int = 3):
        self.hosts, self.leaders, self.snap_fn = hosts, leaders, snap_fn
        self.sessions = {
            c: hosts[lid].get_noop_session(c) for c, lid in leaders.items()
        }
        self.cmds = [cmd] * wave
        self.n_reads = read_ratio * wave
        self.churn, self.replicas = churn, replicas
        self.inflight: dict = {}
        self.read_inflight: Dict[int, list] = {c: [] for c in self.sessions}
        self.total = self.dropped = 0
        self.reads_done = self.reads_submitted = 0
        self.snapshots = self.membership = 0
        self.committed_groups: set = set()  # committed a wave in the window
        self._refresh = 0.0
        self._churn_next = 0.0
        self._rr = 0
        self._order = list(self.sessions)
        self._next = 0  # where the next pass over the groups starts

    def run(self, seconds: float) -> None:
        # the deadline is checked per group, not per pass (a pass over
        # 1024 groups with 72 reads each takes seconds), and the next call
        # resumes where this one stopped
        deadline = time.perf_counter() + seconds
        n = len(self._order)
        while time.perf_counter() < deadline:
            progressed = False
            for i in range(n):
                if time.perf_counter() >= deadline:
                    self._next = (self._next + i) % n
                    return
                c = self._order[(self._next + i) % n]
                sess = self.sessions[c]
                h = self.inflight.get(c)
                if h is not None:
                    if not h.finished:
                        continue
                    self.total += h.completed
                    self.dropped += h.dropped
                    if h.completed:
                        self.committed_groups.add(c)
                    if self.n_reads:
                        self.reads_done += self._completed(self.read_inflight[c])
                        self.read_inflight[c] = []
                nh = self.hosts[self.leaders[c]]
                self.inflight[c] = nh.propose_batch_async(sess, self.cmds,
                                                           CLIENT_TIMEOUT_S)
                if self.n_reads:
                    # PendingReadIndex batches these under shared contexts
                    rss = self.read_inflight[c]
                    for _ in range(self.n_reads):
                        rss.append(nh.read_index(c, CLIENT_TIMEOUT_S))
                    self.reads_submitted += self.n_reads
                progressed = True
            now = time.perf_counter()
            if self.churn and now >= self._churn_next:
                self._churn_next = now + 0.5
                self._churn_tick()
            if now >= self._refresh:
                self._refresh = now + 0.5
                for c, (lid, _t) in self.snap_fn().items():
                    if lid and c in self.sessions:
                        self.leaders[c] = lid
            if not progressed:
                time.sleep(0.002)

    def started(self) -> bool:
        """Every group has had a wave submitted."""
        return len(self.inflight) == len(self.sessions)

    def open_window(self) -> None:
        """Zero the counts at the window's start: waves and reads still in
        flight count when they complete inside it (the reads as submitted
        in it), reads already done before it do not."""
        self.total = self.dropped = 0
        self.reads_done = 0
        self.reads_done = -self.reads_completed()
        self.reads_submitted = sum(len(rss) for rss in self.read_inflight.values())
        self.snapshots = self.membership = 0
        self.committed_groups = set()

    @staticmethod
    def _completed(rss) -> int:
        return sum(1 for rs in rss if rs.result is not None and rs.result.completed)

    def reads_completed(self) -> int:
        """Reads completed so far, in-flight cycles included."""
        return self.reads_done + sum(
            self._completed(rss) for rss in self.read_inflight.values())

    def _churn_tick(self) -> None:
        # BASELINE config 5 (bench.py:500-525): a snapshot request and a
        # membership change that commits through the log; replication to
        # the absent observer exercises the unreachable paths under load
        rr = self._rr = self._rr % len(self.sessions) + 1
        nh = self.hosts[self.leaders[rr]]
        try:
            nh.request_snapshot(rr, timeout_s=30.0)
            self.snapshots += 1
        except Exception:
            pass
        try:
            if self.membership % 2 == 0:
                nh.request_add_observer(rr, self.replicas + 1, "bench:absent",
                                        timeout_s=5.0)
            else:
                nh.request_delete_node(rr, self.replicas + 1, timeout_s=5.0)
            self.membership += 1
        except Exception:
            pass

    def settle(self, timeout_s: float = 30.0) -> None:
        """Wait (at most `timeout_s`) for the waves and reads still in
        flight."""
        deadline = time.perf_counter() + timeout_s
        for h in self.inflight.values():
            h.wait(max(0.0, deadline - time.perf_counter()))
            self.total += h.completed
            self.dropped += h.dropped
        self.inflight = {}
        for rss in self.read_inflight.values():
            for rs in rss:
                rs.wait(max(0.0, deadline - time.perf_counter()))


class _FrontLoad:
    """bench.py's through_front load (`_front_measure`, BASELINE config 7)
    with `_Load`'s interface. Every host gets a serving front (bulk
    buckets far above capacity: the run measures what the stack admits,
    not a bucket ceiling), a session manager and a placement plane with no
    targets whose pacer runs throughout. Tenant t owns the groups
    c % tenants == t and holds one at-most-once session on its first
    group's leader host; its worker sends each of its groups in turn a
    wave of bulk proposals through the leader host's front and waits for
    the wave, and every 4th round proposes once through its session. The
    workers run on their own threads from construction until `settle`;
    `run` only follows the leaders."""

    def __init__(self, hosts, leaders, snap_fn, groups: int, wave: int, cmd: bytes,
                 tenants: int):
        from .serving import AdmissionConfig, SessionManager, TenantSpec

        self.leaders, self.snap_fn = leaders, snap_fn
        self.groups, self.wave, self.cmd, self.tenants = groups, wave, cmd, tenants
        admission = AdmissionConfig(default=TenantSpec(rate=2_000_000.0, burst=200_000.0))
        self.fronts = {nid: nh.serving_front(admission=admission) for nid, nh in hosts.items()}
        self.mgrs = {nid: SessionManager(f) for nid, f in self.fronts.items()}
        for nh in hosts.values():
            nh.placement_plane(targets=[]).start()
        own = {t: [c for c in range(1, groups + 1) if c % tenants == t] for t in range(tenants)}
        self.owned = {t: cs for t, cs in own.items() if cs}
        self.sess_cluster = {}
        for t, cs in self.owned.items():
            if self.mgrs[leaders[cs[0]]].register(t, cs[0], count=1, timeout_s=30.0):
                self.sess_cluster[t] = cs[0]
        self._mu = threading.Lock()
        self.session_errors = 0
        self.open_window()
        self.submitted: set = set()  # groups that have had a wave submitted
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._tenant_main, args=(t,),
                                          name=f"tenant-{t}", daemon=True)
                         for t in self.owned]
        for w in self._workers:
            w.start()

    def _tenant_main(self, t: int) -> None:
        rounds = 0
        while not self._stop.is_set():
            for c in self.owned[t]:
                if self._stop.is_set():
                    break
                front = self.fronts[self.leaders[c]]
                tickets, shed = [], 0
                for _ in range(self.wave):
                    try:
                        tickets.append(front.propose(t, c, self.cmd, 15.0))
                    except Exception:
                        shed += 1
                self.submitted.add(c)
                admitted = 0
                for tk in tickets:
                    # Ticket.wait re-raises the pump's sheds (engine busy,
                    # inbox overflow): counted, never fatal to the worker
                    try:
                        r = tk.wait()
                    except Exception:
                        shed += 1
                        continue
                    if r is not None and r.completed:
                        admitted += 1
                    else:
                        shed += 1
                with self._mu:
                    self.total += admitted
                    self.dropped += shed
                    if admitted:
                        self.committed_groups.add(c)
            rounds += 1
            if t in self.sess_cluster and rounds % 4 == 0:
                # the at-most-once lane: one session proposal through the
                # same pump, deadline-retried under the same series
                c = self.sess_cluster[t]
                try:
                    self.mgrs[self.leaders[c]].propose(t, c, self.cmd, 10.0)
                    with self._mu:
                        self.total += 1
                except Exception:
                    with self._mu:
                        self.session_errors += 1

    def started(self) -> bool:
        return len(self.submitted) == self.groups

    def run(self, seconds: float) -> None:
        deadline = time.perf_counter() + seconds
        while True:
            left = deadline - time.perf_counter()
            if left <= 0:
                return
            time.sleep(min(0.25, left))
            for c, (lid, _t) in self.snap_fn().items():
                if lid and c in self.leaders:
                    self.leaders[c] = lid

    def open_window(self) -> None:
        """Zero the counts: a wave counts in the window it completes in."""
        with self._mu:
            self.total = self.dropped = 0
            self.committed_groups: set = set()

    def reads_completed(self) -> int:
        return 0

    def session_report(self) -> dict:
        """bench.py's session keys; the managers' counts are the run's."""
        st = {"registered": 0, "proposals": 0, "safe_retries": 0}
        for m in self.mgrs.values():
            for k, v in m.stats().items():
                st[k] = st.get(k, 0) + v
        return {
            "workload": "through_front",
            "session_mode": "sessions",
            "placement_enabled": True,
            "tenants": self.tenants,
            "session_registered_total": st["registered"],
            "session_proposals_total": st["proposals"],
            "session_safe_retries_total": st["safe_retries"],
            "session_errors_total": self.session_errors,
        }

    def settle(self, timeout_s: float = 30.0) -> None:
        """Stop the workers; each finishes the wave it waits on (a
        ticket's deadline is 15 s, a session proposal's 10 s)."""
        self._stop.set()
        deadline = time.perf_counter() + timeout_s
        for w in self._workers:
            w.join(max(0.0, deadline - time.perf_counter()))


def _thread_cpu() -> Dict[str, float]:
    """CPU seconds so far of this process's live threads, summed by role
    (the thread name up to its first "-": vec is the engine loop, vtask
    its apply workers, nh the NodeHosts' tick threads, kv the WAL sync
    workers, MainThread the load); Linux /proc, {} elsewhere."""
    out: Dict[str, float] = {}
    try:
        tck = os.sysconf("SC_CLK_TCK")
    except (AttributeError, ValueError, OSError):
        return out
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        role = t.name.split("-")[0]
        out[role] = out.get(role, 0.0) + (int(fields[11]) + int(fields[12])) / tck
    return out


def _busy_share(load: _Load, seconds: float, steps, min_steps: int) -> Optional[dict]:
    """Device busy share over a torch.profiler window of at least `seconds`
    with the load running, extended (up to 10x) until the engine decoded
    `min_steps` more protocol steps (`steps()`), so a slow super-step
    falls inside it: the summed device time of every kernel and copy the
    process ran, over the window's wall time (None when the trace holds
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, s0 = time.perf_counter(), steps()
        load.run(seconds)
        while steps() - s0 < min_steps and time.perf_counter() - t0 < 10 * seconds:
            load.run(0.25)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window_steps = steps() - s0
    by_name: Dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        if t:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "window_s": round(wall, 4),
        "window_steps": window_steps,
        "device_busy_ms": round(busy, 4),
        "device_busy_share": busy / 1e3 / wall if busy else None,
        "device_ms_by_name": {k: round(v, 4) for k, v in top},
    }


def converged(hosts, groups: int, replicas: int, timeout_s: float = 30.0) -> dict:
    """Wait until every replica of every group that applied anything holds
    the same counter and KV; report how many groups agree."""
    deadline = time.monotonic() + timeout_s
    while True:
        by_group: Dict[int, list] = {}
        with BenchSM._mu:
            sms = list(BenchSM.replicas.values())
        for sm in sms:
            by_group.setdefault(sm.key[0], []).append(sm)
        bad = [
            c for c, lst in by_group.items()
            if len(lst) != replicas
            or len({(sm.n, tuple(sorted(sm.kv.items()))) for sm in lst}) != 1
        ]
        if not bad or time.monotonic() > deadline:
            return {
                "groups_applied": len(by_group),
                "groups_diverged": len(bad),
                "converged": not bad and len(by_group) == groups,
            }
        time.sleep(0.2)


def lincheck_run(hosts, leaders, snap_fn, groups: int = 8, clients: int = 3,
                 ops: int = 24, seed: int = 7) -> dict:
    """`clients` concurrent clients put and read keys of the first
    `groups` groups through the leaders' sync_propose/sync_read; the
    recorded history must be linearizable (lincheck.check_kv_history).
    sync_read takes the run's read path: with `Config.lease_read` on, a
    leader holding a live lease serves it locally."""
    from .requests import ErrTimeout

    rec = HistoryRecorder()
    errors = []

    def client(i: int) -> None:
        rng = random.Random(seed * 100 + i)
        for j in range(ops):
            c = rng.randrange(1, groups + 1)
            key = f"g{c}k{rng.randrange(2)}"
            lid = snap_fn().get(c, (0, 0))[0] or leaders[c]
            nh = hosts[lid]
            if rng.random() < 0.5:
                val = f"c{i}o{j}"
                op = rec.invoke(i, ("put", key, val))
                try:
                    nh.sync_propose(nh.get_noop_session(c),
                                    _KV + f"{key}={val}".encode(), timeout_s=10.0)
                    rec.complete(op, None)
                except ErrTimeout:
                    rec.unknown(op)
                except Exception as e:  # a definite refusal never applied
                    errors.append(repr(e))
                    rec.fail(op)
            else:
                op = rec.invoke(i, ("get", key))
                try:
                    rec.complete(op, nh.sync_read(c, key, timeout_s=10.0))
                except Exception as e:
                    errors.append(repr(e))
                    rec.fail(op)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hist = rec.history()
    return {
        "lincheck_ops": len(hist),
        "lincheck_errors": len(errors),
        "lincheck_ok": bool(hist) and check_kv_history(hist),
    }


# ------------------------------------------------------------------- a run

def bench_e2e(groups: int, duration_s: float, payload: int, workdir: str,
              wave: int = 128, inbox_depth: int = 4, entries_per_msg: int = 64,
              log_window: int = 256, replicas: int = 3, read_ratio: int = 0,
              read_mode: str = "readindex", drop_rate: float = 0.0,
              churn: bool = False, steps_per_sync: int = 1,
              through_front: bool = False, tenants: int = 0,
              device: str = "cuda", shard_over_mesh: bool = False,
              warmup_s: float = 2.0,
              election_wait_s: Optional[float] = None, profile_s: float = 1.0,
              window_extend_s: float = 15.0,
              lincheck_groups: int = 8, lincheck_clients: int = 3) -> dict:
    """Run one e2e configuration (bench.py `bench_e2e` with shared=True);
    see the module docstring for the report."""
    from .nodehost import NodeHost
    from .profile import compile_watch, sync_audit
    from .transport.loopback import _Registry, loopback_factory
    from .types import MessageType

    if device != "cpu":
        # build the kernels before any host starts: an nvcc build inside
        # the election window stalls every engine and churns elections
        from .ops.cuda import build_kernels

        build_kernels()
    reg = _Registry()
    members = {n: f"bench:{n}" for n in range(1, replicas + 1)}
    hosts: Dict[int, NodeHost] = {}
    BenchSM.replicas = {}
    load = None
    # wall seconds of each part of the run, teardown included
    walls: Dict[str, float] = {}
    lap = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - lap[0], 3)
        lap[0] = now

    try:
        # bench.py's timers: 10 ms ticks x 300 election RTT, 30-tick
        # heartbeats, so a submitter burst holding the GIL cannot depose
        # live leaders
        for nid, addr in members.items():
            hosts[nid] = NodeHost(NodeHostConfig(
                raft_address=addr,
                rtt_millisecond=10,
                nodehost_dir=os.path.join(workdir, f"nh{nid}"),
                raft_rpc_factory=lambda a: loopback_factory(a, reg),
                engine=EngineConfig(
                    kind="vector",
                    max_groups=replicas * groups,
                    max_peers=max(replicas, 4),
                    log_window=log_window,
                    inbox_depth=inbox_depth,
                    max_entries_per_msg=entries_per_msg,
                    steps_per_sync=steps_per_sync,
                    share_scope=f"e2e-k{steps_per_sync}-{id(reg)}",
                    profile_sample_ratio=1,
                    device=device,
                    shard_over_mesh=shard_over_mesh,
                ),
            ))
        for nid in members:
            hosts[nid].start_clusters([
                (dict(members), False, BenchSM,
                 Config(node_id=nid, cluster_id=c, election_rtt=300,
                        heartbeat_rtt=30, lease_read=(read_mode == "lease")))
                for c in range(1, groups + 1)
            ])
        mark("hosts")
        engine = hosts[1].engine
        snap_fn = engine.leader_snapshot
        if election_wait_s is None:
            # bench.py's bring-up budget, scaled with the fleet
            election_wait_s = max(180.0, 0.004 * groups * replicas)
        t0 = time.monotonic()
        leaders: Dict[int, int] = {}
        loop = engine.core._threads[0]
        while (len(leaders) < groups and time.monotonic() - t0 < election_wait_s
               and loop.is_alive()):
            for c, (lid, _t) in snap_fn().items():
                if lid:
                    leaders[c] = lid
            if len(leaders) < groups:
                time.sleep(0.05)
        bring_up_s = time.monotonic() - t0
        mark("elect")
        base = {"groups": groups, "replicas": replicas, "payload_bytes": payload,
                "wave": wave, "steps_per_sync": steps_per_sync, "device": device,
                "backend": "torch", "host": host_stamp(), "wall_s": walls,
                "groups_elected": len(leaders), "bring_up_s": round(bring_up_s, 2)}
        base.update(card_stamp() if device != "cpu" else {})
        if len(leaders) < groups:
            why = "" if loop.is_alive() else " (the engine's loop thread died)"
            base.update(error=f"{groups - len(leaders)} groups never elected{why}",
                        value=0.0, committed=0)
            base.update(_empty_folds(hosts, read_mode, shard_over_mesh))
            return base
        drops = [0]
        if drop_rate > 0:
            # bench.py:391-409: seeded drops of replication traffic over
            # the co-hosted path, installed after bring-up; rejects,
            # backoff and re-replication must recover the divergence
            rnd = random.Random(1234)
            rep_types = (MessageType.REPLICATE, MessageType.REPLICATE_RESP)

            def _drop(m, _rnd=rnd, _t=rep_types):
                if m.type in _t and _rnd.random() < drop_rate:
                    drops[0] += 1
                    return True
                return False

            engine.core.set_local_drop_hook(_drop)
        # the load runs through the warm-up, so the first steps' election
        # churn settles and the window opens on waves already in flight
        # (a first wave through thousands of lanes outlasts a short
        # window); the window counts what completes inside it
        #
        # through_front (config 7) sends the waves through each leader
        # host's serving front with sessions and placement live; bench.py's
        # through_front branch measures its window and returns, and the
        # port's harness gives it what every other config has: this
        # warm-up, the audited window run on until every group committed,
        # the busy share, the settle, the convergence check and the lincheck
        if through_front:
            load = _FrontLoad(hosts, leaders, snap_fn, groups, wave, b"x" * payload,
                              max(tenants, 1))
        else:
            load = _Load(hosts, leaders, snap_fn, wave, b"x" * payload,
                         read_ratio=read_ratio, churn=churn, replicas=replicas)
        load.run(warmup_s)
        while not load.started():
            load.run(0.1)  # every group has had a wave submitted
        load.open_window()
        mark("warm")
        sync_mark = sync_audit().install(device=device).snapshot()
        build_mark = compile_watch().install().snapshot()
        hist = _start_history(workdir, hosts)
        stats0 = engine.step_stats()
        stages0 = _stage_totals(engine.core)
        cpu0 = _thread_cpu()
        t1 = time.perf_counter()
        load.run(duration_s)
        # a wave takes several engine steps and at 5120 lanes a step takes
        # a second or more: the window runs on until every group committed
        # a wave inside it, at most window_extend_s
        stop = time.perf_counter() + window_extend_s
        while len(load.committed_groups) < groups and time.perf_counter() < stop:
            load.run(0.25)
        dt = time.perf_counter() - t1
        cpu1 = _thread_cpu()
        if hist is not None:
            hist.stop()
        total, reads_done = load.total, load.reads_completed()
        stats1 = engine.step_stats()
        steps = stats1["steps"] - stats0["steps"]
        mark("window")
        attribution = _attribution_report(hosts, sync_mark, build_mark)
        sync, builds = attribution["device_syncs"], attribution["compile_events"]
        out = dict(base)
        out.update(
            value=(total + reads_done) / dt,
            committed=total,
            client_dropped=load.dropped,
            seconds=round(dt, 2),
            fsync=True,
            shared_engine=True,
            engine_steps=steps,
            engine_steps_per_s=steps / dt,
            pipelined_steps=stats1["steps_pipelined"] - stats0["steps_pipelined"],
            # host Message objects built for co-hosted traffic by plane, and
            # the messages the K>1 super-step routed on the device instead
            msgs_in_window={k: stats1[k] - stats0[k] for k in (
                "msgs_replicate", "msgs_broadcast", "msgs_resp", "msgs_routed_device")},
            groups_committed_in_window=len(load.committed_groups),
            elections_in_window=(stats1["elections_started"]
                                 - stats0["elections_started"]),
            # CPU seconds per second of window by thread role: with the
            # interpreter lock, how much of it the engine loop had
            thread_cpu_share={r: round((c - cpu0.get(r, 0.0)) / dt, 4)
                              for r, c in sorted(cpu1.items())},
            out_of_seam_syncs=sync["out_of_seam"],
            out_of_seam_sites=sync["sites"],
            in_seam_syncs=sync["in_seam"],
            kernel_builds=builds["total"],
        )
        out.update(_mesh_report(hosts, shard_over_mesh))
        if read_ratio:
            out.update(reads_completed=reads_done,
                       reads_submitted=load.reads_submitted, read_ratio=read_ratio)
        if drop_rate:
            out.update(drop_rate=drop_rate, drops_applied=drops[0])
        if churn:
            out.update(snapshots_requested=load.snapshots,
                       membership_changes=load.membership)
        if through_front:
            out.update(load.session_report())
        # the measured window's own seconds per stage (the fold below sums
        # the engine's whole life, bring-up included)
        out["host_stage_window_s"] = {
            n: round(v - stages0.get(n, 0.0), 4)
            for n, v in _stage_totals(engine.core).items()}
        out.update(host_stage_report(hosts))
        out.update(attribution)
        out.update(latency_report(hosts))
        out.update(_lane_report(hosts))
        out.update(_serving_report(hosts))
        out.update(_read_report(hosts, reads_done, dt, read_mode))
        out.update(_census_report(hosts))
        if device != "cpu" and profile_s > 0:
            out["busy"] = _busy_share(load, profile_s,
                                      lambda: engine.step_stats()["steps"],
                                      2 * steps_per_sync)
            mark("profile")
        out.update(_history_report(hist))
        # the last waves land, and the entries of waves that timed out
        # drain (the replicas agree), before the lincheck clients start:
        # behind them, at about one engine step a second, their ops time
        # out; the replicas are compared again after the lincheck
        load.settle()
        converged(hosts, groups, replicas)
        mark("settle")
        if lincheck_groups:
            out.update(lincheck_run(hosts, leaders, snap_fn,
                                    groups=min(lincheck_groups, groups),
                                    clients=lincheck_clients))
            mark("lincheck")
        out.update(converged(hosts, groups, replicas))
        mark("converge")
        # protocol steps of the whole run (bring-up and lincheck included)
        out["engine_steps_total"] = engine.step_stats()["steps"]
        return out
    finally:
        lap[0] = time.perf_counter()
        if isinstance(load, _FrontLoad):
            load.settle(0.0)  # its workers end once the fronts stop
        for nh in hosts.values():
            try:
                nh.stop()
            except Exception:
                pass
        mark("stop")


def run_ladder_config(n: int, groups: Optional[int] = None,
                      duration: Optional[float] = None, device: str = "cuda",
                      shard_over_mesh: bool = False) -> dict:
    """One BASELINE config (bench.py `_run_ladder_config`): `groups`
    defaults to bench.py's own cut (`LADDER[n]["groups"]`), and the record
    is stamped with the nominal and actual group counts. Config 8 runs
    twice, ReadIndex reads first and then lease reads; the record is the
    lease run's, with the ReadIndex run's read numbers under
    `readindex_mode` and the reads/s ratio of the two."""
    spec = LADDER[n]
    groups = groups or spec["groups"]
    duration = duration or spec["duration"]

    def _run(read_mode: str) -> dict:
        workdir = tempfile.mkdtemp(prefix=f"dbtorch-e2e-c{n}-")
        try:
            return bench_e2e(
                groups, duration, spec["payload"], workdir, wave=spec["wave"],
                entries_per_msg=spec.get("entries_per_msg", 64),
                replicas=spec["replicas"],
                read_ratio=spec.get("read_ratio", 0), read_mode=read_mode,
                drop_rate=spec.get("drop_rate", 0.0),
                churn=spec.get("churn", False),
                steps_per_sync=spec.get("steps_per_sync", 1),
                through_front=spec.get("through_front", False),
                tenants=spec.get("tenants", 0),
                device=device,
                shard_over_mesh=shard_over_mesh,
            )
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    if spec.get("both_read_modes"):
        base = _run("readindex")
        r = _run("lease")
        r["readindex_mode"] = {k: base[k] for k in _READINDEX_MODE_KEYS if k in base}
        # the ReadIndex run's gates, so a caller can hold both runs
        r["readindex_run"] = {k: base.get(k) for k in _GATE_KEYS + ("engine_steps_total",)}
        rps, base_rps = r.get("reads_per_sec", 0), base.get("reads_per_sec")
        if base_rps:
            r["lease_vs_readindex_reads"] = round(rps / base_rps, 3)
    else:
        r = _run(spec.get("read_mode", "readindex"))
    r["label"] = spec["label"]
    r["nominal_groups"] = spec["nominal_groups"]
    r["actual_groups"] = groups
    r["scaled_down"] = groups != spec["nominal_groups"]
    r["entries_per_msg"] = spec.get("entries_per_msg", 64)
    r["config"] = n
    return r


# functions whose device reads are off the blessed seams by design, as in
# the reference: the rare membership-reconcile and snapshot-restore paths
# that config 5's churn drives
RARE_PATH_SYNCS = ("_reconcile_membership", "_reconcile_restore")

# what gate_failures reads of a run (config 8 keeps these of its
# ReadIndex run under `readindex_run`)
_GATE_KEYS = (
    "error", "groups_elected", "committed", "reads_completed",
    "lease_reads_local", "converged", "lincheck_ok", "lincheck_errors",
    "out_of_seam_syncs", "out_of_seam_sites", "kernel_builds",
    "session_registered_total", "session_proposals_total",
)


def gate_failures(r: dict) -> list:
    """Why a run_ladder_config record fails its gates (empty: it passes).
    Every run: every group elected, something committed, the replicas
    converged, the history linearizable, no kernel build in the window,
    and no device read off the blessed seams (at config 5, none outside
    RARE_PATH_SYNCS). Configs 3 and 8 completed reads; config 8 served
    reads off the lease in its lease run and none in its ReadIndex run;
    config 4's hook dropped messages; config 5 requested snapshots and
    membership changes; config 7 registered one session for every tenant
    that owns a group (every tenant from `tenants` groups up) and proposed
    through the sessions. Config 7's sheds are reported, not gated: the
    front sheds bulk traffic under a saturated WAL by design."""
    n = r["config"]
    spec = LADDER[n]
    runs = [("", r)]
    if spec.get("both_read_modes"):
        runs.append(("readindex run: ", r.get("readindex_run") or {}))
    bad = []
    for tag, x in runs:
        if x.get("error"):
            bad.append(tag + str(x["error"]))
            continue
        if x.get("groups_elected") != r["actual_groups"]:
            bad.append(f"{tag}{x.get('groups_elected')}/{r['actual_groups']} groups elected")
        if not x.get("committed", 0) > 0:
            bad.append(tag + "nothing committed")
        if not x.get("converged"):
            bad.append(tag + "the replicas did not converge")
        if not x.get("lincheck_ok") or x.get("lincheck_errors"):
            bad.append(tag + "the history is not linearizable")
        if x.get("kernel_builds") != 0:
            bad.append(tag + "a kernel was built inside the measured window")
        sites = x.get("out_of_seam_sites") or {}
        allowed = RARE_PATH_SYNCS if spec.get("churn") else ()
        off = {s: c for s, c in sites.items() if s.rsplit(":", 1)[-1] not in allowed}
        if off or (not allowed and x.get("out_of_seam_syncs")):
            bad.append(f"{tag}out-of-seam syncs {off or x.get('out_of_seam_syncs')}")
        if spec.get("read_ratio") and not x.get("reads_completed", 0) > 0:
            bad.append(tag + "no read completed")
    if spec.get("both_read_modes"):
        if not r.get("lease_reads_local", 0) > 0:
            bad.append("the lease run served no read off the lease")
        if (r.get("readindex_run") or {}).get("lease_reads_local") != 0:
            bad.append("the ReadIndex run served reads off a lease")
    if spec.get("drop_rate") and not r.get("drops_applied", 0) > 0:
        bad.append("the drop hook dropped nothing")
    if spec.get("churn") and not (r.get("snapshots_requested", 0) > 0
                                  and r.get("membership_changes", 0) > 0):
        bad.append("no snapshot or membership change was requested")
    if spec.get("through_front") and not r.get("error"):
        want = min(spec["tenants"], r["actual_groups"])
        if r.get("session_registered_total") != want:
            bad.append(f"{r.get('session_registered_total')}/{want} sessions registered")
        if not r.get("session_proposals_total", 0) > 0:
            bad.append("nothing was proposed through a session")
    return bad


def bench_record(records: Dict[int, dict]) -> dict:
    """bench.py's record shape around config records of this harness, so
    `tools.perfdiff` compares them: the configs keyed by number, and the
    host and backend stamps lifted to the record level, where perfdiff's
    stamp rules read them."""
    first = next(iter(records.values()))
    return {
        "metric": "e2e_proposals_per_sec",
        "backend": first.get("backend", "torch"),
        "host": first.get("host"),
        "configs": {str(n): r for n, r in sorted(records.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, choices=sorted(LADDER), default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups", type=int, default=None,
                    help="the group count (default: the config's nominal one)")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--shard-over-mesh", action="store_true",
                    help="shard each engine's lanes over engine.vector.mesh_devices() "
                         "(bench.py --shard-over-mesh)")
    args = ap.parse_args(argv)
    r = run_ladder_config(args.config,
                          groups=args.groups or LADDER[args.config]["nominal_groups"],
                          duration=args.duration, device=args.device,
                          shard_over_mesh=args.shard_over_mesh)
    r["gate_failures"] = gate_failures(r)
    print(json.dumps(r, default=str))
    return 1 if r["gate_failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
