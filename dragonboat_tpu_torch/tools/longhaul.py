"""Drummer-style long-haul chaos runner.

The reference dragonboat earns its confidence from the drummer/monkey
harness (docs/test.md): nodes are killed and restarted for hours against
a live workload and correctness is asserted continuously. This module is
that harness for the vectorized engine: a seed-rotating, wall-clock-
bounded runner that drives a 3-host replicated KV through the FULL
scenario mix —

    crash_restart   process-death (NodeHost.crash, optionally with a
                    torn WAL tail) or node-level crash_cluster, then a
                    seeded-delay restart/rejoin (log replay from the
                    leader, snapshot install when compacted past)
    partition       full traffic partition of one host, then heal
    drop            ~25% wire message drop window on one host
    fsync_stall     durability-barrier stall window on every WAL
    churn           membership churn: join a fresh node id on a 4th
                    host, later remove it (ids never reused)
    transfer        leadership transfer to a seeded member
    snapshot        user snapshot request on the leader, under load

— with verdicts after every round (linearizability of the recorded
client history, replica hash + applied-index convergence, logdb Log
Matching, and the tick-fairness watchdog's graceful-degradation check),
a per-round seed line so ANY round replays from the log, and a forensic
artifact bundle on failure: every live host's flight dump plus every
`*.ring`/`*.ring.prev` crash ring swept from the run directory, merged
into one timeline (tools.timeline), the round's telemetry history ring
(profile.HistorySampler — every host sampled at 250ms into a
crash-persistent ring next to the flight ring) and the raft-doctor
diagnosis over all three planes (tools.doctor) — no manual collection.
Failed rounds are triaged: deduped by (failed-verdicts, diagnosis)
signature, each NEW signature auto-replayed once at the same seed, and
tagged DETERMINISTIC (replay fails the same way — debug from the
bundle) or LOAD_SENSITIVE (replay diverged — suspect timing/box load)
in the run's triage.json ledger. Out dirs are single-use: a non-empty
--out is rotated to <out>.prev (stale h<N> dirs replay old WAL state
and fail lincheck spuriously); --reuse-out skips the guard.

Usage:

    python -m dragonboat_tpu_torch.tools.longhaul --budget 60 --seed-rotation
    python -m dragonboat_tpu_torch.tools.longhaul --budget 14400 --seed-rotation \
        --round-seconds 60 --engine vector      # the nightly profile
    CHAOS_SEED=0x2B5 python -m dragonboat_tpu_torch.tools.longhaul \
        --seed 0x2B5 --rounds 1                 # replay one failed round

Determinism: every fault decision of a round comes from ONE FaultPlane
seeded with the round seed, the scenario loop runs a FIXED op count
derived from --round-seconds (not a wall-clock cut-off), and every
orchestration draw happens unconditionally (before any runtime-state
probe), so a replay with the same seed executes the same op sequence
and the per-round signature — a digest of the orchestration streams
(scenario/victim/window/crash-schedule draws; per-message wire draws,
whose count follows traffic timing, are excluded) — matches
bit-identically.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from ..config import Config, EngineConfig, NodeHostConfig
from ..faults import ClockPlane, FaultPlane, FaultSpec
from ..lincheck import HistoryRecorder, check_kv_history
from ..nodehost import NodeHost
from ..profile import HISTORY_EVENT, HistorySampler
from ..requests import RequestError
from ..statemachine import IStateMachine, Result
from ..storage import ShardedLogDB
from ..storage.kv import WalKV
from ..trace import flight_recorder
from ..transport.loopback import _Registry, loopback_factory
from .doctor import diagnosis_report, load_history
from .timeline import merge_dumps, sweep_artifacts
from .top import collect_snapshot, rank_lanes

CLUSTER = 1
HOSTS = (1, 2, 3)
CHURN_HOST = 4  # hosts the churn scenario's joining nodes
KEYS = tuple(f"k{i}" for i in range(4))

# the signature printed per round digests ONLY these orchestration
# streams: scenario choices, victims, windows, and crash/restart
# schedules are drawn unconditionally, so same-seeded replays match
# bit-identically — while per-message wire draws and per-fsync stalls
# (whose count follows traffic timing) ride other sites and are excluded
_ORCH_SITES = ("longhaul", "crash")

SCENARIOS = (
    "crash_restart",
    "partition",
    "drop",
    "fsync_stall",
    "churn",
    "transfer",
    "snapshot",
    "overload",
    "observer_witness_churn",
    "prevote_rejoin_storm",
    "streamed_install_under_crash",
    "rebalance_under_load",
    "lease_clock_chaos",
    "none",
)

# the rebalance scenario runs its own throw-away group so a live
# migration (member swap) never perturbs the main cluster's 3-way
# convergence verdicts; the churn host serves as the migration target
MIG_CLUSTER = 9


class _HashKV(IStateMachine):
    """KV SM with a content hash (cf. internal/tests/kvtest.go)."""

    def __init__(self):
        self.d = {}

    def update(self, data):
        k, v = data.decode().split("=", 1)
        self.d[k] = v
        return Result(value=1)

    def lookup(self, q):
        return self.d.get(q)

    def get_hash(self):
        import zlib

        return zlib.crc32(json.dumps(sorted(self.d.items())).encode())

    def save_snapshot(self, w, files, done):
        w.write(json.dumps(self.d).encode())

    def recover_from_snapshot(self, r, files, done):
        self.d = json.loads(r.read().decode())


@dataclass
class RoundResult:
    round_no: int
    seed: int
    ok: bool = False
    ops: int = 0
    scenarios: Dict[str, int] = field(default_factory=dict)
    verdicts: Dict[str, bool] = field(default_factory=dict)
    signature: str = ""
    elapsed_s: float = 0.0
    error: str = ""
    bundle: str = ""
    replay: str = ""
    diagnosis: str = ""  # raft-doctor's top verdict kind (failed rounds)
    triage: str = ""  # DETERMINISTIC | LOAD_SENSITIVE (failed rounds)


@dataclass
class Options:
    budget_s: float = 60.0
    rounds_max: int = 0  # 0 = unbounded (budget-gated)
    round_s: float = 10.0
    engine: str = "vector"
    out_dir: str = "longhaul-out"
    seed: Optional[int] = None
    rotate: bool = False
    ring: bool = False  # attach a per-round crash-persistent mmap ring
    inject_failure: bool = False  # force a failing verdict (bundle drill)
    reuse_out: bool = False  # skip the fresh-out-dir rotation guard
    triage: bool = True  # dedupe + same-seed-replay failed rounds
    scenarios: tuple = SCENARIOS
    # vector-engine composition knobs: the smoke rotation soaks the
    # sharded K-step kernel (shard_over_mesh + steps_per_sync>1) under
    # the same chaos schedule as the host path — scalar engines ignore
    # both
    steps_per_sync: int = 1
    shard_over_mesh: bool = False
    # run `tools.check` (the full static-analysis gate, interprocedural
    # families included) before round 1 and refuse to start on findings:
    # hours of longhaul on a tree the sub-second gate already rejects is
    # the most expensive way to discover a lint failure
    preflight: bool = True
    # the vector engine's device: the card unless the caller names the
    # CPU (without a card the default raises; scalar engines ignore it)
    device: str = "cuda"
    # the hosts' tick: the soak's 5 ms; a run whose engine steps slowly
    # (the vector engine's plain CPU step beside other engines in one
    # process) raises it so a stalled loop does not read as a lost leader
    rtt_ms: int = 5


#: preflight verdict memo — one analyzer pass per process (the source
#: tree does not change under a running longhaul; repeated run_longhaul
#: calls in one process, e.g. the test suite, pay it once)
_PREFLIGHT_CACHE: Optional[dict] = None


def _preflight_check() -> dict:
    """The `python -m dragonboat_tpu_torch.tools.check` verdict as a report
    fragment: findings count + rule version, so a run report pins WHICH
    gate the tree passed (a longhaul that predates a rule family is not
    evidence against it)."""
    global _PREFLIGHT_CACHE
    if _PREFLIGHT_CACHE is None:
        from ..analysis import RULES_VERSION, build_analyzer, unsuppressed

        findings = build_analyzer().run()
        failing = unsuppressed(findings)
        _PREFLIGHT_CACHE = {
            "ok": not failing,
            "findings": len(failing),
            "suppressed": len(findings) - len(failing),
            "rule_version": RULES_VERSION,
            "first": [f.render() for f in failing[:20]],
        }
    return dict(_PREFLIGHT_CACHE)


def _prepare_out_dir(out_dir: str, reuse: bool = False) -> bool:
    """Longhaul out dirs are single-use: reusing a populated run dir
    makes restarted hosts replay STALE WAL state from its h<N> dirs and
    fail lincheck spuriously (a flake that looks exactly like a real
    consistency bug). Unless ``reuse`` is set, a non-empty out dir is
    rotated aside to ``<out>.prev`` (replacing any older .prev) so every
    run starts fresh; returns True when a rotation happened."""
    if not reuse and os.path.isdir(out_dir) and os.listdir(out_dir):
        prev = out_dir.rstrip(os.sep) + ".prev"
        if os.path.isdir(prev):
            shutil.rmtree(prev, ignore_errors=True)
        elif os.path.exists(prev):
            os.remove(prev)
        os.replace(out_dir, prev)
        os.makedirs(out_dir, exist_ok=True)
        return True
    os.makedirs(out_dir, exist_ok=True)
    return False


def _round_seed(master: int, round_no: int, rotate: bool) -> int:
    if not rotate:
        return master
    digest = hashlib.sha256(f"{master}:{round_no}".encode()).digest()
    return int.from_bytes(digest[:6], "big")


def _mk_host(
    nid: int,
    reg: _Registry,
    run_dir: str,
    opts: Options,
    fp: FaultPlane,
    cp: Optional[ClockPlane] = None,
) -> NodeHost:
    """One loopback NodeHost on a durable dir (h<nid> under the round
    dir) with its shard WALs wrapped for seeded fsync-fault injection
    and its tick worker mounted on the round's injectable clock plane
    (clock state is keyed by host id, so a restarted process inherits
    the machine's — possibly still faulted — clock)."""

    def logdb_factory(d, _nid=nid):
        return ShardedLogDB(
            os.path.join(d, "logdb"),
            kv_factory=fp.kv_factory(f"fsync:h{_nid}", WalKV),
        )

    cfg = NodeHostConfig(
        deployment_id=7,
        rtt_millisecond=opts.rtt_ms,
        nodehost_dir=os.path.join(run_dir, f"h{nid}"),
        raft_address=f"c{nid}:1",
        raft_rpc_factory=lambda listen, reg=reg: loopback_factory(listen, reg),
        logdb_factory=logdb_factory,
        # the canonical vector shape every in-tree test uses, so the
        # longhaul smoke shares the suite's compiled kernel (max_peers=4
        # covers the 3 members + one churn joiner — churn and
        # observer/witness churn share the one-joiner-at-a-time rule)
        engine=EngineConfig(
            kind=opts.engine, max_groups=32, max_peers=4, log_window=64,
            steps_per_sync=opts.steps_per_sync,
            shard_over_mesh=opts.shard_over_mesh,
            device=opts.device,
        ),
    )
    nh = NodeHost(cfg)
    if cp is not None:
        nh.set_tick_clock(cp.clock_fn(nid))
    if nid in HOSTS:
        members = {h: f"c{h}:1" for h in HOSTS}
        nh.start_cluster(
            members,
            False,
            lambda c, n: _HashKV(),
            _member_config(nid),
        )
    return nh


def _member_config(nid: int, **overrides) -> Config:
    """The longhaul group config. pre_vote + check_quorum are ON for the
    whole soak (the canonical pairing): every crash/restart/partition
    round exercises the poll phase, the leader lease refuses polls from
    inside a live quorum, and the prevote_rejoin_storm verdict requires
    both — without the lease a load-delayed heartbeat lets an up-to-date
    member legally win a poll and read as a 'disturbance'."""
    kw = dict(
        cluster_id=CLUSTER,
        node_id=nid,
        election_rtt=20,
        heartbeat_rtt=4,
        # small thresholds so snapshot-under-load AND the
        # compacted-past-rejoiner install path both fire inside a short
        # round
        snapshot_entries=60,
        compaction_overhead=10,
        pre_vote=True,
        check_quorum=True,
        # leader leases ON for the whole soak: every read in the client
        # mix rides the lease fast path when live and MUST silently
        # degrade to ReadIndex under the clock-chaos scenario — the
        # lincheck verdict judges both paths in one history
        lease_read=True,
    )
    kw.update(overrides)
    if kw.get("is_observer") or kw.get("is_witness"):
        kw["lease_read"] = False  # lane variants can never serve leases
    return Config(**kw)


def _find_leader(hosts, deadline_s=10.0, cluster=CLUSTER):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for nid in HOSTS:
            nh = hosts.get(nid)
            if nh is None:
                continue
            try:
                lid, ok = nh.get_leader_id(cluster)
            except Exception:
                continue
            if ok and lid == nid and not nh.is_partitioned():
                return nid
        time.sleep(0.02)
    return None


def _client_main(hosts, rec, stop, seed, client_id, seq, seq_mu):
    import random

    crng = random.Random(seed + client_id)
    while not stop.is_set():
        leader = _find_leader(hosts, deadline_s=3.0)
        if leader is None:
            continue
        nh = hosts.get(leader)
        if nh is None:
            continue
        key = crng.choice(KEYS)
        if crng.random() < 0.7:
            with seq_mu:
                seq[0] += 1
                val = f"v{seq[0]}"
            op_id = rec.invoke(client_id, ("put", key, val))
            try:
                s = nh.get_noop_session(CLUSTER)
                nh.sync_propose(s, f"{key}={val}".encode(), timeout_s=2.0)
                rec.complete(op_id, None)
            except Exception:
                rec.unknown(op_id)  # indeterminate: may or may not apply
        else:
            op_id = rec.invoke(client_id, ("get", key))
            try:
                v = nh.sync_read(CLUSTER, key, timeout_s=2.0)
                rec.complete(op_id, v)
            except Exception:
                rec.fail(op_id)  # reads have no side effect
        time.sleep(crng.random() * 0.01)


class _Round:
    """One seeded round: 3 hosts + churn host, client traffic, a fixed
    count of seeded scenario ops, then settle + verdicts + artifacts."""

    def __init__(
        self, round_no: int, seed: int, opts: Options, dir_suffix: str = ""
    ) -> None:
        self.no = round_no
        self.seed = seed
        self.opts = opts
        # dir_suffix keeps triage replays out of the original round dir:
        # restarting hosts over a populated h<N> dir replays stale WAL
        # state and fails lincheck spuriously
        self.dir = os.path.join(
            opts.out_dir, f"round-{round_no:03d}-seed-0x{seed:X}{dir_suffix}"
        )
        os.makedirs(self.dir, exist_ok=True)
        self.fp = FaultPlane(
            seed, FaultSpec(drop=0.25, tear_tail=0.5)
        )
        # clock faults ride the SAME plane (seed + schedule signature);
        # every host's tick worker mounts this plane's per-host clock
        self.cp = ClockPlane(self.fp)
        self.reg = _Registry()
        self.hosts: Dict[int, Optional[NodeHost]] = {}
        self.result = RoundResult(round_no=round_no, seed=seed)
        self.churn_ids: List[int] = []  # joined-and-not-yet-removed ids
        # observer/witness churn: (node_id, kind) joined-and-not-removed;
        # shares the one-joiner-at-a-time rule (max_peers bound) with the
        # full-member churn scenario
        self.ow_ids: List[tuple] = []
        self._next_churn_id = CHURN_HOST
        self._crash_gen = None
        # overload-scenario ledger folded into the round verdicts: across
        # every burst this round, urgent ops must never be POLICY-shed,
        # every bulk shed must carry a retry-after hint, and admitted
        # urgent ops must complete within the capacity-aware budget
        # (serving/storm.py — anchored to the round's on-box baseline)
        self._storm = {
            "bursts": 0, "urgent_shed": 0, "urgent_stalled": 0,
            "hints_ok": True,
        }
        # observer/witness-churn ledger: joins attempted + the witness
        # zero-payload probe (lane_stats)
        self._ow = {"joins": 0, "witness_joins": 0, "witness_payload_ok": True}
        # pre-vote rejoin-storm ledger: a storm is one seeded
        # crash/restart or partition/heal of a NON-leader against the
        # stable quorum; any leader change or stable-quorum term bump
        # observed across it counts as a disturbance
        self._pv = {"storms": 0, "disturbed": 0}
        # rebalance-under-load ledger: one live migration of
        # a hot throw-away group per round — the recorded client history
        # must stay linearizable ACROSS the member swap and no urgent-
        # class op may be policy-shed while migration traffic (bulk
        # class) is in flight
        self._mig = {
            "runs": 0, "completed": 0, "aborted": 0,
            "lincheck_ok": True, "urgent_shed": 0,
        }
        # lease/clock-chaos ledger: windows = clock faults applied,
        # big_faults = faults past the tick worker's divergence limit
        # applied to the live leader (those MUST surface as ReadIndex
        # fallbacks, never as stale reads), burst_reads = lease-path
        # reads recorded into the round history during fault windows,
        # local/fallback = engine lease-counter deltas across the bursts
        self._lease = {
            "windows": 0, "big_faults": 0, "burst_reads": 0,
            "local": 0, "fallback": 0,
        }
        self._clock_gen = None
        self._rec: Optional[HistoryRecorder] = None
        self._hist: Optional[HistorySampler] = None

    # ------------------------------------------------------------ lifecycle
    def run(self) -> RoundResult:
        t0 = time.monotonic()
        res = self.result
        if self.opts.ring:
            try:
                flight_recorder().attach_mmap(
                    os.path.join(self.dir, "flight.ring")
                )
            except Exception:
                pass  # forensics must never block the run
        try:
            # the round's telemetry history: a background sampler over
            # whichever hosts are alive at each tick (the dict mutates
            # during crash/restart rounds, hence the callable), into a
            # crash-persistent ring next to the flight ring
            self._hist = HistorySampler(
                os.path.join(self.dir, "history.ring"),
                lambda: {
                    n: h for n, h in self.hosts.items() if h is not None
                },
            ).start()
        except Exception:
            self._hist = None  # forensics must never block the run
        rec = HistoryRecorder()
        self._rec = rec  # lease burst reads record into the SAME history
        stop = threading.Event()
        try:
            for nid in HOSTS + (CHURN_HOST,):
                self.hosts[nid] = _mk_host(
                    nid, self.reg, self.dir, self.opts, self.fp, self.cp
                )
            # warmup barrier: bring-up (incl. the cold kernel compile on
            # the vector step loop) is not part of the measured fault
            # phase — wait for a leader, then zero the fairness windows
            # so the graceful-degradation verdict sees only the chaos
            _find_leader(self.hosts, deadline_s=30.0)
            for nh in self.hosts.values():
                wd = getattr(nh.engine, "watchdog", None)
                if wd is not None:
                    wd.reset_window()
            seq, seq_mu = [0], threading.Lock()
            clients = [
                threading.Thread(
                    target=_client_main,
                    args=(self.hosts, rec, stop, self.seed, i, seq, seq_mu),
                    daemon=True,
                )
                for i in range(3)
            ]
            for t in clients:
                t.start()
            self._scenario_loop()
            stop.set()
            for t in clients:
                t.join(timeout=5)
            self._settle()
            self._verify(rec)
        except Exception as e:
            stop.set()
            res.error = f"{type(e).__name__}: {e}"
            res.verdicts["no_exception"] = False
        finally:
            res.signature = self.fp.schedule_signature(
                sites=_ORCH_SITES
            )[:16]
            if self.opts.inject_failure:
                res.verdicts["injected_failure"] = False
            res.ok = bool(res.verdicts) and all(res.verdicts.values())
            res.ops = len(rec.history())
            if self._hist is not None:
                try:
                    # seal the ring (with one final sample) BEFORE the
                    # bundle sweep and before any host surface closes
                    self._hist.stop(final_sample=True)
                except Exception:
                    pass
            if not res.ok:
                try:
                    self._bundle_failure()
                except Exception as e:  # bundling must not mask the verdict
                    res.bundle = f"(bundle failed: {e})"
            for nh in self.hosts.values():
                if nh is not None:
                    try:
                        nh.stop()
                    except Exception:
                        pass
            res.elapsed_s = time.monotonic() - t0
        return res

    # -------------------------------------------------------- scenario ops
    def _scenario_loop(self) -> None:
        # FIXED op count (not a wall-clock cut-off): a same-seeded replay
        # executes the same op sequence, so the schedule signature matches
        fp = self.fp
        n_ops = max(3, int(self.opts.round_s / 1.2))
        for _ in range(n_ops):
            sc = fp.choice("longhaul", "scenario", list(self.opts.scenarios))
            self.result.scenarios[sc] = self.result.scenarios.get(sc, 0) + 1
            try:
                getattr(self, f"_op_{sc}")()
            except RequestError:
                pass  # no leader / timeout during faults: part of the game
            except Exception as e:
                # orchestration must survive any single op (a failure
                # here surfaces in the verdicts, not as a runner crash)
                flight_recorder().record(
                    "longhaul_op_error", op=sc, err=f"{type(e).__name__}: {e}",
                )

    def _op_none(self) -> None:
        time.sleep(0.3)

    def _op_crash_restart(self) -> None:
        if self._crash_gen is None:
            self._crash_gen = self.fp.crash_restart_schedule(
                "crash", list(HOSTS), total_s=1e9,
                min_down_s=0.15, max_down_s=0.6,
            )
        victim, down, idle, tear = next(self._crash_gen)
        kind = self.fp.choice("crash", "kind", ["host", "node"])
        nh = self.hosts.get(victim)
        if nh is None:
            return
        if kind == "node":
            # node-level: the host survives, one raft node dies and rejoins
            try:
                nh.crash_cluster(CLUSTER)
            except RequestError:
                return
            time.sleep(down)
            nh2 = self.hosts.get(victim)
            if nh2 is not None:
                nh2.restart_cluster(CLUSTER)
        else:
            # host-level: SIGKILL-equivalent process death, optional torn
            # WAL tail, restart from the durable dir
            ldir = nh.logdb_dir()
            self.hosts[victim] = None
            nh.crash()
            if tear:
                self.fp.tear_wal_tails(ldir, f"tear:h{victim}")
            time.sleep(down)
            self.hosts[victim] = _mk_host(
                victim, self.reg, self.dir, self.opts, self.fp, self.cp
            )
        time.sleep(idle)

    def _op_partition(self) -> None:
        fp = self.fp
        victim = fp.choice("longhaul", "victim", list(HOSTS))
        nh = self.hosts.get(victim)
        if nh is None:
            return
        nh.set_partitioned(True)
        time.sleep(fp.uniform("longhaul", "window", 0.3, 0.8))
        nh2 = self.hosts.get(victim)
        if nh2 is not None:
            nh2.set_partitioned(False)

    def _op_drop(self) -> None:
        fp = self.fp
        victim = fp.choice("longhaul", "victim", list(HOSTS))
        nh = self.hosts.get(victim)
        if nh is None:
            return
        fp.install(nh, f"h{victim}")
        time.sleep(fp.uniform("longhaul", "window", 0.3, 0.8))
        nh2 = self.hosts.get(victim)
        if nh2 is not None:
            fp.uninstall(nh2)

    def _op_fsync_stall(self) -> None:
        fp = self.fp
        base = fp.spec
        fp.set_spec(replace(base, fsync_stall=0.25))
        try:
            time.sleep(fp.uniform("longhaul", "window", 0.3, 0.8))
        finally:
            fp.set_spec(base)

    def _op_transfer(self) -> None:
        # draw BEFORE probing runtime state: every op consumes the same
        # stream prefix on a same-seeded replay even when the op is then
        # skipped, so the schedule signature matches bit-identically
        target = self.fp.choice("longhaul", "transfer_to", list(HOSTS))
        leader = _find_leader(self.hosts, deadline_s=3.0)
        if leader is None:
            return
        nh = self.hosts.get(leader)
        if nh is not None and target != leader:
            nh.request_leader_transfer(CLUSTER, target)
            time.sleep(0.2)

    def _op_snapshot(self) -> None:
        leader = _find_leader(self.hosts, deadline_s=3.0)
        if leader is None:
            return
        nh = self.hosts.get(leader)
        if nh is not None:
            nh.request_snapshot(CLUSTER, timeout_s=5.0)
            time.sleep(0.1)

    def _op_overload(self) -> None:
        """Seeded overload burst through a throw-away serving front on
        the leader host (serving/storm.py storm_burst): offered bulk at
        the seeded multiple of admitted capacity plus interleaved urgent
        reads. Bulk must shed fast with retry hints; urgent must never
        shed — folded into the round verdicts (overload_*)."""
        from ..serving.storm import storm_burst

        leader = _find_leader(self.hosts, deadline_s=3.0)
        if leader is None:
            return  # no steerable group mid-fault: nothing to overload
        nh = self.hosts.get(leader)
        if nh is None:
            return
        out = storm_burst(
            nh, CLUSTER, self.fp,
            burst_s=0.25, capacity_rate=400.0, timeout_s=4.0,
        )
        st = self._storm
        st["bursts"] += 1
        st["urgent_shed"] += out["urgent_shed"]
        st["urgent_stalled"] += out["urgent_stalled"]
        st["hints_ok"] = st["hints_ok"] and out["retry_hints_ok"]

    def _op_churn(self) -> None:
        """Membership churn: join a FRESH node id on the churn host, or
        remove the oldest joined one (removed ids are never reused —
        the reference forbids a removed node rejoining)."""
        # draw BEFORE probing runtime state (replay determinism, see
        # _op_transfer)
        rm = self.fp.decide("longhaul", "churn_rm", 0.5)
        leader = _find_leader(self.hosts, deadline_s=3.0)
        churn_nh = self.hosts.get(CHURN_HOST)
        if leader is None or churn_nh is None:
            return
        lnh = self.hosts.get(leader)
        if lnh is None:
            return
        if self.churn_ids and rm:
            # pop only AFTER the delete commits: a timed-out delete must
            # keep the member tracked, or _settle never sheds it and the
            # next join strands a committed member that never runs
            nid = self.churn_ids[0]
            lnh.sync_request_delete_node(CLUSTER, nid, timeout_s=5.0)
            self.churn_ids.pop(0)
            try:
                churn_nh.stop_cluster(CLUSTER)
            except RequestError:
                pass
        elif not self.churn_ids and not self.ow_ids:
            # churn host serves one joiner at a time (either flavor)
            nid = self._next_churn_id
            self._next_churn_id += 1
            lnh.sync_request_add_node(
                CLUSTER, nid, f"c{CHURN_HOST}:1", timeout_s=5.0
            )
            # track the id the moment the membership change commits:
            # even if start_cluster below fails, _settle must still shed
            # the committed member
            self.churn_ids.append(nid)
            churn_nh.start_cluster(
                {}, True, lambda c, n: _HashKV(), _member_config(nid)
            )

    def _op_observer_witness_churn(self) -> None:
        """Membership churn over the LANE VARIANTS: join a fresh node id
        as an OBSERVER (replicates, never votes) or WITNESS (votes/acks,
        zero payload) on the churn host, later remove it. While a witness
        is joined, its lane_stats must report the WITNESS role and ZERO
        resident payload bytes — the vector-scale witness contract."""
        # draws BEFORE runtime probes (replay determinism, see _op_transfer)
        kind = self.fp.choice("longhaul", "ow_kind", ["observer", "witness"])
        rm = self.fp.decide("longhaul", "ow_rm", 0.4)
        leader = _find_leader(self.hosts, deadline_s=3.0)
        churn_nh = self.hosts.get(CHURN_HOST)
        if leader is None or churn_nh is None:
            return
        lnh = self.hosts.get(leader)
        if lnh is None:
            return
        if self.ow_ids and rm:
            nid, _kind = self.ow_ids[0]
            lnh.sync_request_delete_node(CLUSTER, nid, timeout_s=5.0)
            self.ow_ids.pop(0)
            try:
                churn_nh.stop_cluster(CLUSTER)
            except RequestError:
                pass
        elif not self.ow_ids and not self.churn_ids:
            nid = self._next_churn_id
            self._next_churn_id += 1
            if kind == "observer":
                lnh.sync_request_add_observer(
                    CLUSTER, nid, f"c{CHURN_HOST}:1", timeout_s=5.0
                )
            else:
                lnh.sync_request_add_witness(
                    CLUSTER, nid, f"c{CHURN_HOST}:1", timeout_s=5.0
                )
            self.ow_ids.append((nid, kind))
            self._ow["joins"] += 1
            # witnesses cannot take snapshots (Config validation)
            churn_nh.start_cluster(
                {}, True, lambda c, n: _HashKV(),
                _member_config(
                    nid,
                    is_observer=kind == "observer",
                    is_witness=kind == "witness",
                    snapshot_entries=0,
                    compaction_overhead=0,
                ),
            )
            if kind == "witness":
                self._ow["witness_joins"] += 1
                # let the witness take some replicated traffic, then probe
                time.sleep(0.5)
                stats = churn_nh.engine.lane_stats().get(CLUSTER)
                if stats is not None and stats["payload_bytes"] != 0:
                    self._ow["witness_payload_ok"] = False

    def _op_prevote_rejoin_storm(self) -> None:
        """The rejoin-storm verdict op: take a NON-leader member down
        (node crash/restart or partition/heal), long enough for its
        election timer to fire repeatedly, and measure the STABLE
        quorum across it. With pre_vote on (the soak config) the
        rejoiner's polls are rejected (its log lags live traffic) and
        its term never inflates — zero leader changes, zero term bumps
        on the stable pair."""
        # draws first (replay determinism)
        pick = self.fp.choice("longhaul", "pv_victim", list(HOSTS))
        mode = self.fp.choice("longhaul", "pv_mode", ["partition", "crash"])
        down = self.fp.uniform("longhaul", "pv_down", 0.4, 0.9)
        leader = _find_leader(self.hosts, deadline_s=3.0)
        if leader is None:
            return
        victim = pick if pick != leader else HOSTS[pick % len(HOSTS)]
        if victim == leader:
            return
        stable = [h for h in HOSTS if h != victim]
        before = self._quorum_terms(stable)
        if before is None:
            return
        nh = self.hosts.get(victim)
        if nh is None:
            return
        if mode == "partition":
            nh.set_partitioned(True)
            time.sleep(down)
            nh2 = self.hosts.get(victim)
            if nh2 is not None:
                nh2.set_partitioned(False)
        else:
            try:
                nh.crash_cluster(CLUSTER)
            except RequestError:
                return
            time.sleep(down)
            nh2 = self.hosts.get(victim)
            if nh2 is not None:
                nh2.restart_cluster(CLUSTER)
        # give the rejoiner a beat to land its first poll/heartbeat
        time.sleep(0.3)
        after = self._quorum_terms(stable)
        self._pv["storms"] += 1
        leader_after = _find_leader(self.hosts, deadline_s=3.0)
        if (
            after is None
            or after != before
            or leader_after != leader
        ):
            self._pv["disturbed"] += 1
            flight_recorder().record(
                "prevote_disturbance", victim=victim, mode=mode,
                before=str(before), after=str(after),
                leader_before=leader, leader_after=leader_after,
            )

    def _op_rebalance_under_load(self) -> None:
        """Hot-tenant skew on a throw-away group triggers a
        LIVE MIGRATION mid-round — the serving plane's placement brain
        moves the (score-forced) saturated leader-host replica onto the
        churn host over leadership transfer + the streamed snapshot
        install path, while skewed client load keeps flowing through
        the front. Verdicts: the recorded history stays linearizable
        across the swap (migration_lincheck) and zero urgent-class ops
        are policy-shed while the migration's bulk-class traffic is in
        flight (migration_no_urgent_shed). One migration per round (the
        throw-away group's bring-up bounds the cost)."""
        from ..serving import PlacementConfig, host_target
        from ..serving.placement import MigrationPlan

        # draws FIRST (replay determinism, see _op_transfer)
        fp = self.fp
        hot_tenant = fp.choice("longhaul", "mig_hot", [21, 22, 23])
        n_ops = int(fp.uniform("longhaul", "mig_ops", 36, 72))
        if self._mig["runs"]:
            return  # one live migration per round
        churn_nh = self.hosts.get(CHURN_HOST)
        if churn_nh is None or any(
            self.hosts.get(h) is None for h in HOSTS
        ):
            return  # a host is mid-crash: skip, the draws still burned
        self._mig["runs"] += 1
        members = {h: f"c{h}:1" for h in HOSTS}
        for h in HOSTS:
            self.hosts[h].start_cluster(
                members, False, lambda c, n: _HashKV(),
                _member_config(
                    h, cluster_id=MIG_CLUSTER,
                    snapshot_entries=24, compaction_overhead=6,
                ),
            )
        rec = HistoryRecorder()
        stop = threading.Event()
        try:
            leader = _find_leader(
                self.hosts, deadline_s=20.0, cluster=MIG_CLUSTER
            )
            if leader is None:
                self._mig["lincheck_ok"] = False
                return
            src_nh = self.hosts[leader]
            front = src_nh.serving_front()
            shed0 = self._urgent_sheds()

            def load_main():
                i = 0
                while not stop.is_set() and i < n_ops:
                    lid = _find_leader(
                        self.hosts, deadline_s=3.0, cluster=MIG_CLUSTER
                    )
                    tgt = self.hosts.get(lid) if lid else None
                    if tgt is None:
                        # post-swap the leader may live on the CHURN
                        # host (not in HOSTS): serve through it
                        try:
                            if churn_nh.has_node(MIG_CLUSTER):
                                tgt = churn_nh
                        except Exception:
                            tgt = None
                    if tgt is None:
                        time.sleep(0.05)
                        continue
                    f = tgt.serving_front()
                    i += 1
                    key = f"m{i % 3}"
                    if i % 4 == 0:
                        op = rec.invoke(hot_tenant, ("get", key))
                        try:
                            v = f.sync_read(
                                hot_tenant, MIG_CLUSTER, key, 2.0
                            )
                            rec.complete(op, v)
                        except Exception:
                            rec.fail(op)  # reads have no side effect
                    else:
                        val = f"w{i}"
                        op = rec.invoke(
                            hot_tenant, ("put", key, val)
                        )
                        try:
                            f.sync_propose(
                                hot_tenant, MIG_CLUSTER,
                                f"{key}={val}".encode(), 2.0,
                            )
                            rec.complete(op, None)
                        except Exception:
                            rec.unknown(op)
                    time.sleep(0.01)

            loader = threading.Thread(target=load_main, daemon=True)
            loader.start()
            # let the log pass the snapshot threshold so the joiner's
            # catch-up rides the streamed install path
            deadline = time.monotonic() + 15
            while (
                time.monotonic() < deadline
                and src_nh.get_applied_index(MIG_CLUSTER) < 30
            ):
                time.sleep(0.1)
            try:
                src_nh.sync_request_snapshot(MIG_CLUSTER, timeout_s=10.0)
            except RequestError:
                pass  # a periodic snapshot may already cover it
            # saturation forced ABOVE the rebalance trigger and BELOW
            # the hard bulk-shed line: migration's bulk class stays
            # admitted, urgent is untouched either way
            front.monitor.set_override(0.75)
            plane = src_nh.placement_plane(
                targets=[
                    host_target(
                        churn_nh, lambda c, n: _HashKV(),
                        lambda c, n: _member_config(
                            n, cluster_id=MIG_CLUSTER,
                            snapshot_entries=0, compaction_overhead=0,
                        ),
                    )
                ],
                config=PlacementConfig(
                    catchup_timeout_s=30.0, transfer_timeout_s=20.0,
                ),
            )
            plan = MigrationPlan(
                cluster_id=MIG_CLUSTER,
                local_node_id=leader,
                new_node_id=100 + self._mig["runs"],
                target=plane.targets[0],
                reason="rebalance_under_load",
            )
            try:
                plane.execute(plan)
                self._mig["completed"] += 1
            except RequestError:
                # a typed ErrMigrationAborted leaves the group serving
                # where it was — the verdicts below still judge the
                # history and the urgent ledger
                self._mig["aborted"] += 1
            finally:
                front.monitor.set_override(None)
            # stop BEFORE joining: a wedged group must not stall the
            # round, and the history snapshot below must not race the
            # loader's final completions
            stop.set()
            loader.join(timeout=30)
            self._mig["urgent_shed"] += max(
                self._urgent_sheds() - shed0, 0
            )
            ok = check_kv_history(rec.history(), max_states=2_000_000)
            self._mig["lincheck_ok"] = self._mig["lincheck_ok"] and ok
            flight_recorder().record(
                "rebalance_under_load_done", cluster=MIG_CLUSTER,
                completed=self._mig["completed"],
                aborted=self._mig["aborted"], lincheck=ok,
                ops=len(rec.history()),
            )
        finally:
            stop.set()
            for nh in list(self.hosts.values()) + [churn_nh]:
                if nh is None:
                    continue
                try:
                    if nh.has_node(MIG_CLUSTER):
                        nh.stop_cluster(MIG_CLUSTER)
                except Exception:
                    pass

    def _op_lease_clock_chaos(self) -> None:
        """Clock-fault window + lease-read burst: apply one seeded
        skew/drift/step-jump from the ClockPlane schedule to the LIVE
        LEADER's host clock, then drive a burst of linearizable reads
        (recorded into the round history) while the window is open. A
        fault past the tick worker's divergence limit trips the clock
        anomaly path — lease revoked + suspect hold — so every burst
        read MUST come back via the ReadIndex fallback (counted by
        lease_stats), never as a stale lease read; milder faults leave
        the lease serving locally. Both outcomes are judged by the one
        lincheck over the round history."""
        # draws FIRST (replay determinism, see _op_transfer)
        if self._clock_gen is None:
            self._clock_gen = self.cp.chaos_schedule(
                "longhaul", list(HOSTS), total_s=1e9,
            )
        drawn, kind, mag, window, idle = next(self._clock_gen)
        n_reads = int(self.fp.uniform("longhaul", "lease_reads", 8.0, 20.0))
        leader = _find_leader(self.hosts, deadline_s=3.0)
        victim = leader if leader is not None else drawn
        if self.hosts.get(victim) is None:
            return
        st = self._lease
        st["windows"] += 1
        # mirror of NodeHost._tick_worker_main's divergence limit
        # (rtt=5ms -> max(8*0.005, 0.05) = 0.05s), with headroom so a
        # draw just past the line never flakes the verdict; drift
        # divergence accumulates at |rate-1| per real second
        big = (
            kind in ("skew", "jump") and abs(mag) > 0.08
            or kind == "drift" and abs(mag - 1.0) * window > 0.08
        ) and leader is not None
        if big:
            st["big_faults"] += 1
        before = self._lease_counts()
        self.cp.apply(victim, kind, mag)
        rec = self._rec
        deadline = time.monotonic() + window
        done = 0
        while done < n_reads and time.monotonic() < deadline + 2.0:
            lid = _find_leader(self.hosts, deadline_s=2.0)
            lnh = self.hosts.get(lid) if lid is not None else None
            if lnh is None:
                continue
            key = KEYS[done % len(KEYS)]
            op = rec.invoke(70 + victim, ("get", key))
            try:
                val = lnh.sync_read(CLUSTER, key, timeout_s=2.0)
                rec.complete(op, val)
            except Exception:
                rec.fail(op)  # reads have no side effect
            done += 1
        st["burst_reads"] += done
        left = deadline - time.monotonic()
        if left > 0:
            time.sleep(left)
        self.cp.clear(victim)
        after = self._lease_counts()
        st["local"] += max(after[0] - before[0], 0)
        st["fallback"] += max(after[1] - before[1], 0)
        time.sleep(idle)

    def _lease_counts(self) -> tuple:
        """(local, fallback) lease-read totals across live hosts' engines
        (a crashed host's counters restart at zero; deltas clamp at 0)."""
        local = fb = 0
        for nh in self.hosts.values():
            if nh is None:
                continue
            stats = getattr(nh.engine, "lease_stats", None)
            if stats is None:
                continue
            try:
                d = stats()
            except Exception:
                continue
            local += d["local"]
            fb += d["fallback"]
        return local, fb

    def _urgent_sheds(self) -> int:
        """POLICY sheds of the urgent class across every live host's
        serving front (the migration verdict's no-starvation probe)."""
        total = 0
        for nh in self.hosts.values():
            if nh is None:
                continue
            front = getattr(nh, "_serving", None)
            if front is None:
                continue
            for c in front.admission.counters().values():
                total += c["shed"]["urgent"]
        return total

    def _quorum_terms(self, hosts_ids) -> Optional[dict]:
        out = {}
        for h in hosts_ids:
            nh = self.hosts.get(h)
            if nh is None:
                return None
            stats = nh.engine.lane_stats().get(CLUSTER)
            if stats is None:
                return None
            out[h] = stats["term"]
        return out

    def _op_streamed_install_under_crash(self) -> None:
        """Drive the chunked-install path under crash: a member node goes
        down, the leader snapshots + compacts past it (so rejoin NEEDS an
        install, not log replay), and — on the seeded half — the victim
        HOST is crashed while the stream is landing, restarted, and the
        re-streamed install resumes from the receiver's recorded offset
        (transport/chunks.py). Correctness rides the round verdicts
        (lincheck/convergence/fairness); the deterministic offset-resume
        assertion lives in tests/test_streamed_install.py."""
        pick = self.fp.choice("longhaul", "si_victim", list(HOSTS))
        crash_mid = self.fp.decide("longhaul", "si_crash", 0.5)
        mid_delay = self.fp.uniform("longhaul", "si_delay", 0.05, 0.25)
        leader = _find_leader(self.hosts, deadline_s=3.0)
        if leader is None:
            return
        victim = pick if pick != leader else HOSTS[pick % len(HOSTS)]
        if victim == leader:
            return
        vnh = self.hosts.get(victim)
        lnh = self.hosts.get(leader)
        if vnh is None or lnh is None:
            return
        try:
            vnh.crash_cluster(CLUSTER)
        except RequestError:
            return
        # let live client traffic run past the snapshot threshold, then
        # force a snapshot so compaction passes the victim's index
        time.sleep(0.4)
        try:
            lnh.sync_request_snapshot(CLUSTER, timeout_s=5.0)
        except RequestError:
            pass
        if crash_mid:
            # restart the node so the install stream starts, then kill
            # the whole receiving HOST mid-stream; the restarted host's
            # chunk tracker resumes from the recorded offset
            vnh.restart_cluster(CLUSTER)
            time.sleep(mid_delay)
            self.hosts[victim] = None
            vnh.crash()
            time.sleep(0.1)
            self.hosts[victim] = _mk_host(
                victim, self.reg, self.dir, self.opts, self.fp, self.cp
            )
        else:
            vnh.restart_cluster(CLUSTER)
        time.sleep(0.3)

    # ------------------------------------------------------------- verdicts
    def _settle(self) -> None:
        """Heal every fault, restart every down host/node, and shed the
        churn member so the 3-way convergence checks see a clean group."""
        self.fp.uninstall_all()
        for h in HOSTS + (CHURN_HOST,):
            self.cp.clear(h)  # continuous heal: rate 1.0, no jump
        for nid in HOSTS:
            if self.hosts.get(nid) is None:
                self.hosts[nid] = _mk_host(
                    nid, self.reg, self.dir, self.opts, self.fp, self.cp
                )
            nh = self.hosts[nid]
            nh.set_partitioned(False)
            nh.transport.set_pre_send_batch_hook(None)
            if not nh.has_node(CLUSTER):
                nh.restart_cluster(CLUSTER)
        # remove any still-joined churn member — full members AND
        # observer/witness joiners — (best effort with retries:
        # leadership can still be settling right after the fault phase)
        deadline = time.monotonic() + 30
        while (self.churn_ids or self.ow_ids) and time.monotonic() < deadline:
            leader = _find_leader(self.hosts, deadline_s=10.0)
            if leader is None:
                continue
            try:
                if self.churn_ids:
                    nid = self.churn_ids[0]
                else:
                    nid = self.ow_ids[0][0]
                try:
                    self.hosts[leader].sync_request_delete_node(
                        CLUSTER, nid, timeout_s=5.0
                    )
                except RequestError:
                    # a delete that timed out in the fault phase may have
                    # committed already: rejected/failed retries of an
                    # already-removed member count as shed
                    m = self.hosts[leader].get_cluster_membership(CLUSTER)
                    if (
                        nid in m.addresses
                        or nid in m.observers
                        or nid in m.witnesses
                    ):
                        raise
                if self.churn_ids:
                    self.churn_ids.pop(0)
                else:
                    self.ow_ids.pop(0)
                churn_nh = self.hosts.get(CHURN_HOST)
                if churn_nh is not None and churn_nh.has_node(CLUSTER):
                    churn_nh.stop_cluster(CLUSTER)
            except Exception:
                time.sleep(0.2)

    def _verify(self, rec: HistoryRecorder) -> None:
        v = self.result.verdicts
        hosts = self.hosts
        # one final write forces commit-index convergence
        deadline = time.monotonic() + 45
        final_ok = False
        while time.monotonic() < deadline and not final_ok:
            leader = _find_leader(hosts, deadline_s=20.0)
            if leader is None:
                break
            try:
                s = hosts[leader].get_noop_session(CLUSTER)
                hosts[leader].sync_propose(s, b"final=done", timeout_s=5.0)
                final_ok = True
            except Exception:
                time.sleep(0.2)
        v["recovered_leader"] = final_ok
        idx: Dict[int, int] = {}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                idx = {
                    nid: hosts[nid].get_applied_index(CLUSTER)
                    for nid in HOSTS
                }
            except Exception:
                time.sleep(0.1)
                continue
            if len(set(idx.values())) == 1:
                break
            time.sleep(0.05)
        v["applied_converged"] = len(set(idx.values())) == 1 and bool(idx)
        try:
            hashes = {hosts[n].get_sm_hash(CLUSTER) for n in HOSTS}
            v["hashes_converged"] = len(hashes) == 1
        except Exception:
            v["hashes_converged"] = False
        # persisted logs obey Log Matching below the common commit point
        try:
            from .logdbcheck import check_logdb_consistency

            report = check_logdb_consistency(
                {nid: hosts[nid].logdb for nid in HOSTS}, CLUSTER
            )
            v["logdb_consistent"] = report.ok
        except Exception:
            v["logdb_consistent"] = False
        history = rec.history()
        v["lincheck"] = check_kv_history(history, max_states=5_000_000)
        # graceful degradation (watchdog-asserted): no surviving host's
        # engine loop may have stalled while peers crashed or caught up
        worst_gap = 0.0
        for nid in HOSTS:
            stats = getattr(hosts[nid].engine, "fairness_stats", None)
            if stats is not None:
                worst_gap = max(worst_gap, stats()["recent_max_gap_s"])
        v["fairness_no_stall"] = worst_gap < 5.0
        # overload robustness (only when the scenario fired this round):
        # across every burst, zero urgent-class ops shed and every bulk
        # shed carried a machine-readable retry-after hint
        if self._storm["bursts"]:
            # POLICY sheds only (load-caused slow completions are judged
            # by the capacity-aware budget below — conflating the two made
            # the gate fail on load alone)
            v["overload_no_urgent_shed"] = self._storm["urgent_shed"] == 0
            v["overload_urgent_served"] = self._storm["urgent_stalled"] == 0
            v["overload_hints_ok"] = self._storm["hints_ok"]
        # observer/witness churn (only when the scenario joined anyone):
        # a joined witness must never hold payload bytes
        if self._ow["witness_joins"]:
            v["ow_witness_zero_payload"] = self._ow["witness_payload_ok"]
        # pre-vote rejoin storms: a NON-leader member's crash/partition
        # rejoin must not disturb the stable quorum (zero leader changes,
        # zero term bumps) — the pre-vote acceptance verdict
        if self._pv["storms"]:
            v["prevote_no_disturbance"] = self._pv["disturbed"] == 0
        # rebalance under load (only when the scenario fired): the
        # client history recorded ACROSS the live migration must stay
        # linearizable, and the migration's bulk-class traffic must
        # never have cost an urgent-class op a policy shed
        if self._mig["runs"]:
            v["migration_lincheck"] = self._mig["lincheck_ok"]
            v["migration_no_urgent_shed"] = self._mig["urgent_shed"] == 0
        # lease reads under clock chaos (only when the scenario fired):
        # the burst reads recorded during fault windows are part of the
        # one round history, so "linearizable" is the SAME lincheck —
        # the verdict additionally requires the bursts actually ran.
        # When a fault big enough to trip the tick worker's divergence
        # limit hit the live leader, the degradation contract must show:
        # reads kept serving through the ReadIndex fallback (never a
        # stale lease read, never an error surfaced to sync_read)
        if self._lease["windows"]:
            v["lease_reads_linearizable"] = (
                v["lincheck"] and self._lease["burst_reads"] > 0
            )
            if self._lease["big_faults"]:
                v["lease_fallback_served"] = self._lease["fallback"] > 0

    # ------------------------------------------------------------ artifacts
    def _bundle_failure(self) -> None:
        """Assemble the forensic bundle: live hosts' flight dumps + every
        ring/dump artifact swept from the round dir, merged into one
        timeline, plus a manifest with the one-line replay command."""
        bundle = os.path.join(self.dir, "failure_bundle")
        os.makedirs(bundle, exist_ok=True)
        # ONE process-level dump: this harness is in-process, so every
        # host shares the process-global recorder (a real multi-process
        # deployment drops one dump per host into the run dir instead —
        # the sweep merges either layout)
        for nh in self.hosts.values():
            if nh is not None:
                try:
                    nh.dump_flight(os.path.join(bundle, "flight_dump.jsonl"))
                except Exception:
                    continue
                break
        swept = sweep_artifacts(self.dir)
        merged = merge_dumps(swept)
        merged_path = os.path.join(bundle, "merged_timeline.jsonl")
        with open(merged_path, "w") as f:
            for e in merged:
                f.write(json.dumps(e, default=str, sort_keys=True) + "\n")
        # frozen lane-heat view + HBM census at failure time: the
        # raft-top snapshot the operator would have been watching, and
        # the device-memory picture of the very lanes that failed
        census_path = top_path = None
        live = {nid: nh for nid, nh in self.hosts.items() if nh is not None}
        if live:
            try:
                snap = collect_snapshot(live)
                top_path = os.path.join(bundle, "top_snapshot.json")
                with open(top_path, "w") as f:
                    json.dump(
                        {**snap, "lanes": rank_lanes(snap)},
                        f, indent=2, sort_keys=True,
                    )
                census_path = os.path.join(bundle, "device_census.json")
                with open(census_path, "w") as f:
                    json.dump(snap["census"], f, indent=2, sort_keys=True)
            except Exception:
                census_path = top_path = None  # hosts mid-teardown
        # telemetry history (the sampler sealed the ring before this
        # sweep ran) + the raft-doctor diagnosis over all three planes:
        # history ring, merged flight timeline, frozen top snapshot
        hist_path = diag_path = None
        hist_src = os.path.join(self.dir, "history.ring")
        if os.path.exists(hist_src):
            try:
                hist_path = os.path.join(bundle, "history.ring")
                shutil.copyfile(hist_src, hist_path)
            except OSError:
                hist_path = None
        try:
            history = load_history(hist_path) if hist_path else []
            top = None
            if top_path is not None:
                with open(top_path) as f:
                    top = json.load(f)
            diag = diagnosis_report(
                history,
                flight=[
                    e for e in merged if e.get("event") != HISTORY_EVENT
                ],
                top=top,
                source=os.path.basename(self.dir),
            )
            if diag["verdicts"]:
                self.result.diagnosis = diag["verdicts"][0]["kind"]
            diag_path = os.path.join(bundle, "diagnosis.json")
            with open(diag_path, "w") as f:
                json.dump(diag, f, indent=2, sort_keys=True)
        except Exception:
            diag_path = None  # diagnosis must never mask the verdict
        self.result.replay = self._replay_cmd()
        manifest = {
            "round": self.no,
            "seed": f"0x{self.seed:X}",
            "engine": self.opts.engine,
            "verdicts": self.result.verdicts,
            "error": self.result.error,
            "scenarios": self.result.scenarios,
            "schedule_signature": self.fp.schedule_signature(
                sites=_ORCH_SITES
            ),
            "swept_artifacts": swept,
            "merged_events": len(merged),
            "device_census": census_path,
            "top_snapshot": top_path,
            "history_ring": hist_path,
            "diagnosis": diag_path,
            "doctor_verdict": self.result.diagnosis,
            "replay": self.result.replay,
        }
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        self.result.bundle = bundle

    def _replay_cmd(self) -> str:
        cmd = (
            f"CHAOS_SEED=0x{self.seed:X} python -m "
            f"dragonboat_tpu_torch.tools.longhaul --seed 0x{self.seed:X} "
            f"--rounds 1 --round-seconds {self.opts.round_s:g} "
            f"--engine {self.opts.engine}"
        )
        # the engine composition is part of the repro: a sharded K-step
        # failure must replay on the sharded K-step engine
        if self.opts.steps_per_sync > 1:
            cmd += f" --steps-per-sync {self.opts.steps_per_sync}"
        if self.opts.shard_over_mesh:
            cmd += " --shard-over-mesh"
        if self.opts.device != "cuda":
            cmd += f" --device {self.opts.device}"
        if self.opts.rtt_ms != 5:
            cmd += f" --rtt-ms {self.opts.rtt_ms}"
        return cmd


# --------------------------------------------------------------- triage
def _triage_signature(res: RoundResult) -> str:
    """Dedupe key for the triage ledger: failed rounds that fail the
    SAME verdict set with the SAME doctor diagnosis are one flake
    signature, whatever seed produced them."""
    bad = ",".join(sorted(k for k, ok in res.verdicts.items() if not ok))
    return hashlib.sha256(f"{bad}|{res.diagnosis}".encode()).hexdigest()[:12]


def _triage_round(
    res: RoundResult, seed: int, opts: Options, ledger: Dict[str, dict]
) -> None:
    """Triage one failed round. The FIRST round showing a signature is
    replayed once at the same seed (in a fresh ``-triage`` dir — see
    _prepare_out_dir for why reuse is poison): a replay that fails the
    same verdicts tags the signature DETERMINISTIC (a seed replays it —
    debug from the bundle); anything else (green, or a different verdict
    set) tags it LOAD_SENSITIVE (timing-dependent — suspect box load or
    thresholds, not the seed). Later rounds with a known signature just
    join its ledger entry."""
    sig = _triage_signature(res)
    entry = ledger.get(sig)
    if entry is not None:
        entry["rounds"].append(res.round_no)
        res.triage = entry["tag"]
        return
    entry = ledger[sig] = {
        "signature": sig,
        "verdicts": sorted(k for k, ok in res.verdicts.items() if not ok),
        "diagnosis": res.diagnosis,
        "rounds": [res.round_no],
        "seed": f"0x{seed:X}",
        "tag": "",
    }
    print(
        f"[longhaul] triage: new signature {sig} "
        f"verdicts={entry['verdicts']} "
        f"diagnosis={res.diagnosis or '-'} — replaying seed=0x{seed:X}",
        flush=True,
    )
    rep = _Round(res.round_no, seed, opts, dir_suffix="-triage").run()
    rep_bad = sorted(k for k, ok in rep.verdicts.items() if not ok)
    deterministic = not rep.ok and rep_bad == entry["verdicts"]
    entry["tag"] = "DETERMINISTIC" if deterministic else "LOAD_SENSITIVE"
    res.triage = entry["tag"]
    print(f"[longhaul] triage: signature {sig} -> {entry['tag']}", flush=True)


def _write_triage(out_dir: str, master: int, ledger: Dict[str, dict]) -> str:
    path = os.path.join(out_dir, "triage.json")
    with open(path, "w") as f:
        json.dump(
            {
                "schema": 1,
                "master_seed": f"0x{master:X}",
                "entries": sorted(
                    ledger.values(), key=lambda e: e["signature"]
                ),
            },
            f, indent=2, sort_keys=True,
        )
    return path


def run_longhaul(opts: Options) -> dict:
    """Run rounds until the wall-clock budget (or --rounds cap) is spent;
    returns {rounds: [RoundResult...], ok, ...}. Each round prints one
    summary line; failures print the bundle path + replay command."""
    rotated = _prepare_out_dir(opts.out_dir, reuse=opts.reuse_out)
    master = (
        opts.seed
        if opts.seed is not None
        else int(os.environ.get("CHAOS_SEED", "0") or "0", 0)
        or int.from_bytes(os.urandom(6), "big")
    )
    t_end = time.monotonic() + opts.budget_s
    results: List[RoundResult] = []
    triage: Dict[str, dict] = {}
    round_no = 0
    print(
        f"[longhaul] budget={opts.budget_s:g}s master-seed=0x{master:X} "
        f"rotation={'on' if opts.rotate else 'off'} engine={opts.engine} "
        f"out={opts.out_dir}"
        + (" (rotated stale run to .prev)" if rotated else ""),
        flush=True,
    )
    check = {"ok": True, "skipped": True}
    if opts.preflight:
        check = _preflight_check()
        print(
            f"[longhaul] preflight tools.check: "
            f"findings={check['findings']} "
            f"(+{check['suppressed']} suppressed) "
            f"rules=v{check['rule_version']} -> "
            f"{'OK' if check['ok'] else 'FAIL'}",
            flush=True,
        )
        if not check["ok"]:
            for line in check["first"]:
                print(f"[longhaul]   {line}", flush=True)
            print(
                "[longhaul] refusing to start: fix (or suppress with a "
                "reason) the findings above, or pass --no-preflight",
                flush=True,
            )
            return {
                "ok": False,
                "master_seed": master,
                "rounds": [],
                "budget_s": opts.budget_s,
                "out_dir_rotated": rotated,
                "triage": [],
                "triage_path": "",
                "check": check,
            }
    while time.monotonic() < t_end:
        if opts.rounds_max and round_no >= opts.rounds_max:
            break
        round_no += 1
        seed = _round_seed(master, round_no, opts.rotate)
        res = _Round(round_no, seed, opts).run()
        results.append(res)
        sc = ",".join(f"{k}:{n}" for k, n in sorted(res.scenarios.items()))
        print(
            f"[longhaul] round {res.round_no} seed=0x{res.seed:X} "
            f"scenarios={sc or '-'} ops={res.ops} sig={res.signature} "
            f"verdict={'OK' if res.ok else 'FAIL'} {res.elapsed_s:.1f}s",
            flush=True,
        )
        if not res.ok:
            bad = sorted(k for k, val in res.verdicts.items() if not val)
            print(
                f"[longhaul] round {res.round_no} FAILED "
                f"verdicts={bad} error={res.error or '-'} "
                f"diagnosis={res.diagnosis or '-'} "
                f"bundle={res.bundle or '-'}",
                flush=True,
            )
            if res.replay:
                print(f"[longhaul] replay: {res.replay}", flush=True)
            if opts.triage:
                _triage_round(res, seed, opts, triage)
    ok = bool(results) and all(r.ok for r in results)
    triage_path = ""
    if opts.triage:
        triage_path = _write_triage(opts.out_dir, master, triage)
    print(
        f"[longhaul] done: {len(results)} round(s), "
        f"{sum(1 for r in results if not r.ok)} failure(s), "
        f"{len(triage)} triage signature(s)",
        flush=True,
    )
    return {
        "ok": ok,
        "master_seed": master,
        "rounds": results,
        "budget_s": opts.budget_s,
        "out_dir_rotated": rotated,
        "triage": sorted(triage.values(), key=lambda e: e["signature"]),
        "triage_path": triage_path,
        "check": check,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.longhaul",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--budget", type=float, default=60.0,
                    help="wall-clock budget in seconds (default 60; the "
                         "nightly profile passes hours)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="hard cap on rounds (0 = budget-gated)")
    ap.add_argument("--round-seconds", type=float, default=10.0,
                    help="scenario-phase length per round (drives the "
                         "fixed op count; settle/verify time is extra)")
    ap.add_argument("--seed", type=lambda v: int(v, 0), default=None,
                    help="master seed (hex ok; default CHAOS_SEED env or "
                         "random)")
    ap.add_argument("--seed-rotation", action="store_true",
                    help="derive a fresh seed per round from the master "
                         "(the long-haul mode); off = every round replays "
                         "the master seed")
    ap.add_argument("--engine", choices=("vector", "scalar"),
                    default="vector")
    ap.add_argument("--out", default="longhaul-out",
                    help="run directory (round dirs + failure bundles); "
                         "a non-empty one is rotated to <out>.prev — "
                         "reusing stale h<N> dirs replays old WAL state "
                         "and fails lincheck spuriously")
    ap.add_argument("--reuse-out", action="store_true",
                    help="dangerous: run in a non-empty --out dir as-is "
                         "(skips the .prev rotation guard)")
    ap.add_argument("--no-ring", action="store_true",
                    help="skip the per-round crash-persistent mmap ring")
    ap.add_argument("--no-triage", action="store_true",
                    help="skip the failure-triage ledger (signature "
                         "dedupe + one same-seed replay per signature "
                         "-> DETERMINISTIC/LOAD_SENSITIVE tags)")
    ap.add_argument("--inject-failure", action="store_true",
                    help="force a failing verdict each round (drills the "
                         "artifact bundle + replay-command path)")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="vector engine K-step super-steps (K protocol "
                         "steps per device sync; scalar ignores)")
    ap.add_argument("--shard-over-mesh", action="store_true",
                    help="shard the vector engine's lane axis over the "
                         "local device mesh (composes with "
                         "--steps-per-sync; scalar ignores)")
    ap.add_argument("--device", default="cuda",
                    help="the vector engine's device (default cuda; cpu "
                         "runs the plain PyTorch step)")
    ap.add_argument("--rtt-ms", type=int, default=5,
                    help="the hosts' tick in ms (default 5)")
    ap.add_argument("--no-preflight", action="store_true",
                    help="skip the tools.check static-analysis gate that "
                         "normally runs before round 1 (the run report "
                         "then records check.skipped)")
    args = ap.parse_args(argv)
    report = run_longhaul(
        Options(
            budget_s=args.budget,
            rounds_max=args.rounds,
            round_s=args.round_seconds,
            engine=args.engine,
            out_dir=args.out,
            seed=args.seed,
            rotate=args.seed_rotation,
            ring=not args.no_ring,
            inject_failure=args.inject_failure,
            reuse_out=args.reuse_out,
            triage=not args.no_triage,
            steps_per_sync=args.steps_per_sync,
            shard_over_mesh=args.shard_over_mesh,
            preflight=not args.no_preflight,
            device=args.device,
            rtt_ms=args.rtt_ms,
        )
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
