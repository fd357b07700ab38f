"""raft-doctor: rule-based stall diagnosis over the telemetry history
ring, the flight-recorder dump, and a raft-top snapshot.

At vector scale nobody can eyeball raft-top to explain a stall: the raw
signal planes (lane stats, on-device counters, WAL barrier ledger,
serving/clock gauges) are instantaneous totals, and the history ring
(profile.HistorySampler) only turns them into time series. This module
is the interpretation layer: a fixed taxonomy of rules differences each
host's series over its evidence window and emits a RANKED list of typed
verdicts, each carrying the triggering lanes/hosts, the metric deltas
that fired the rule, and a one-line replay/remediation hint.

Taxonomy (severity-ranked; thresholds are the module constants below):

  no_quorum_partition   elections keep starting and never complete while
                        a member sees no leader — that member cannot
                        reach a quorum (partition / dead majority)
  wal_fsync_stall       the WAL durability-barrier latency (ewma over
                        fsync waves) is stall-grade — a slow or faulty
                        disk is backpressuring every save wave
  migration_wedged      a live migration is active but made zero
                        completion progress across the whole window
  election_churn        leadership keeps CHANGING (elections complete,
                        repeatedly) — unstable quorum, not a dead one
  snapshot_parked_remote a follower is pinned behind a frozen commit gap
                        while snapshot transfer traffic aborted or never
                        installed — catch-up is parked on the remote
  clock_anomaly         the tick clock read backward / diverged from
                        real time (leases go suspect, reads fall back)
  admission_shed_storm  the serving front is shedding admissions at
                        storm rate — overload, not protocol failure
  lease_fallback_storm  lease reads keep degrading to ReadIndex without
                        any clock fault to explain them
  lane_leak             the active lane count grows monotonically —
                        something starts lanes faster than it stops them
  healthy_idle          no rule fired over the window

In-process API: ``diagnose(hosts)`` samples the live fleet twice-plus
over a short window (profile.sample_host — zero-sync by construction)
and runs the rules; ``diagnose_data(history, flight, top)`` is the pure
rule engine over already-collected artifacts (what the longhaul failure
bundler and the CLI call).

CLI:

    python -m dragonboat_tpu_torch.tools.doctor <bundle-or-ring> [--json]

accepts a failure-bundle directory (tools.longhaul), a history ring
(``*.ring``), or a JSONL dump whose lines include ``history_sample``
events. Exit code 0 with verdicts rendered; 2 on unreadable input.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..profile import HISTORY_EVENT, read_history, sample_host
from ..trace import _RING_MAGIC, flight_recorder, read_mmap_ring

# ------------------------------------------------------------ thresholds
# doctor knobs: deliberately coarse — a rule should fire on stall-grade
# signal, not on healthy jitter (healthy_idle on a clean run is as much
# an acceptance criterion as the faults)
WAL_STALL_EWMA_S = 0.05     # fsync-wave ewma above this is a disk stall
SHED_STORM_MIN = 5          # serving sheds per window that make a storm
FALLBACK_STORM_MIN = 5      # lease->ReadIndex degradations per window
CHURN_MIN_WINS = 3          # completed elections per window = churn
LANE_LEAK_MIN_GROWTH = 8    # net active-lane growth per window = leak
PARKED_MIN_SAMPLES = 2      # frozen-gap evidence needs this many points

SEVERITY = {
    "no_quorum_partition": 95,
    "wal_fsync_stall": 90,
    "migration_wedged": 80,
    "election_churn": 75,
    "snapshot_parked_remote": 70,
    "clock_anomaly": 65,
    "admission_shed_storm": 60,
    "lease_fallback_storm": 55,
    "lane_leak": 50,
    "healthy_idle": 0,
}

HINTS = {
    "no_quorum_partition": (
        "check partitions/dead peers (flight: partition_set/host_crashed);"
        " replay the chaos seed and inspect tools.timeline --cluster"
    ),
    "wal_fsync_stall": (
        "measure the disk with tools.check_disk; look for fsync fault"
        " windows (flight: fault_injected kind=fsync) before blaming raft"
    ),
    "migration_wedged": (
        "inspect placement_migrations gauges + flight migration_* events;"
        " abort the plan (PlacementPlane.abort) to unpin the lane"
    ),
    "election_churn": (
        "leadership is flapping: look for asymmetric partitions or tick"
        " starvation (engine_tick_gap_max_seconds) before raising RTTs"
    ),
    "snapshot_parked_remote": (
        "catch-up is parked on a remote install: check snapshot_stream_*"
        " flight events and the receiver's disk/chunk lane budget"
    ),
    "clock_anomaly": (
        "the tick clock lied (skew/jump): leases went suspect by design;"
        " check the clock fault window in the flight dump, not the raft"
    ),
    "admission_shed_storm": (
        "overload, not failure: the front is shedding by policy — check"
        " serving_saturation and tenant budgets before scaling the fleet"
    ),
    "lease_fallback_storm": (
        "lease reads keep degrading without a clock fault: check leader"
        " stability on the serving lanes and the lease hold period"
    ),
    "lane_leak": (
        "active lanes grow monotonically: something starts clusters"
        " faster than it stops them (check restart/rebalance loops)"
    ),
    "healthy_idle": "no stall signature in the window; nothing to do",
}


@dataclass
class Verdict:
    """One typed diagnosis: what fired, where, on what evidence."""

    kind: str
    severity: int
    hosts: List[str] = field(default_factory=list)
    lanes: List[str] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    evidence: Dict[str, object] = field(default_factory=dict)
    hint: str = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "hosts": list(self.hosts),
            "lanes": list(self.lanes),
            "window": [round(self.window[0], 6), round(self.window[1], 6)],
            "evidence": dict(self.evidence),
            "hint": self.hint,
        }


def _verdict(kind, hosts=(), lanes=(), window=(0.0, 0.0), **evidence):
    return Verdict(
        kind=kind,
        severity=SEVERITY[kind],
        hosts=sorted(set(hosts)),
        lanes=sorted(set(lanes)),
        window=tuple(window),
        evidence=evidence,
        hint=HINTS[kind],
    )


# ------------------------------------------------------------ artifacts
def _is_ring(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_RING_MAGIC)) == _RING_MAGIC
    except OSError:
        return False


def _split_jsonl(path: str) -> Tuple[List[dict], List[dict]]:
    """(history samples, other flight events) from one JSONL dump —
    history samples are flight-compatible events, so a merged timeline
    or a flight dump may carry both kinds on one axis."""
    hist: List[dict] = []
    flight: List[dict] = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                d = json.loads(ln)
            except ValueError:
                continue  # torn tail line
            ev = d.get("event")
            if ev == "_meta":
                continue
            (hist if ev == HISTORY_EVENT else flight).append(d)
    return hist, flight


def load_history(path: str) -> List[dict]:
    """History samples from a ring or a JSONL dump (fixture form)."""
    if _is_ring(path):
        _meta, samples = read_history(path)
        return samples
    hist, _flight = _split_jsonl(path)
    return hist


def load_bundle(path: str) -> dict:
    """Resolve a diagnosis input into its three artifact planes:
    {"history": [...], "flight": [...], "top": {...}|None, "source"}.

    A directory is treated as a failure bundle (tools.longhaul): history
    from ``history.ring``/``history.jsonl``, flight events from
    ``flight_dump.jsonl``/``merged_timeline.jsonl``, snapshot from
    ``top_snapshot.json`` — whichever exist. A ``.ring`` file loads as
    whichever event kinds it holds; a ``.jsonl`` likewise."""
    out = {
        "history": [], "flight": [], "top": None,
        "source": os.path.basename(path.rstrip(os.sep)),
    }
    if os.path.isdir(path):
        for name in ("history.ring", "history.jsonl"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                out["history"].extend(load_history(p))
        for name in ("flight_dump.jsonl", "merged_timeline.jsonl"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                hist, flight = _split_jsonl(p)
                out["flight"].extend(flight)
                if not out["history"]:
                    out["history"].extend(hist)
        p = os.path.join(path, "top_snapshot.json")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    out["top"] = json.load(f)
            except (OSError, ValueError):
                pass
        if not (out["history"] or out["flight"]):
            raise ValueError(f"{path}: no diagnosable artifacts in bundle")
        return out
    if _is_ring(path):
        _meta, events = read_mmap_ring(path)
        for d in events:
            key = "history" if d.get("event") == HISTORY_EVENT else "flight"
            out[key].append(d)
        return out
    if path.endswith((".jsonl", ".json")):
        try:
            hist, flight = _split_jsonl(path)
        except OSError as e:
            raise ValueError(f"{path}: unreadable ({e})")
        if not (hist or flight):
            raise ValueError(f"{path}: no history samples or flight events")
        out["history"], out["flight"] = hist, flight
        return out
    raise ValueError(f"{path}: not a bundle dir, ring, or JSONL dump")


# ------------------------------------------------------------ rule engine
def _series(history: List[dict]) -> Dict[str, List[dict]]:
    by: Dict[str, List[dict]] = {}
    for s in history:
        if s.get("event") != HISTORY_EVENT:
            continue
        by.setdefault(str(s.get("host", "?")), []).append(s)
    for samples in by.values():
        samples.sort(key=lambda s: float(s.get("t", 0.0)))
    return by


def _get(d: dict, *path, default=0):
    cur = d
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def _delta(samples: List[dict], *path) -> float:
    """last - first of a (possibly nested) counter over one host's
    series — the windowed-rate view the history ring exists for."""
    if not samples:
        return 0.0
    return float(_get(samples[-1], *path)) - float(_get(samples[0], *path))


def _lane_delta(samples: List[dict], cid: str, counter: str) -> float:
    """Per-lane counter delta; a lane absent from the capped table at
    either endpoint contributes 0 (the cap is an honesty bound, not a
    claim the lane was quiet)."""
    first = _get(samples[0], "lanes", cid, "counters", counter, default=None)
    last = _get(samples[-1], "lanes", cid, "counters", counter, default=None)
    if first is None or last is None:
        return 0.0
    return float(last) - float(first)


def _cluster_view(series: Dict[str, List[dict]]):
    """Fold the per-host lane tables into a per-cluster view:
    cid -> {host: (first_row, last_row, started_d, won_d)}."""
    out: Dict[str, Dict[str, tuple]] = {}
    for host, samples in series.items():
        if not samples:
            continue
        last_lanes = _get(samples[-1], "lanes", default={}) or {}
        first_lanes = _get(samples[0], "lanes", default={}) or {}
        for cid, row in last_lanes.items():
            out.setdefault(str(cid), {})[host] = (
                first_lanes.get(cid),
                row,
                _lane_delta(samples, cid, "elections_started"),
                _lane_delta(samples, cid, "elections_won"),
            )
    return out


def _window(series: Dict[str, List[dict]]) -> Tuple[float, float]:
    ts = [
        float(s.get("t", 0.0))
        for samples in series.values()
        for s in samples
    ]
    return (min(ts), max(ts)) if ts else (0.0, 0.0)


def diagnose_data(
    history: List[dict],
    flight: List[dict] = (),
    top: Optional[dict] = None,
) -> List[Verdict]:
    """The pure rule engine: ranked verdicts (most severe first) from
    already-collected artifacts. ``history`` is the primary axis; the
    flight dump corroborates (snapshot transfer evidence), and the top
    snapshot rides along for renderers — absence of either degrades
    evidence, never crashes a rule."""
    series = _series(history)
    window = _window(series)
    verdicts: List[Verdict] = []
    clusters = _cluster_view(series)

    # --- quorum rules (per cluster, folded across hosts) ---------------
    for cid, by_host in sorted(clusters.items()):
        leaderless = [
            h for h, (_f, last, _s, _w) in by_host.items()
            if int(last.get("leader_id", 0)) == 0
        ]
        started_d = sum(s for (_f, _l, s, _w) in by_host.values())
        won_d = sum(w for (_f, _l, _s, w) in by_host.values())
        if leaderless and started_d > 0 and won_d == 0:
            verdicts.append(_verdict(
                "no_quorum_partition",
                hosts=leaderless,
                lanes=[cid],
                window=window,
                elections_started_delta=int(started_d),
                elections_won_delta=0,
                leaderless_hosts=sorted(leaderless),
            ))
        elif won_d >= CHURN_MIN_WINS:
            verdicts.append(_verdict(
                "election_churn",
                hosts=list(by_host),
                lanes=[cid],
                window=window,
                elections_won_delta=int(won_d),
                elections_started_delta=int(started_d),
            ))

    # --- snapshot_parked_remote: frozen gap + parked transfer ----------
    snap_events: Dict[object, Dict[str, int]] = {}
    for e in flight:
        ev = str(e.get("event", ""))
        if ev.startswith("snapshot_"):
            per = snap_events.setdefault(e.get("cluster", 0), {})
            per[ev] = per.get(ev, 0) + 1
    for cid, by_host in sorted(clusters.items()):
        for host, (first, last, _s, _w) in sorted(by_host.items()):
            if first is None or last is None:
                continue
            gap0 = int(first.get("commit_gap", 0))
            gap1 = int(last.get("commit_gap", 0))
            samples = series.get(host, ())
            if not (gap0 > 0 and gap0 == gap1):
                continue
            if len(samples) < PARKED_MIN_SAMPLES:
                continue
            if int(last.get("leader_id", 0)) == 0:
                continue  # that's the quorum rules' territory
            try:
                key = int(cid.split(":")[-1])
            except ValueError:
                key = cid
            per = snap_events.get(key, {})
            parked = (
                per.get("snapshot_stream_aborted", 0) > 0
                or (
                    per.get("snapshot_requested", 0) > 0
                    and per.get("snapshot_installed", 0) == 0
                )
            )
            if not parked:
                continue
            verdicts.append(_verdict(
                "snapshot_parked_remote",
                hosts=[host],
                lanes=[cid],
                window=window,
                commit_gap_frozen=gap1,
                snapshot_events=per,
            ))

    # --- per-host rules ------------------------------------------------
    for host, samples in sorted(series.items()):
        if not samples:
            continue
        # wal_fsync_stall: the barrier ledger's ewma is already a
        # smoothed latency — its MAX over the window is the stall grade
        ewma_max = max(
            float(_get(s, "wal", "ewma_s", default=0.0)) for s in samples
        )
        if ewma_max >= WAL_STALL_EWMA_S:
            verdicts.append(_verdict(
                "wal_fsync_stall",
                hosts=[host],
                window=window,
                fsync_ewma_max_s=round(ewma_max, 6),
                barriers_delta=int(_delta(samples, "wal", "barriers")),
            ))
        # clock_anomaly: any new tick-clock fault in the window (a
        # single-sample series reports its cumulative count instead)
        clk_d = (
            _delta(samples, "clock_anomalies")
            if len(samples) > 1
            else float(_get(samples[-1], "clock_anomalies"))
        )
        if clk_d > 0:
            verdicts.append(_verdict(
                "clock_anomaly",
                hosts=[host],
                window=window,
                clock_anomalies_delta=int(clk_d),
            ))
        # admission_shed_storm: the serving front shedding at storm rate
        shed_d = _delta(samples, "serving", "shed")
        if shed_d >= SHED_STORM_MIN:
            verdicts.append(_verdict(
                "admission_shed_storm",
                hosts=[host],
                window=window,
                shed_delta=int(shed_d),
                admitted_delta=int(_delta(samples, "serving", "admitted")),
                saturation_max=max(
                    float(_get(s, "serving", "saturation", default=0.0))
                    for s in samples
                ),
            ))
        # lease_fallback_storm: reads keep degrading to ReadIndex with
        # NO clock fault to explain them (clock_anomaly subsumes the
        # explained case — leases go suspect by design there)
        fb_d = _delta(samples, "lease", "fallback")
        if fb_d >= FALLBACK_STORM_MIN and clk_d == 0:
            local_d = _delta(samples, "lease", "local")
            if fb_d > local_d:
                verdicts.append(_verdict(
                    "lease_fallback_storm",
                    hosts=[host],
                    window=window,
                    lease_fallback_delta=int(fb_d),
                    lease_local_delta=int(local_d),
                ))
        # migration_wedged: a migration is active and made ZERO
        # completion progress across the whole window
        if len(samples) > 1:
            active_end = int(_get(samples[-1], "migrations", "active"))
            done_d = _delta(samples, "migrations", "completed") + _delta(
                samples, "migrations", "aborted"
            )
            if active_end > 0 and done_d == 0:
                verdicts.append(_verdict(
                    "migration_wedged",
                    hosts=[host],
                    window=window,
                    migrations_active=active_end,
                    started_delta=int(
                        _delta(samples, "migrations", "started")
                    ),
                    completed_or_aborted_delta=0,
                ))
        # lane_leak: monotone active-lane growth past the leak floor
        counts = [int(_get(s, "lanes_total")) for s in samples]
        if (
            len(counts) > 1
            and counts[-1] - counts[0] >= LANE_LEAK_MIN_GROWTH
            and all(b >= a for a, b in zip(counts, counts[1:]))
        ):
            verdicts.append(_verdict(
                "lane_leak",
                hosts=[host],
                window=window,
                lanes_first=counts[0],
                lanes_last=counts[-1],
            ))

    if not verdicts:
        verdicts.append(_verdict(
            "healthy_idle",
            hosts=list(series),
            window=window,
            samples=sum(len(s) for s in series.values()),
        ))
    verdicts.sort(key=lambda v: (-v.severity, v.kind, v.hosts))
    return verdicts


# ------------------------------------------------------------ live probe
def diagnose(
    hosts,
    window_s: float = 1.0,
    interval_s: float = 0.25,
    flight: Optional[List[dict]] = None,
) -> List[Verdict]:
    """Diagnose a LIVE fleet in-process: sample every host now, keep
    sampling on ``interval_s`` until ``window_s`` has passed (two passes
    minimum — one delta is the least a rate rule needs), then run the
    rule engine with the process flight recorder as corroboration.
    ``hosts`` is a mapping (key -> NodeHost) or an iterable of them."""
    if not isinstance(hosts, dict):
        hosts = {i: nh for i, nh in enumerate(hosts)}
    history: List[dict] = []

    def _pass():
        for _k, nh in sorted(hosts.items(), key=lambda kv: str(kv[0])):
            if nh is None:
                continue
            try:
                history.append(sample_host(nh))
            except Exception:
                pass  # a dying host's gap is itself a signal
    t_end = time.monotonic() + max(0.0, window_s)
    _pass()
    while True:
        remaining = t_end - time.monotonic()
        time.sleep(min(max(0.01, interval_s), max(0.01, remaining)))
        _pass()
        if time.monotonic() >= t_end:
            break
    if flight is None:
        flight = flight_recorder().dump()
    return diagnose_data(history, flight=flight)


def diagnosis_report(
    history: List[dict],
    flight: List[dict] = (),
    top: Optional[dict] = None,
    source: str = "",
) -> dict:
    """The diagnosis.json schema (longhaul failure bundles): the ranked
    verdicts plus the honesty header (how much evidence there was)."""
    series = _series(history)
    t0, t1 = _window(series)
    verdicts = diagnose_data(history, flight=flight, top=top)
    return {
        "schema": 1,
        "source": source,
        "samples": sum(len(s) for s in series.values()),
        "hosts": sorted(series),
        "window_s": round(t1 - t0, 6),
        "verdicts": [v.to_dict() for v in verdicts],
    }


# ------------------------------------------------------------- rendering
def _fmt_evidence(ev: dict) -> str:
    parts = []
    for k in sorted(ev):
        v = ev[k]
        if isinstance(v, float):
            v = f"{v:.6g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render(report: dict, out=None) -> None:
    out = out or sys.stdout
    out.write(
        f"raft-doctor: {len(report['verdicts'])} verdict(s) from "
        f"{report['samples']} sample(s), {len(report['hosts'])} host(s), "
        f"window {report['window_s']:.1f}s"
        + (f" [{report['source']}]" if report.get("source") else "")
        + "\n"
    )
    for i, v in enumerate(report["verdicts"], 1):
        where = ",".join(v["hosts"]) or "-"
        lanes = f" lanes={','.join(v['lanes'])}" if v["lanes"] else ""
        out.write(
            f"{i:>2}. {v['kind']:<22} sev={v['severity']:<3} "
            f"hosts={where}{lanes}\n"
        )
        ev = _fmt_evidence(v["evidence"])
        if ev:
            out.write(f"    evidence: {ev}\n")
        out.write(f"    hint: {v['hint']}\n")


def top_verdict_line(verdicts: List[Verdict]) -> str:
    """One-line summary of the most severe verdict — tools.top's
    console footer."""
    if not verdicts:
        return "doctor: (no verdicts)"
    v = verdicts[0]
    where = ",".join(v.hosts) or "-"
    lanes = f" lanes={','.join(v.lanes)}" if v.lanes else ""
    return f"doctor: {v.kind} sev={v.severity} hosts={where}{lanes}"


# -------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.doctor",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "path",
        help="failure-bundle dir, history ring, or JSONL dump",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit the diagnosis report as JSON instead of text",
    )
    args = ap.parse_args(argv)
    try:
        bundle = load_bundle(args.path)
    except (ValueError, OSError) as e:
        sys.stderr.write(f"doctor: {e}\n")
        return 2
    report = diagnosis_report(
        bundle["history"],
        flight=bundle["flight"],
        top=bundle["top"],
        source=bundle["source"],
    )
    if args.json:
        sys.stdout.write(json.dumps(report, indent=2, sort_keys=True) + "\n")
    else:
        render(report)
    return 0


__all__ = [
    "Verdict",
    "diagnose",
    "diagnose_data",
    "diagnosis_report",
    "load_bundle",
    "load_history",
    "render",
    "top_verdict_line",
    "main",
]


if __name__ == "__main__":
    raise SystemExit(main())
