"""raft-top: operator console ranking Raft lanes by heat.

Renders the fleet the way `top` renders processes: one row per lane
(host, cluster), ranked by a heat score folded from the signals an
operator chases first when a box melts:

    heat = 4 * commit_gap            (replication falling behind)
         + 8 * elections_started     (leadership churn burns everything)
         + 2 * lease_fallback        (local reads degrading to quorum)
         + 1 * replicate_rejects     (followers refusing appends)
         + ingest rate (idx/s)       (who is actually loaded — needs two
                                      snapshots; 0 on a frozen view)

above a header panel carrying the HBM census (device bytes, log fill
p50/p99 vs the dense widest-lane allocation, waste ratio) and the
engine-wide counter totals.

Data comes from the engines' export paths only — `lane_stats` /
`lane_counters` / `counter_stats` / `device_census` / `pressure_stats`
are numpy-mirror folds on the vector engine and plain-int reads on the
scalar one, so attaching raft-top to a live host costs ZERO device
syncs and zero retraces.

Three ways in:

  in-process   snap = collect_snapshot(hosts)        # {nid: NodeHost}
               print(render(snap))                    # or json.dump(snap)
               (tools.longhaul bundles exactly this into failure dirs)

  CLI          python -m dragonboat_tpu_torch.tools.top SNAPSHOT.json
                   [--json] [--limit N] [--sort heat|gap|elections|ingest]
                   [--watch SECS]

  history      python -m dragonboat_tpu_torch.tools.top --history HISTORY.ring
               renders the LAST two samples of a telemetry history ring
               (profile.HistorySampler) as the snapshot pair — windowed
               ingest/churn rates from ONE artifact, no need for two
               consecutive snapshot files — and appends raft-doctor's
               top verdict as a one-line footer. Composes with --watch
               (re-reads the ring each interval, so a live sampler
               turns the console into a real-time view).

The snapshot CLI operates on FILES (bench and longhaul write them as
artifacts); `--watch` re-reads the file each interval and derives ingest
rates from consecutive reads, so a writer refreshing the snapshot turns
a frozen view into a live console without any IPC plumbing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from .doctor import diagnose_data, load_history, top_verdict_line

SNAPSHOT_SCHEMA = 1

# heat weights (module docstring is the operator-facing contract)
_W_GAP = 4.0
_W_ELECTIONS = 8.0
_W_FALLBACK = 2.0
_W_REJECTS = 1.0

_ROLE_NAMES = {
    0: "follower", 1: "candidate", 2: "leader",
    3: "observer", 4: "witness", 5: "precand",
}


def collect_snapshot(hosts) -> dict:
    """Fold one frozen raft-top view from live NodeHosts ({nid: host}).

    Engines are deduped by core identity (a shared vector core hands
    every host the same lane table; each host's handle still filters
    lane_stats/lane_counters to its own lanes, so rows never double).
    Every read goes through the engines' zero-sync export paths."""
    lanes: List[dict] = []
    census: Optional[dict] = None
    counters: Dict[str, int] = {}
    pressure: Dict[str, float] = {}
    seen_cores = set()
    for nid, nh in sorted(hosts.items()):
        eng = getattr(nh, "engine", None)
        if eng is None:
            continue
        stats_fn = getattr(eng, "lane_stats", None)
        lane_counter_fn = getattr(eng, "lane_counters", None)
        per_lane = lane_counter_fn() if lane_counter_fn is not None else {}
        if stats_fn is not None:
            for cid, s in sorted(stats_fn().items()):
                row = {"host": int(nid), "cluster_id": int(cid)}
                row.update({k: int(v) for k, v in s.items()})
                row["counters"] = {
                    k: int(v) for k, v in per_lane.get(cid, {}).items()
                }
                lanes.append(row)
        core = id(getattr(eng, "core", eng))
        if core in seen_cores:
            continue
        seen_cores.add(core)
        census_fn = getattr(eng, "device_census", None)
        if census_fn is not None:
            c = census_fn()
            if census is None or c.get("hbm_bytes_total", 0) > census.get(
                "hbm_bytes_total", 0
            ):
                census = c
        totals_fn = getattr(eng, "counter_stats", None)
        if totals_fn is not None:
            for k, v in totals_fn().items():
                counters[k] = counters.get(k, 0) + int(v)
        pressure_fn = getattr(eng, "pressure_stats", None)
        if pressure_fn is not None:
            p = pressure_fn()
            pressure["inbox_occupancy"] = max(
                pressure.get("inbox_occupancy", 0.0),
                float(p.get("inbox_occupancy", 0.0)),
            )
            pressure["staged_backlog"] = pressure.get(
                "staged_backlog", 0
            ) + int(p.get("staged_backlog", 0))
    return {
        "schema": SNAPSHOT_SCHEMA,
        "ts": time.time(),
        "lanes": lanes,
        "census": census or {},
        "counters": counters,
        "pressure": pressure,
    }


def _lane_key(row: dict):
    return (row.get("host", 0), row.get("cluster_id", 0))


def lane_heat(row: dict, prev: Optional[dict] = None, dt: float = 0.0):
    """(heat, ingest_rate) for one lane row; prev is the SAME lane's row
    from an earlier snapshot (ingest = last_index delta per second)."""
    c = row.get("counters", {})
    ingest = 0.0
    if prev is not None and dt > 0:
        ingest = max(
            0.0,
            (row.get("last_index", 0) - prev.get("last_index", 0)) / dt,
        )
    pc = (prev or {}).get("counters", {}) if prev is not None else {}
    # counters are cumulative: a delta view scores the WINDOW's churn,
    # a frozen view scores lifetime churn (still the right ranking for
    # a failure bundle — the lane that churned most is the suspect)
    elections = c.get("elections_started", 0) - pc.get(
        "elections_started", 0
    )
    fallback = c.get("lease_fallback", 0) - pc.get("lease_fallback", 0)
    rejects = c.get("replicate_rejects", 0) - pc.get(
        "replicate_rejects", 0
    )
    heat = (
        _W_GAP * row.get("commit_gap", 0)
        + _W_ELECTIONS * elections
        + _W_FALLBACK * fallback
        + _W_REJECTS * rejects
        + ingest
    )
    return heat, ingest


_SORTS = ("heat", "gap", "elections", "ingest")


def rank_lanes(
    snap: dict, prev: Optional[dict] = None, sort: str = "heat"
) -> List[dict]:
    """Annotate each lane row with heat/ingest and return rows ranked
    hottest-first by the chosen axis."""
    prev_rows = (
        {_lane_key(r): r for r in prev.get("lanes", [])} if prev else {}
    )
    dt = (snap.get("ts", 0.0) - prev.get("ts", 0.0)) if prev else 0.0
    out = []
    for row in snap.get("lanes", []):
        r = dict(row)
        heat, ingest = lane_heat(r, prev_rows.get(_lane_key(r)), dt)
        r["heat"] = round(heat, 1)
        r["ingest_rate"] = round(ingest, 1)
        out.append(r)
    keys = {
        "heat": lambda r: r["heat"],
        "gap": lambda r: r.get("commit_gap", 0),
        "elections": lambda r: r["counters"].get("elections_started", 0),
        "ingest": lambda r: r["ingest_rate"],
    }
    out.sort(key=keys.get(sort, keys["heat"]), reverse=True)
    return out


def render(
    snap: dict,
    prev: Optional[dict] = None,
    limit: int = 20,
    sort: str = "heat",
    out=None,
    footer: Optional[str] = None,
) -> None:
    """Print the console view: census/counter header + ranked lane table
    (+ an optional footer line — the --history mode's doctor verdict)."""
    out = out or sys.stdout
    c = snap.get("census", {})
    ctr = snap.get("counters", {})
    p = snap.get("pressure", {})
    lanes = rank_lanes(snap, prev, sort)
    out.write(
        "raft-top  lanes={n}  hbm={hbm:.1f}MiB (log {log:.1f}MiB)  "
        "fill p50={p50:.2f} p99={p99:.2f}  waste={waste:.2f}\n".format(
            n=len(lanes),
            hbm=c.get("hbm_bytes_total", 0) / 2**20,
            log=c.get("hbm_log_bytes", 0) / 2**20,
            p50=c.get("log_fill_p50", 0.0),
            p99=c.get("log_fill_p99", 0.0),
            waste=c.get("hbm_waste_ratio", 0.0),
        )
    )
    out.write(
        "elections {es}/{ew}  hb {hb}  rejects {rj}  commits {ca}  "
        "reads {rc} (lease {ls}/fb {lf})  inbox {occ:.2f}  backlog {bk}\n"
        .format(
            es=ctr.get("elections_started", 0),
            ew=ctr.get("elections_won", 0),
            hb=ctr.get("heartbeats_sent", 0),
            rj=ctr.get("replicate_rejects", 0),
            ca=ctr.get("commit_advances", 0),
            rc=ctr.get("read_confirmations", 0),
            ls=ctr.get("lease_served", 0),
            lf=ctr.get("lease_fallback", 0),
            occ=p.get("inbox_occupancy", 0.0),
            bk=p.get("staged_backlog", 0),
        )
    )
    hdr = (
        f"{'HOST':>4} {'GRP':>6} {'ROLE':<9} {'TERM':>5} {'GAP':>6} "
        f"{'LAST':>8} {'ING/S':>8} {'ELEC':>5} {'LFBK':>5} {'REJ':>5} "
        f"{'HEAT':>8}"
    )
    out.write(hdr + "\n")
    for r in lanes[: max(limit, 0) or None]:
        cc = r.get("counters", {})
        out.write(
            f"{r.get('host', 0):>4} {r.get('cluster_id', 0):>6} "
            f"{_ROLE_NAMES.get(r.get('role', 0), '?'):<9} "
            f"{r.get('term', 0):>5} {r.get('commit_gap', 0):>6} "
            f"{r.get('last_index', 0):>8} {r['ingest_rate']:>8.1f} "
            f"{cc.get('elections_started', 0):>5} "
            f"{cc.get('lease_fallback', 0):>5} "
            f"{cc.get('replicate_rejects', 0):>5} "
            f"{r['heat']:>8.1f}\n"
        )
    if footer:
        out.write(footer + "\n")


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        snap = json.load(f)
    if not isinstance(snap, dict) or "lanes" not in snap:
        raise ValueError(f"{path}: not a raft-top snapshot")
    return snap


def history_to_snapshots(history: List[dict]):
    """(snap, prev) raft-top snapshot views folded from history samples
    (profile.HistorySampler): `snap` from each host's LAST sample,
    `prev` from its second-last — the pair the heat/ingest rates need,
    out of ONE artifact. Hosts with a single sample appear in `snap`
    only (their lanes rank with rate 0); `prev` is None when no host
    has two. Timestamps are the samples' monotonic `t` (rates only need
    the difference). Lane rows keep the sampler's capped hot-lane table
    — `lanes` here means "the lanes worth looking at", same contract as
    the ring slot they came from."""
    by: Dict[str, List[dict]] = {}
    for s in history:
        if s.get("event") != "history_sample":
            continue
        by.setdefault(str(s.get("host", "?")), []).append(s)
    for samples in by.values():
        samples.sort(key=lambda s: float(s.get("t", 0.0)))

    def fold(idx: int) -> Optional[dict]:
        lanes: List[dict] = []
        counters: Dict[str, int] = {}
        census: Dict[str, object] = {}
        pressure: Dict[str, float] = {}
        ts = 0.0
        got = False
        for host, samples in sorted(by.items()):
            if len(samples) < abs(idx):
                continue
            s = samples[idx]
            got = True
            ts = max(ts, float(s.get("t", 0.0)))
            for cid, row in sorted((s.get("lanes") or {}).items()):
                r = {
                    "host": host,
                    "cluster_id": (
                        int(cid) if str(cid).isdigit() else str(cid)
                    ),
                }
                r.update(row)
                r.setdefault("counters", {})
                lanes.append(r)
            for k, v in (s.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + int(v)
            c = s.get("census") or {}
            if int(c.get("hbm_bytes_total", 0)) >= int(
                census.get("hbm_bytes_total", 0)
            ):
                census = dict(c)
            p = s.get("pressure") or {}
            pressure["inbox_occupancy"] = max(
                pressure.get("inbox_occupancy", 0.0),
                float(p.get("inbox_occupancy", 0.0)),
            )
            pressure["staged_backlog"] = pressure.get(
                "staged_backlog", 0
            ) + int(p.get("staged_backlog", 0))
        if not got:
            return None
        return {
            "schema": SNAPSHOT_SCHEMA,
            "ts": ts,
            "lanes": lanes,
            "census": census,
            "counters": counters,
            "pressure": pressure,
        }

    return fold(-1), fold(-2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.top",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("snapshot", nargs="?", default=None,
                    help="snapshot JSON written by collect_snapshot "
                         "(bench/longhaul artifact)")
    ap.add_argument("--history", default=None, metavar="RING",
                    help="render from a telemetry history ring "
                         "(profile.HistorySampler) instead of snapshot "
                         "files: rates from the last two samples, "
                         "raft-doctor's top verdict as a footer")
    ap.add_argument("--json", action="store_true",
                    help="emit the ranked snapshot as JSON instead of "
                         "the console table")
    ap.add_argument("--limit", type=int, default=20,
                    help="rows to show (0 = all; default 20)")
    ap.add_argument("--sort", choices=_SORTS, default="heat",
                    help="ranking axis (default heat)")
    ap.add_argument("--watch", type=float, default=None, metavar="SECS",
                    help="re-read the snapshot file (or history ring) "
                         "each interval; ingest rates derive from "
                         "consecutive reads")
    args = ap.parse_args(argv)
    if (args.snapshot is None) == (args.history is None):
        ap.error("give a snapshot file OR --history RING")

    def load_view():
        """(snap, prev, footer) for one render pass."""
        if args.history is None:
            return load_snapshot(args.snapshot), None, None
        history = load_history(args.history)
        snap, prev = history_to_snapshots(history)
        if snap is None:
            raise ValueError(f"{args.history}: no history samples")
        footer = top_verdict_line(diagnose_data(history))
        return snap, prev, footer

    try:
        snap, prev, footer = load_view()
    except (OSError, ValueError) as e:
        sys.stderr.write(f"error: {e}\n")
        return 2
    if args.watch is None:
        if args.json:
            json.dump(
                {**snap, "lanes": rank_lanes(snap, prev, sort=args.sort)},
                sys.stdout, sort_keys=True,
            )
            sys.stdout.write("\n")
        else:
            render(
                snap, prev=prev, limit=args.limit, sort=args.sort,
                footer=footer,
            )
        return 0
    file_prev = None  # snapshot-file mode: rates from consecutive reads
    try:
        while True:
            render(
                snap,
                prev=prev if args.history is not None else file_prev,
                limit=args.limit, sort=args.sort, footer=footer,
            )
            sys.stdout.write("\n")
            sys.stdout.flush()
            time.sleep(max(args.watch, 0.05))
            file_prev = snap
            try:
                snap, prev, footer = load_view()
            except (OSError, ValueError):
                pass  # writer mid-rotation: keep the last good view
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
