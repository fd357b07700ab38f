"""Forensic timeline CLI over flight-recorder artifacts.

Merges flight-recorder dumps from N nodes — JSONL failure dumps
(`.pytest_flight/*.jsonl`, NodeHost.dump_flight) and crash-persistent
mmap rings (trace.MmapRing files left behind by SIGKILL'd processes) —
into ONE ordered timeline, filters it by cluster / trace id / event type,
and pretty-prints causal chains.

Clock merging: each process's `time.monotonic()` has an arbitrary base,
so raw `t` values from different dumps are not comparable. Every dump
carries its process's wall-minus-monotonic offset (`mono_offset`: a
`_meta` JSONL header line, or the mmap ring header), negotiated once at
recorder creation; the merge normalizes every event to the wall clock
(`t + mono_offset`) and sorts. Dumps without a meta line merge on raw
`t` — correct for dumps split out of one process, best-effort otherwise.

Usage:

    python -m dragonboat_tpu_torch.tools.timeline n1.jsonl n2.jsonl n3.ring \\
        [--cluster 2] [--trace 0x1c0ffee00000001] [--event leader_changed]
        [--chains] [--spans] [--json]

`--chains` groups the filtered events by trace id and prints each
proposal's causal chain (propose_enqueue -> replicate_send ->
replicate_recv -> quorum_commit -> proposal_applied) with per-stage
deltas — the view that turns a chaos seed's `CHAOS_SEED` + `.pytest_flight/`
artifacts into "what did this proposal actually do, on which node, when".

`--spans` renders the step-phase profiler's `phase_span` events (see
dragonboat_tpu_torch.profile) as duration bars ordered by span START,
interleaved with the causal-trace stage events — "which engine phase was
running while this proposal committed". Gzip-compressed JSONL dumps
(`NodeHost.dump_flight` rotation artifacts, or dumps written straight to
a `.gz` path) are read transparently.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
from typing import Dict, List, Optional

from ..trace import _RING_MAGIC, read_mmap_ring

_GZIP_MAGIC = b"\x1f\x8b"

# stages in causal order, for chain rendering (unknown events sort by time)
CHAIN_STAGES = (
    "propose_enqueue",
    "replicate_send",
    "replicate_recv",
    "replicate_ack",
    "quorum_commit",
    "proposal_applied",
)


def _is_ring(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_RING_MAGIC)) == _RING_MAGIC
    except OSError:
        return False


def _open_text(path: str):
    """Open a JSONL dump for reading, decompressing gzip transparently
    (detected by magic, not extension — rotation artifacts keep working
    however they were named)."""
    with open(path, "rb") as f:
        if f.read(2) == _GZIP_MAGIC:
            return gzip.open(path, "rt")
    return open(path)


def load_dump(path: str) -> List[dict]:
    """Load one artifact (JSONL dump — plain or gzipped — or mmap ring)
    into normalized events: each event gains `_src` (which dump it came
    from) and `_tw` (wall-clock time, the cross-process merge axis)."""
    if _is_ring(path):
        meta, events = read_mmap_ring(path)
    else:
        meta = {"mono_offset": 0.0, "source": os.path.basename(path)}
        events = []
        with _open_text(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    d = json.loads(ln)
                except ValueError:
                    continue  # tolerate a torn tail line
                if d.get("event") == "_meta":
                    meta.update(d)
                else:
                    events.append(d)
    src = str(meta.get("source") or os.path.basename(path))
    off = float(meta.get("mono_offset") or 0.0)
    for e in events:
        e["_src"] = src
        e["_tw"] = float(e.get("t", 0.0)) + off
    return events


def merge_dumps(paths) -> List[dict]:
    """One ordered timeline across every artifact (see module docstring
    for the clock negotiation)."""
    events: List[dict] = []
    for p in paths:
        events.extend(load_dump(p))
    events.sort(key=lambda e: (e["_tw"], e.get("t", 0.0)))
    return events


# artifact suffixes sweep_artifacts collects: JSONL flight dumps (plain
# and gzip-rotated) and crash-persistent mmap rings incl. the `.prev`
# rotation a restarted process leaves behind (trace.attach_mmap)
_SWEEP_SUFFIXES = (".ring", ".ring.prev", ".jsonl", ".jsonl.gz")


def sweep_artifacts(root: str) -> List[str]:
    """Walk a run directory (e.g. a tools.longhaul round dir) for every
    forensic artifact a chaos run can leave behind — JSONL flight dumps
    and `*.ring` / `*.ring.prev` mmap rings from crashed or restarted
    processes — so a failure bundle never requires manual collection.
    Returns sorted paths; non-ring `.ring` files (torn/empty) are kept —
    load_dump skips what it cannot parse."""
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(_SWEEP_SUFFIXES):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def filter_events(
    events: List[dict],
    cluster: Optional[int] = None,
    trace: Optional[int] = None,
    kinds=None,
) -> List[dict]:
    out = []
    for e in events:
        if cluster is not None and e.get("cluster") != cluster:
            continue
        if trace is not None and e.get("trace") != trace:
            continue
        if kinds and e.get("event") not in kinds:
            continue
        out.append(e)
    return out


def causal_chains(events: List[dict]) -> Dict[int, List[dict]]:
    """Group trace-stamped events by trace id, each chain time-ordered."""
    chains: Dict[int, List[dict]] = {}
    for e in events:
        tid = e.get("trace")
        if not tid:
            continue
        chains.setdefault(tid, []).append(e)
    for evs in chains.values():
        evs.sort(key=lambda e: e["_tw"])
    return chains


def _fmt_fields(e: dict) -> str:
    skip = {"t", "_tw", "_src", "event", "trace"}
    parts = []
    for k in sorted(e):
        if k in skip:
            continue
        parts.append(f"{k}={e[k]}")
    return " ".join(parts)


def format_timeline(events: List[dict], out=None) -> None:
    out = out or sys.stdout
    if not events:
        out.write("(no events)\n")
        return
    t0 = events[0]["_tw"]
    for e in events:
        tid = e.get("trace")
        tag = f" trace={tid:#x}" if tid else ""
        out.write(
            f"+{e['_tw'] - t0:11.6f}s [{e['_src']}] "
            f"{e['event']}{tag} {_fmt_fields(e)}\n"
        )


def format_spans(events: List[dict], out=None) -> None:
    """Span-aware timeline: `phase_span` events are recorded at span END
    carrying `dur`, so each is re-anchored to its START and printed as a
    duration bar, interleaved (by start time) with every other event in
    the filtered set — the view that puts a proposal's causal stages
    against the engine phases that carried them."""
    out = out or sys.stdout
    rows = []
    for e in events:
        if e.get("event") == "phase_span":
            dur = float(e.get("dur", 0.0))
            rows.append((e["_tw"] - dur, e, dur))
        else:
            rows.append((e["_tw"], e, None))
    if not rows:
        out.write("(no events)\n")
        return
    rows.sort(key=lambda r: r[0])
    t0 = rows[0][0]
    for start, e, dur in rows:
        if dur is None:
            tid = e.get("trace")
            tag = f" trace={tid:#x}" if tid else ""
            out.write(
                f"+{start - t0:11.6f}s [{e['_src']}] "
                f"{e['event']}{tag} {_fmt_fields(e)}\n"
            )
        else:
            out.write(
                f"+{start - t0:11.6f}s [{e['_src']}] "
                f"|-- {e.get('engine', '?')}/{e.get('phase', '?')} "
                f"{dur * 1e6:.1f}us --|\n"
            )


def format_chains(events: List[dict], out=None) -> int:
    """Pretty-print every causal chain in the events; returns the number
    of chains rendered."""
    out = out or sys.stdout
    chains = causal_chains(events)
    for tid in sorted(chains):
        evs = chains[tid]
        nodes = sorted(
            {e.get("node") for e in evs if e.get("node") is not None}
        )
        out.write(
            f"trace {tid:#x}: {len(evs)} events, "
            f"nodes {nodes}, cluster {evs[0].get('cluster')}\n"
        )
        t0 = evs[0]["_tw"]
        for e in evs:
            out.write(
                f"  +{e['_tw'] - t0:9.6f}s {e['event']:<18} "
                f"[{e['_src']}] {_fmt_fields(e)}\n"
            )
    if not chains:
        out.write("(no trace-stamped events)\n")
    return len(chains)


def _parse_int(v: str) -> int:
    return int(v, 0)  # accepts decimal and 0x...


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.timeline",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("paths", nargs="*", help="JSONL dumps and/or mmap rings")
    ap.add_argument("--sweep", action="append", default=None,
                    metavar="DIR",
                    help="walk DIR for *.jsonl/*.jsonl.gz/*.ring/"
                         "*.ring.prev artifacts and merge them all "
                         "(repeatable; composes with explicit paths)")
    ap.add_argument("--cluster", type=_parse_int, default=None,
                    help="only events of this raft group (0 = host-level)")
    ap.add_argument("--trace", type=_parse_int, default=None,
                    help="only events stamped with this trace id")
    ap.add_argument("--event", action="append", default=None,
                    help="only these event types (repeatable)")
    ap.add_argument("--chains", action="store_true",
                    help="group by trace id and print causal chains")
    ap.add_argument("--spans", action="store_true",
                    help="render step-phase profiler spans (phase_span "
                         "events) as duration bars interleaved with the "
                         "causal-trace stages")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged, filtered events as JSONL")
    args = ap.parse_args(argv)
    paths = list(args.paths)
    for d in args.sweep or ():
        paths.extend(sweep_artifacts(d))
    if not paths:
        ap.error("no artifacts: give paths and/or --sweep DIR")
    args.paths = paths
    kinds = set(args.event) if args.event else None
    if args.spans and kinds is None:
        # default --spans view: the profiler spans against the causal
        # chain stages (everything else stays reachable via --event)
        kinds = set(CHAIN_STAGES) | {"phase_span"}
    events = filter_events(
        merge_dumps(args.paths),
        cluster=args.cluster,
        trace=args.trace,
        kinds=kinds,
    )
    if args.json:
        for e in events:
            sys.stdout.write(json.dumps(e, default=str, sort_keys=True) + "\n")
        return 0
    if args.spans:
        format_spans(events)
        return 0
    if args.chains:
        format_chains(events)
        return 0
    format_timeline(events)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
