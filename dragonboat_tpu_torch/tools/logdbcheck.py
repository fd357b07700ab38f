"""Cross-replica LogDB consistency checker.

Chaos-harness counterpart of the reference monkeytest's logdb validation
(the drummer harness cross-checks every replica's persisted raft log after
a run; cf. monkey.go GetLogDB + the Log Matching property, raft paper
section 5.3): for each replica pair of one Raft group, persisted entries
at the same index must agree on (term, cmd) up to the lower of the two
replicas' persisted commit indexes — uncommitted suffixes may legitimately
diverge. Also sanity-checks each replica's own record: commit within the
persisted entry range, contiguous indexes, terms monotonic.

Use from tests/chaos harnesses after stopping the NodeHosts (or while
quiescent):

    report = check_logdb_consistency({1: logdb1, 2: logdb2, 3: logdb3}, 1)
    assert not report.violations, report.violations
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_MAX_SCAN = 1 << 62


@dataclass
class ReplicaLog:
    node_id: int
    commit: int = 0
    term: int = 0
    first: int = 0
    last: int = 0
    # index -> (term, cmd)
    entries: Dict[int, Tuple[int, bytes]] = field(default_factory=dict)


@dataclass
class Report:
    replicas: List[ReplicaLog] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _load_replica(logdb, cluster_id: int, node_id: int) -> Optional[ReplicaLog]:
    from ..raftio import ErrNoSavedLog

    try:
        # latest snapshot marks the replica's floor; entries below it may
        # be compacted away
        snaps = logdb.list_snapshots(cluster_id, node_id, _MAX_SCAN)
    except Exception:
        snaps = []
    snap_index = snaps[-1].index if snaps else 0
    try:
        rs = logdb.read_raft_state(cluster_id, node_id, snap_index)
    except ErrNoSavedLog:
        return None
    rep = ReplicaLog(
        node_id=node_id,
        commit=rs.state.commit,
        term=rs.state.term,
        first=rs.first_index,
        last=rs.first_index + rs.entry_count - 1 if rs.entry_count else 0,
    )
    if rs.entry_count:
        ents, _ = logdb.iterate_entries(
            cluster_id, node_id, rs.first_index, rep.last + 1, _MAX_SCAN
        )
        for e in ents:
            rep.entries[e.index] = (e.term, e.cmd)
    return rep


def check_logdb_consistency(
    logdbs: Dict[int, object], cluster_id: int
) -> Report:
    """logdbs: node_id -> that replica's (Sharded)LogDB. Replicas with no
    persisted state for the cluster are skipped (never-started nodes)."""
    report = Report()
    reps: List[ReplicaLog] = []
    for nid, db in sorted(logdbs.items()):
        rep = _load_replica(db, cluster_id, nid)
        if rep is not None:
            reps.append(rep)
    report.replicas = reps

    # ---- per-replica sanity
    for r in reps:
        if r.entries:
            idxs = sorted(r.entries)
            if idxs != list(range(idxs[0], idxs[-1] + 1)):
                report.violations.append(
                    f"n{r.node_id}: persisted entry indexes not contiguous"
                )
            terms = [r.entries[i][0] for i in idxs]
            if any(a > b for a, b in zip(terms, terms[1:])):
                report.violations.append(
                    f"n{r.node_id}: entry terms decrease within the log"
                )
            if r.commit > idxs[-1]:
                report.violations.append(
                    f"n{r.node_id}: commit {r.commit} beyond last persisted "
                    f"entry {idxs[-1]}"
                )
        for i, (t, _) in r.entries.items():
            if t > r.term:
                report.violations.append(
                    f"n{r.node_id}: entry {i} term {t} above persisted "
                    f"current term {r.term}"
                )

    # ---- pairwise log matching up to the common commit point
    for a_i in range(len(reps)):
        for b_i in range(a_i + 1, len(reps)):
            a, b = reps[a_i], reps[b_i]
            lo = max(min(a.entries, default=1), min(b.entries, default=1))
            hi = min(a.commit, b.commit)
            for idx in range(lo, hi + 1):
                ea = a.entries.get(idx)
                eb = b.entries.get(idx)
                if ea is None or eb is None:
                    continue  # compacted on one side
                if ea != eb:
                    report.violations.append(
                        f"log divergence at index {idx} below common commit "
                        f"{hi}: n{a.node_id} has (term={ea[0]}, "
                        f"{len(ea[1])}B) vs n{b.node_id} (term={eb[0]}, "
                        f"{len(eb[1])}B)"
                    )
                    break  # one divergence per pair is enough signal
    return report


__all__ = ["check_logdb_consistency", "Report", "ReplicaLog"]
