"""Quorum-loss repair: import an exported snapshot as a node's new history.

cf. reference tools/import.go:59-211 ImportSnapshot. When a Raft cluster
permanently loses its quorum, an operator takes a previously exported
snapshot (NodeHost.sync_request_snapshot(export_path=...)), decides the
new (reduced) membership, and runs import_snapshot on EACH surviving/new
host with the NodeHost stopped. The node's logdb history is rewritten so
the imported snapshot is its entire past and the membership is exactly
`member_nodes`.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict

from .. import codec
from ..config import NodeHostConfig
from ..engine.snapshotter import SNAPSHOT_METADATA_FILENAME
from ..storage.logdb import ShardedLogDB
from ..types import Membership, Snapshot


class ErrPathNotExist(ValueError):
    """The exported snapshot directory does not exist."""


class ErrIncompleteSnapshot(ValueError):
    """The directory does not contain a complete exported snapshot."""


class ErrInvalidMembers(ValueError):
    """member_nodes is empty, omits node_id, or conflicts with history."""


def _read_metadata(src_dir: str) -> Snapshot:
    mpath = os.path.join(src_dir, SNAPSHOT_METADATA_FILENAME)
    if not os.path.exists(mpath):
        raise ErrIncompleteSnapshot(f"no {SNAPSHOT_METADATA_FILENAME} in {src_dir}")
    with open(mpath, "rb") as f:
        ss, _ = codec.decode_snapshot(f.read())
    return ss


def _check_members(old: Membership, members: Dict[int, str]) -> None:
    """cf. import.go:313-333 checkMembers."""
    by_addr: Dict[str, int] = {}
    for nid, addr in members.items():
        if addr in by_addr:
            raise ErrInvalidMembers(
                f"nodes {by_addr[addr]} and {nid} share address {addr}"
            )
        by_addr[addr] = nid
        if nid in old.addresses and old.addresses[nid] != addr:
            raise ErrInvalidMembers(f"node {nid} address changed")
        if nid in old.observers:
            if old.observers[nid] != addr:
                raise ErrInvalidMembers(f"node {nid} address changed")
            raise ErrInvalidMembers(f"adding observer {nid} as regular node")
        if nid in old.removed:
            raise ErrInvalidMembers(f"adding removed node {nid}")
        # a new node must not take over an existing node's address
        for onid, oaddr in old.addresses.items():
            if nid != onid and addr == oaddr:
                raise ErrInvalidMembers(
                    f"node {nid} reuses node {onid}'s address {addr}"
                )


def _processed_record(
    dst_dir: str, old: Snapshot, members: Dict[int, str]
) -> Snapshot:
    """Rewrite the record: new membership, everyone else removed, marked
    imported (cf. import.go:334-377 getProcessedSnapshotRecord)."""
    m = Membership(config_change_id=old.index)
    old_m = old.membership or Membership()
    for nid in old_m.addresses:
        if nid not in members:
            m.removed[nid] = True
    for nid in old_m.observers:
        if nid not in members:
            m.removed[nid] = True
    for nid in old_m.removed:
        m.removed[nid] = True
    for nid, addr in members.items():
        m.addresses[nid] = addr
    files = []
    for f in old.files:
        nf = type(f)(
            filepath=os.path.join(dst_dir, os.path.basename(f.filepath)),
            file_size=f.file_size, file_id=f.file_id, metadata=f.metadata,
        )
        files.append(nf)
    return Snapshot(
        filepath=os.path.join(dst_dir, os.path.basename(old.filepath)),
        file_size=old.file_size,
        index=old.index,
        term=old.term,
        membership=m,
        files=files,
        checksum=old.checksum,
        dummy=old.dummy,
        cluster_id=old.cluster_id,
        type=old.type,
        imported=True,
        on_disk_index=old.on_disk_index,
    )


def import_snapshot(
    nh_config: NodeHostConfig,
    src_dir: str,
    member_nodes: Dict[int, str],
    node_id: int,
) -> Snapshot:
    """Rewrite node_id's history to the exported snapshot at src_dir with
    membership member_nodes. The NodeHost on this host MUST be stopped.
    Returns the imported Snapshot record."""
    if not member_nodes or node_id not in member_nodes:
        raise ErrInvalidMembers(
            f"member_nodes {member_nodes} must include node {node_id}"
        )
    if not os.path.isdir(src_dir):
        raise ErrPathNotExist(src_dir)
    old = _read_metadata(src_dir)
    ss_file = os.path.join(src_dir, os.path.basename(old.filepath))
    if not os.path.exists(ss_file) or (
        old.file_size and os.path.getsize(ss_file) != old.file_size
    ):
        raise ErrIncompleteSnapshot(f"snapshot image missing/truncated: {ss_file}")
    _check_members(old.membership or Membership(), member_nodes)

    # NodeHost dir layout (cf. NodeHost.__init__ / Snapshotter.__init__)
    nh_dir = os.path.join(
        nh_config.nodehost_dir, nh_config.raft_address.replace(":", "-")
    )
    os.makedirs(nh_dir, exist_ok=True)
    part = f"snapshot-part-{old.cluster_id:020d}-{node_id:020d}"
    node_ss_dir = os.path.join(nh_dir, "snapshots", part)
    final = os.path.join(node_ss_dir, f"snapshot-{old.index:016X}")
    # crash-safe ordering: (1) materialize the new image via tmp+rename,
    # (2) rewrite the logdb records in one atomic batch, (3) only then
    # delete the obsolete images. A crash at any point leaves either the
    # old state fully intact or the new state fully usable.
    tmp = final + ".importing"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name in os.listdir(src_dir):
        if name == SNAPSHOT_METADATA_FILENAME:
            continue
        shutil.copy2(os.path.join(src_dir, name), os.path.join(tmp, name))
    # keep a same-index existing image alive until the new one is in place
    # (a crash between delete and rename must never destroy the only copy a
    # live logdb record points at)
    replaced = final + ".replaced"
    if os.path.exists(replaced):
        shutil.rmtree(replaced)
    if os.path.exists(final):
        os.rename(final, replaced)
    os.rename(tmp, final)
    shutil.rmtree(replaced, ignore_errors=True)

    ss = _processed_record(final, old, member_nodes)
    if nh_config.logdb_factory is not None:
        logdb = nh_config.logdb_factory(nh_dir)
    else:
        logdb = ShardedLogDB(os.path.join(nh_dir, "logdb"))
    try:
        logdb.import_snapshot(ss, node_id)
    finally:
        logdb.close()
    for name in os.listdir(node_ss_dir):
        p = os.path.join(node_ss_dir, name)
        if p != final and os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
    return ss


__all__ = [
    "import_snapshot", "ErrPathNotExist", "ErrIncompleteSnapshot",
    "ErrInvalidMembers",
]
