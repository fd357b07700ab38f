"""Disk fsync latency / throughput probe (cf. reference tools/checkdisk —
used to qualify whether a disk can sustain the WAL fsync rate the raft
log store needs; the reference's benchmark_test.go:271 measures the same
number in-process)."""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

from ..trace import Sample


def check_disk(
    dirname: Optional[str] = None,
    count: int = 200,
    payload_size: int = 4096,
) -> dict:
    """Append+fsync `count` records of `payload_size` bytes; returns
    latency percentiles and effective synced-write IOPS."""
    tmp = None
    if dirname is None:
        tmp = tempfile.TemporaryDirectory(prefix="checkdisk-")
        dirname = tmp.name
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, "checkdisk.tmp")
    payload = os.urandom(payload_size)
    lat = Sample("fsync")
    t0 = time.perf_counter()
    try:
        with open(path, "ab") as f:
            for _ in range(count):
                s = time.perf_counter()
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
                lat.record(time.perf_counter() - s)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass
        if tmp is not None:
            tmp.cleanup()
    wall = time.perf_counter() - t0
    return {
        "count": count,
        "payload_size": payload_size,
        "fsync_p50_us": round(lat.percentile(0.5) * 1e6, 1),
        "fsync_p99_us": round(lat.percentile(0.99) * 1e6, 1),
        "fsync_mean_us": round(lat.mean() * 1e6, 1),
        "synced_writes_per_sec": round(count / wall, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=None, help="directory to probe")
    ap.add_argument("--count", type=int, default=200)
    ap.add_argument("--size", type=int, default=4096)
    args = ap.parse_args()
    print(json.dumps(check_disk(args.dir, args.count, args.size)))


if __name__ == "__main__":
    main()


__all__ = ["check_disk", "main"]
