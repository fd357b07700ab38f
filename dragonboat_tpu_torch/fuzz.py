"""In-tree mutation fuzzer for the wire codec, the TCP framing and the
WAL record-group decoder.

The reference ships go-fuzz harnesses for the first two surfaces —
entry/message unmarshal round-trips (raftpb/fuzz.go:15-49) and the framed
transport decoder (internal/transport/fuzz.go:68-77). Without network
egress or external fuzzers, this is a self-contained deterministic
harness: seeded generators produce valid wire objects, byte-level
mutators corrupt their encodings, and the decoders must either succeed
or raise a CONTROLLED error (CodecError / FrameError) — never crash,
hang, or attempt an unbounded allocation.

The WAL campaign (fuzz_wal_recovery / fuzz_wal_garbage) drives WalKV's
record-group replay: a log whose TAIL was mutated or truncated must
recover to the state after some PREFIX of committed record groups —
atomically per group, never crashing and never accepting a record whose
CRC/framing does not hold.

Run standalone for a timed campaign:
    python -m dragonboat_tpu_torch.fuzz --seconds 30
CI runs a bounded iteration count through tests/test_torch_fuzz.py.
"""
from __future__ import annotations

import argparse
import random
import time
from typing import List, Tuple

from . import codec
from .types import (
    Entry,
    EntryType,
    Membership,
    Message,
    MessageBatch,
    MessageType,
    Snapshot,
    SnapshotFile,
    State,
)

# every way a decoder is allowed to fail on corrupt input
ALLOWED_ERRORS = (codec.CodecError,)


def _rand_bytes(rng: random.Random, cap: int = 64) -> bytes:
    return rng.randbytes(rng.randrange(cap))


def _rand_entry(rng: random.Random) -> Entry:
    return Entry(
        type=rng.choice(list(EntryType)),
        index=rng.randrange(1 << 40),
        term=rng.randrange(1 << 30),
        key=rng.randrange(1 << 50),
        client_id=rng.randrange(1 << 50),
        series_id=rng.randrange(1 << 30),
        responded_to=rng.randrange(1 << 30),
        cmd=_rand_bytes(rng),
    )


def _rand_membership(rng: random.Random) -> Membership:
    return Membership(
        config_change_id=rng.randrange(1 << 30),
        addresses={
            rng.randrange(1, 64): f"h{rng.randrange(64)}:{rng.randrange(1, 65535)}"
            for _ in range(rng.randrange(4))
        },
        observers={rng.randrange(64, 96): "o:1" for _ in range(rng.randrange(2))},
        witnesses={rng.randrange(96, 128): "w:1" for _ in range(rng.randrange(2))},
        removed={rng.randrange(1 << 20): True for _ in range(rng.randrange(3))},
    )


def _rand_snapshot(rng: random.Random) -> Snapshot:
    return Snapshot(
        filepath=f"/snap/{rng.randrange(1 << 20)}",
        file_size=rng.randrange(1 << 40),
        index=rng.randrange(1 << 40),
        term=rng.randrange(1 << 30),
        cluster_id=rng.randrange(1 << 30),
        checksum=_rand_bytes(rng, 16),
        membership=_rand_membership(rng) if rng.random() < 0.8 else None,
        files=[
            SnapshotFile(
                file_id=rng.randrange(1 << 20),
                filepath=f"/f/{rng.randrange(100)}",
                file_size=rng.randrange(1 << 30),
                metadata=_rand_bytes(rng, 16),
            )
            for _ in range(rng.randrange(3))
        ],
        dummy=rng.random() < 0.1,
        witness=rng.random() < 0.1,
        imported=rng.random() < 0.1,
        on_disk_index=rng.randrange(1 << 30),
    )


def _rand_message(rng: random.Random) -> Message:
    return Message(
        type=rng.choice(list(MessageType)),
        to=rng.randrange(1 << 30),
        from_=rng.randrange(1 << 30),
        cluster_id=rng.randrange(1 << 40),
        term=rng.randrange(1 << 30),
        log_term=rng.randrange(1 << 30),
        log_index=rng.randrange(1 << 40),
        commit=rng.randrange(1 << 40),
        reject=rng.random() < 0.3,
        hint=rng.randrange(1 << 40),
        hint_high=rng.randrange(1 << 40),
        entries=[_rand_entry(rng) for _ in range(rng.randrange(4))],
        snapshot=_rand_snapshot(rng) if rng.random() < 0.2 else None,
    )


def _rand_batch(rng: random.Random) -> MessageBatch:
    return MessageBatch(
        deployment_id=rng.randrange(1 << 30),
        source_address=f"src{rng.randrange(100)}:1",
        bin_ver=rng.randrange(16),
        requests=[_rand_message(rng) for _ in range(rng.randrange(5))],
    )


def _mutate(rng: random.Random, data: bytes) -> bytes:
    """One random corruption: bit flip, byte splice, truncation, garbage
    insertion, or length-field-style overwrite."""
    if not data:
        return rng.randbytes(rng.randrange(1, 9))
    b = bytearray(data)
    op = rng.randrange(5)
    if op == 0:  # flip bits
        for _ in range(rng.randrange(1, 9)):
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
    elif op == 1:  # truncate
        b = b[: rng.randrange(len(b))]
    elif op == 2:  # insert garbage
        i = rng.randrange(len(b) + 1)
        b[i:i] = rng.randbytes(rng.randrange(1, 17))
    elif op == 3:  # overwrite a run with 0xFF (inflates length prefixes)
        i = rng.randrange(len(b))
        n = min(rng.randrange(1, 9), len(b) - i)
        b[i : i + n] = b"\xff" * n
    else:  # duplicate a slice
        i = rng.randrange(len(b))
        j = min(len(b), i + rng.randrange(1, 33))
        b[i:i] = b[i:j]
    return bytes(b)


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------


def fuzz_codec_roundtrip(rng: random.Random, iterations: int) -> int:
    """Valid objects must round-trip bit-exactly (fuzz.go:15-49 is the
    unmarshal-marshal echo check)."""
    n = 0
    for _ in range(iterations):
        b = _rand_batch(rng)
        data = codec.encode_message_batch(b)
        decoded, off = codec.decode_message_batch(data)
        assert off == len(data)
        again = codec.encode_message_batch(decoded)
        assert again == data, "round-trip mismatch"
        e = _rand_entry(rng)
        de, _ = codec.decode_entry(codec.encode_entry(e))
        assert codec.encode_entry(de) == codec.encode_entry(e)
        ss = _rand_snapshot(rng)
        dss, _ = codec.decode_snapshot(codec.encode_snapshot(ss))
        assert codec.encode_snapshot(dss) == codec.encode_snapshot(ss)
        n += 1
    return n


def fuzz_codec_mutations(rng: random.Random, iterations: int) -> int:
    """Corrupt encodings must decode-or-raise-CodecError, never crash or
    allocate unboundedly."""
    seeds = [codec.encode_message_batch(_rand_batch(rng)) for _ in range(32)]
    seeds += [codec.encode_snapshot(_rand_snapshot(rng)) for _ in range(16)]
    seeds += [codec.encode_entries([_rand_entry(rng) for _ in range(3)])]
    n = 0
    for _ in range(iterations):
        data = _mutate(rng, rng.choice(seeds))
        for dec in (
            codec.decode_message_batch,
            codec.decode_snapshot,
            codec.decode_entries,
            codec.decode_message,
            codec.decode_entry,
        ):
            try:
                dec(data)
            except ALLOWED_ERRORS:
                pass
            n += 1
    return n


def fuzz_tcp_frames(rng: random.Random, iterations: int) -> int:
    """Mutated frames through the real framed-socket decoder
    (cf. internal/transport/fuzz.go:68-77): FrameError or success."""
    import socket

    from .transport import tcp

    payloads = [codec.encode_message_batch(_rand_batch(rng)) for _ in range(8)]
    n = 0
    for _ in range(iterations):
        a, b = socket.socketpair()
        try:
            a.settimeout(2.0)
            b.settimeout(2.0)
            raw_payload = rng.choice(payloads)
            import struct
            import zlib

            hdr = tcp._HDR.pack(
                tcp.RAFT_TYPE, len(raw_payload), zlib.crc32(raw_payload), 0
            )
            hcrc = zlib.crc32(hdr[: tcp._HDR.size - 4])
            frame = (
                tcp.MAGIC
                + hdr[: tcp._HDR.size - 4]
                + struct.pack("<I", hcrc)
                + raw_payload
            )
            frame = _mutate(rng, frame)
            a.sendall(frame)
            a.shutdown(socket.SHUT_WR)
            try:
                method, payload = tcp._read_frame(b, max_size=1 << 24)
                if method == tcp.RAFT_TYPE:
                    try:
                        codec.decode_message_batch(payload)
                    except ALLOWED_ERRORS:
                        pass
            except (tcp.FrameError, socket.timeout, OSError):
                pass
        finally:
            a.close()
            b.close()
        n += 1
    return n


def fuzz_wal_recovery(rng: random.Random, iterations: int, tmpdir: str) -> int:
    """Mutated/truncated WAL tails must recover to the last intact record
    group: write N batches through a real WalKV, corrupt the tail region
    of wal.log, reopen, and require the recovered table to equal the state
    after some prefix of the committed batches (group atomicity: never a
    half-applied batch, never corrupt records accepted as data)."""
    import os
    import shutil

    from .storage.kv import WalKV, WriteBatch

    n = 0
    for it in range(iterations):
        d = os.path.join(tmpdir, f"walfuzz-{it}")
        shutil.rmtree(d, ignore_errors=True)
        kv = WalKV(d, fsync=False)
        # prefix states: state[k] = table contents after batch k
        state: dict = {}
        prefixes = [dict(state)]
        boundaries = [0]  # wal.log size at each group boundary
        path = os.path.join(d, "wal.log")
        for b in range(rng.randrange(2, 6)):
            wb = WriteBatch()
            for _ in range(rng.randrange(1, 5)):
                k = b"k%d" % rng.randrange(8)
                if rng.random() < 0.8:
                    v = _rand_bytes(rng, 24)
                    wb.put(k, v)
                    state[k] = v
                else:
                    wb.delete(k)
                    state.pop(k, None)
            kv.commit_write_batch(wb)
            prefixes.append(dict(state))
            kv._f.flush()
            boundaries.append(os.path.getsize(path))
        kv.close()
        # corrupt the TAIL: any byte range overlapping the last one or two
        # record groups (mid-file corruption truncates earlier — still a
        # prefix — but tail faults are the crash-consistency contract)
        data = bytearray(open(path, "rb").read())
        tail_from = boundaries[-3] if len(boundaries) > 2 else 0
        tail = bytes(data[tail_from:])
        mutated = _mutate(rng, tail)
        with open(path, "wb") as f:
            f.write(bytes(data[:tail_from]) + mutated)
        kv2 = WalKV(d)
        got: dict = {}
        kv2.iterate_value(
            b"", b"\xff" * 8, True, lambda k, v: (got.update({k: v}), True)[1]
        )
        kv2.close()
        assert any(got == p for p in prefixes), (
            f"WAL recovery produced a non-prefix state: {got!r} not in "
            f"{prefixes!r}"
        )
        shutil.rmtree(d, ignore_errors=True)
        n += 1
    return n


def fuzz_wal_garbage(rng: random.Random, iterations: int) -> int:
    """Arbitrary byte soup through the record-group decoder: must return
    a (possibly empty) WriteBatch, never crash or allocate unboundedly."""
    from .storage.kv import _decode_records

    n = 0
    for _ in range(iterations):
        _decode_records(rng.randbytes(rng.randrange(0, 512)))
        n += 1
    return n


def run(seconds: float = 10.0, seed: int = 0) -> dict:
    import tempfile

    rng = random.Random(seed or int(time.time()))
    deadline = time.monotonic() + seconds
    stats = {"roundtrip": 0, "mutations": 0, "frames": 0, "wal": 0, "wal_garbage": 0}
    with tempfile.TemporaryDirectory(prefix="walfuzz-") as td:
        while time.monotonic() < deadline:
            stats["roundtrip"] += fuzz_codec_roundtrip(rng, 20)
            stats["mutations"] += fuzz_codec_mutations(rng, 50)
            stats["frames"] += fuzz_tcp_frames(rng, 10)
            stats["wal"] += fuzz_wal_recovery(rng, 5, td)
            stats["wal_garbage"] += fuzz_wal_garbage(rng, 50)
    return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    stats = run(args.seconds, args.seed)
    print(f"fuzz clean: {stats}")


if __name__ == "__main__":
    main()
