"""The fuzzer of the PyTorch port against the JAX package's: equal seeds
give equal corpora (generated wire objects, their encodings and their
mutations) and equal decode verdicts in both packages, and the twins of
tests/test_fuzz.py run the port's bounded campaigns (codec round trips
and mutations, TCP frames, WAL recovery and garbage, the hostile-input
corpus; the timed campaign runs standalone via `python -m
dragonboat_tpu_torch.fuzz`)."""
import random

import pytest

import dragonboat_tpu.fuzz as ref_fuzz
import dragonboat_tpu.storage.kv as ref_kv
import dragonboat_tpu_torch.fuzz as port_fuzz
import dragonboat_tpu_torch.storage.kv as port_kv
from dragonboat_tpu_torch import codec
from dragonboat_tpu_torch.fuzz import (
    fuzz_codec_mutations,
    fuzz_codec_roundtrip,
    fuzz_tcp_frames,
    fuzz_wal_garbage,
    fuzz_wal_recovery,
)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_codec_roundtrip_fuzz(seed):
    assert fuzz_codec_roundtrip(random.Random(seed), 200) == 200


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_codec_mutation_fuzz(seed):
    # every decode either succeeds or raises CodecError — anything else
    # propagates and fails the test
    assert fuzz_codec_mutations(random.Random(seed), 400) > 0


def test_tcp_frame_fuzz():
    assert fuzz_tcp_frames(random.Random(21), 60) == 60


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_wal_recovery_fuzz(seed, tmp_path):
    # mutated/truncated WAL tails must recover to the state after some
    # prefix of committed record groups — never crash, never half-apply a
    # batch, never accept a corrupt record (asserted inside the campaign)
    assert fuzz_wal_recovery(random.Random(seed), 25, str(tmp_path)) == 25


def test_wal_garbage_fuzz():
    assert fuzz_wal_garbage(random.Random(41), 300) == 300


def test_wal_group_atomicity_half_written_batch(tmp_path):
    """Regression: a batch whose records landed but whose commit seal is
    missing (crash between flush and the seal reaching disk) must roll
    back WHOLLY — the old per-record replay surfaced half-applied
    batches."""
    import os
    import struct
    import zlib as _zlib

    from dragonboat_tpu_torch.storage.kv import _REC, _OP_PUT, WalKV, WriteBatch

    d = str(tmp_path / "w")
    kv = WalKV(d, fsync=False)
    wb = WriteBatch()
    wb.put(b"committed", b"1")
    kv.commit_write_batch(wb)
    kv.close()
    # append two valid PUT records with NO commit seal (torn group)
    with open(os.path.join(d, "wal.log"), "ab") as f:
        for k, v in ((b"torn1", b"x"), (b"torn2", b"y")):
            rec = _REC.pack(
                _REC.size + len(k) + len(v) + 4, _OP_PUT, len(k), len(v)
            ) + k + v
            f.write(rec + struct.pack("<I", _zlib.crc32(rec)))
    kv2 = WalKV(d)
    assert kv2.get_value(b"committed") == b"1"
    assert kv2.get_value(b"torn1") is None
    assert kv2.get_value(b"torn2") is None
    # reopen truncated the torn tail, so a NEW batch's seal must not
    # resurrect the rolled-back records on the next replay
    wb2 = WriteBatch()
    wb2.put(b"after", b"2")
    kv2.commit_write_batch(wb2)
    kv2.close()
    kv3 = WalKV(d)
    assert kv3.get_value(b"after") == b"2"
    assert kv3.get_value(b"committed") == b"1"
    assert kv3.get_value(b"torn1") is None, "torn batch resurrected"
    assert kv3.get_value(b"torn2") is None, "torn batch resurrected"
    kv3.close()


def test_known_hostile_inputs():
    """Regression corpus: shapes that used to crash or hang the decoders
    before the bounds hardening."""
    # count field of 0xFFFFFFFF: would loop ~4e9 times building entries
    hostile = b"\xff\xff\xff\xff" + b"\x00" * 16
    with pytest.raises(codec.CodecError):
        codec.decode_entries(hostile)
    # entry cmd length beyond the buffer: used to silently return a SHORT
    # cmd instead of failing
    import struct

    ent = codec.encode_entry
    from dragonboat_tpu_torch.types import Entry

    data = bytearray(ent(Entry(cmd=b"abcd")))
    struct.pack_into("<I", data, codec._ENTRY.size - 4, 1 << 30)
    with pytest.raises(codec.CodecError):
        codec.decode_entry(bytes(data))
    # truncated struct header
    with pytest.raises(codec.CodecError):
        codec.decode_message(b"\x01\x02")
    # bad enum value for message type
    from dragonboat_tpu_torch.types import Message, MessageType

    bad = bytearray(codec.encode_message(Message(type=MessageType.HEARTBEAT)))
    bad[0] = 250
    with pytest.raises(codec.CodecError):
        codec.decode_message(bytes(bad))


# ------------------------------------------- the two packages, exactly equal
def _verdict(dec, data, allowed):
    try:
        out = dec(data)
    except allowed as e:
        return ("refused", type(e).__name__, str(e))
    return ("decoded", repr(out[1]) if isinstance(out, tuple) else repr(type(out).__name__))


def _corpus(F, seed, n=60):
    """The generated objects' encodings, their mutations and what every
    decoder makes of each mutation."""
    rng = random.Random(seed)
    C = F.codec
    out = []
    for _ in range(n):
        data = C.encode_message_batch(F._rand_batch(rng))
        snap = C.encode_snapshot(F._rand_snapshot(rng))
        ents = C.encode_entries([F._rand_entry(rng) for _ in range(3)])
        for raw in (data, snap, ents):
            bad = F._mutate(rng, raw)
            out.append((raw, bad, [
                _verdict(dec, bad, F.ALLOWED_ERRORS) for dec in (
                    C.decode_message_batch, C.decode_snapshot, C.decode_entries,
                    C.decode_message, C.decode_entry)]))
    return out


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_corpora_and_verdicts_equal_across_packages(seed):
    ref, port = _corpus(ref_fuzz, seed), _corpus(port_fuzz, seed)
    assert port == ref
    assert any(v[0] == "refused" for _, _, vs in ref for v in vs)


def test_wal_garbage_decode_equal_across_packages():
    """Byte soup through both record-group decoders: the same records."""
    def run(KV):
        rng = random.Random(41)
        out = []
        for _ in range(300):
            wb, sealed = KV._decode_records(rng.randbytes(rng.randrange(0, 512)))
            out.append((wb.ops, sealed))
        return out

    assert run(port_kv) == run(ref_kv)
