"""Twin of tests/test_compression.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the payload codec's round trip and its plain,
tiny, incompressible and config-change cases, and a compressed proposal
through the vector engine, the log and a restart's replay.

The tests below hold the codec's bytes across packages, each decoding what
the other encoded, and run the end-to-end body through both packages'
NodeHosts with the compressed entries each left in its durable log held
equal."""
import importlib

import pytest

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_compression")
globals().update(reference_tests(R))

PKGS = ("dragonboat_tpu", "dragonboat_tpu_torch")


def codec(pkg):
    E = importlib.import_module(pkg + ".rsm.encoded")
    T = importlib.import_module(pkg + ".types")
    return E, T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_payload_bytes_decode_across_packages(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    payloads = [bytes(rng.integers(0, 4, n, dtype=np.uint8)) for n in (7, 300, 4096)]
    payloads += [b"the quick brown fox " * int(rng.integers(1, 200)),
                 bytes(rng.integers(0, 256, 2048, dtype=np.uint8))]
    for a, b in (PKGS, PKGS[::-1]):
        Ea, Ta = codec(a)
        Eb, Tb = codec(b)
        for data in payloads:
            for ct in (Ta.CompressionType.SNAPPY, Ta.CompressionType.NO_COMPRESSION):
                e = Ea.maybe_encode_entry(ct, Ta.Entry(index=3, term=2, cmd=data))
                f = Eb.maybe_encode_entry(Tb.CompressionType(int(ct)),
                                          Tb.Entry(index=3, term=2, cmd=data))
                assert (int(e.type), e.cmd) == (int(f.type), f.cmd)
                # each package decodes what the other encoded
                got = Eb.decode_payload(Tb.Entry(type=Tb.EntryType(int(e.type)), cmd=e.cmd))
                assert got == data


def stored_entries(M, pkg, path):
    DB = importlib.import_module(pkg + ".storage.logdb").ShardedLogDB
    with calls(DB, ("iterate_entries",)) as got:
        M.test_e2e_compressed_propose_apply_and_restart(path)
    return [[(e.index, e.term, int(e.type), e.cmd) for e in ents] for _n, (ents, _s) in got]


def test_durable_log_matches_reference(tmp_path):
    ref = stored_entries(importlib.import_module("test_compression"), "dragonboat_tpu",
                         tmp_path / "ref")
    port = stored_entries(R, "dragonboat_tpu_torch", tmp_path / "port")
    assert port and any(len(c) < 1216 for ents in port for *_h, c in ents)
    assert port == ref
