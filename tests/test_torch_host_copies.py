"""The port keeps its own copies of the JAX package's host modules (types,
codec, settings, raftio, the scalar core, storage, transport, rsm, engine
host pieces, lincheck, the fault plane, the fuzzer, the serving plane,
the operator tools that read no port-specific surface, the analyzer's
call graph, the native WAL store's binding and the C++ state machine
loader):
they must agree with the reference. The port's
codec encodes seeded message batches, entries, snapshots, chunks and
bootstrap records to exactly the reference's bytes, and each decodes the
other's; the enum and constant tables are equal; and no copied module's
source mentions jax."""
import enum
import importlib
import os
import random

import pytest

import dragonboat_tpu_torch

PORT = os.path.dirname(dragonboat_tpu_torch.__file__)
REF = os.path.join(os.path.dirname(PORT), "dragonboat_tpu")

# the modules copied from the reference (the port's own modules, which
# have real changes, are not listed: config, profile, nodehost, the
# engine's vector.py, ops/*, e2e, kernel_bench)
COPIED = (
    "types", "settings", "logger", "raftio", "codec", "client",
    "statemachine", "trace", "events", "requests", "lincheck",
    "core.rate", "core.logentry", "core.peer", "core.remote",
    "core.readindex", "core.raft",
    "rsm.encoded", "rsm.session", "rsm.membership", "rsm.managed",
    "rsm.snapshotio", "rsm.manager", "rsm",
    "storage.keys", "storage.kv", "storage.sqlite_kv", "storage.logdb",
    "storage.logreader", "storage.native_kv", "storage", "cpp_sm",
    "transport.nodes", "transport.loopback", "transport.tcp",
    "transport.chunks", "transport.snapshotstream", "transport.transport",
    "transport",
    "engine.queue", "engine.quiesce", "engine.fairness",
    "engine.snapshotstate", "engine.snapshotter", "engine.node",
    "engine.execengine", "engine",
    "faults", "fuzz",
    "serving.retry", "serving.admission", "serving.backpressure", "serving.front",
    "serving.sessions", "serving.placement", "serving.storm", "serving",
    "tools.checkdisk", "tools.logdbcheck", "tools.importer", "tools",
    "analysis.callgraph",
)


def pair(name):
    return (importlib.import_module("dragonboat_tpu." + name),
            importlib.import_module("dragonboat_tpu_torch." + name))


def source_path(root, name):
    p = os.path.join(root, *name.split("."))
    return p + "/__init__.py" if os.path.isdir(p) else p + ".py"


@pytest.mark.parametrize("name", COPIED)
def test_copy_never_mentions_jax(name):
    with open(source_path(PORT, name)) as f:
        src = f.read()
    assert "jax" not in src.lower(), name


# Faults of the reference repaired in a copy (ROADMAP §3 fault 9): for each
# module, the spans of code whose tokens differ, as (the reference's code,
# the port's code). Each reference span occurs once in the reference; with
# it replaced by the port's span, every token of the copy is the
# reference's.
REPAIRED = {
    # a snapshot worker's recovery moved the log window back to the
    # installed snapshot over entries the step thread had appended since
    "engine.node": [(
        """
with self._mu:
    self.log_reader.apply_snapshot(ss)
    self.peer.restore_remotes(ss)
""", """
with self._mu:
    self.peer.restore_remotes(ss)
""")],
    # the task worker applied entries queued behind an installed snapshot
    # while the snapshot worker recovered from it, and the recovery
    # overwrote them
    "engine.execengine": [(
        """
if node is None or node.stopped:
    continue
if not node.sm.loaded(OffloadFrom.COMMIT_WORKER):
""", """
if node is None or node.stopped:
    continue
if node.ss.recovering_from_snapshot():
    continue
if not node.sm.loaded(OffloadFrom.COMMIT_WORKER):
""")],
}


def _code_tokens(src):
    import io
    import tokenize

    toks = tokenize.generate_tokens(io.StringIO(src).readline)
    out, prev = [], None
    for t in toks:
        if t.type in (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
                      tokenize.INDENT, tokenize.DEDENT, tokenize.ENDMARKER):
            prev = t.type if t.type != tokenize.COMMENT else prev
            continue
        # a string standing alone as a statement is a docstring
        if t.type == tokenize.STRING and prev in (
                None, tokenize.NEWLINE, tokenize.INDENT, tokenize.DEDENT):
            prev = tokenize.NEWLINE
            continue
        out.append(t.string)
        prev = t.type
    return out


def _file_tokens(path):
    with open(path) as f:
        return _code_tokens(f.read())


def _find(toks, span):
    """The offsets where the token list `span` occurs in `toks`."""
    n = len(span)
    return [i for i in range(len(toks) - n + 1) if toks[i:i + n] == span]


@pytest.mark.parametrize("name", COPIED)
def test_copy_keeps_the_reference_code(name):
    """Only comment and docstring text may differ: the code tokens of each
    copy are the reference's, token for token, but for the spans REPAIRED
    names."""
    ref = _file_tokens(source_path(REF, name))
    for ref_src, port_src in REPAIRED.get(name, ()):
        span = _code_tokens(ref_src)
        at = _find(ref, span)
        assert len(at) == 1, (name, ref_src, at)
        ref = ref[:at[0]] + _code_tokens(port_src) + ref[at[0] + len(span):]
    assert _file_tokens(source_path(PORT, name)) == ref


@pytest.mark.parametrize("name", sorted(REPAIRED))
def test_repaired_spans_are_the_only_difference(name):
    """Each repaired span is a real difference: the reference's span is
    not in the copy, and the copy's span is not in the reference."""
    ref, port = _file_tokens(source_path(REF, name)), _file_tokens(source_path(PORT, name))
    assert ref != port
    for ref_src, port_src in REPAIRED[name]:
        assert not _find(port, _code_tokens(ref_src)), name
        assert not _find(ref, _code_tokens(port_src)), name


# drawn at random per process (trace-id salt), not a table; a path from
# each package's own directory (both name the repository's native/,
# test_native_copies_share_one_library)
PER_PROCESS = {"_TRACE_SALT", "_NATIVE_DIR"}


def _in_package(v):
    """A class of either package by its module path inside the package
    (a constant tuple of exception classes names the package's own)."""
    if isinstance(v, type) and v.__module__.startswith("dragonboat_tpu"):
        return (v.__module__.split(".", 1)[-1], v.__qualname__)
    return v


def enums_and_constants(mod):
    out = {}
    for k, v in vars(mod).items():
        if k in PER_PROCESS:
            continue
        if isinstance(v, type) and issubclass(v, enum.Enum) and v.__module__ == mod.__name__:
            out[k] = [(m.name, m.value) for m in v]
        elif k.isupper() and isinstance(v, tuple):
            out[k] = tuple(_in_package(x) for x in v)
        elif k.isupper() and isinstance(v, (int, str, bytes, float, frozenset)):
            out[k] = v
    return out


@pytest.mark.parametrize("name", COPIED)
def test_enum_and_constant_tables_equal(name):
    ref, port = pair(name)
    assert enums_and_constants(port) == enums_and_constants(ref)


def seeded_batch(T, rng):
    """A MessageBatch of every message type, with entries, config-change
    entries, a snapshot with membership and files, built from rng."""
    def entry(i):
        return T.Entry(
            type=rng.choice(list(T.EntryType)), term=rng.randrange(1, 9),
            index=i, key=rng.randrange(2**32), client_id=rng.randrange(2**64),
            series_id=rng.randrange(2**64), responded_to=rng.randrange(2**16),
            cmd=rng.randbytes(rng.randrange(0, 40)), trace_id=rng.randrange(2**64))

    def snapshot():
        m = T.Membership(
            config_change_id=rng.randrange(99),
            addresses={rng.randrange(1, 9): f"h{j}:{rng.randrange(9999)}" for j in range(3)},
            removed={rng.randrange(9, 20): True},
            observers={rng.randrange(20, 30): "obs:1"},
            witnesses={rng.randrange(30, 40): "wit:1"})
        return T.Snapshot(
            filepath=f"/snap/{rng.randrange(999)}", file_size=rng.randrange(2**40),
            index=rng.randrange(2**32), term=rng.randrange(99), membership=m,
            files=[T.SnapshotFile(filepath=f"f{j}", file_size=rng.randrange(999),
                                  file_id=j, metadata=rng.randbytes(5)) for j in range(2)],
            checksum=rng.randbytes(8), dummy=rng.random() < 0.5,
            cluster_id=rng.randrange(2**32), type=rng.randrange(3),
            imported=rng.random() < 0.5, on_disk_index=rng.randrange(99),
            witness=rng.random() < 0.5)

    msgs = []
    for mt in T.MessageType:
        base = rng.randrange(1, 1000)
        msgs.append(T.Message(
            type=mt, to=rng.randrange(1, 9), from_=rng.randrange(1, 9),
            cluster_id=rng.randrange(2**32), term=rng.randrange(99),
            log_term=rng.randrange(99), log_index=rng.randrange(2**40),
            commit=rng.randrange(2**40), reject=rng.random() < 0.5,
            hint=rng.randrange(2**64), hint_high=rng.randrange(2**64),
            trace_id=rng.randrange(2**64),
            entries=[entry(base + j) for j in range(rng.randrange(0, 4))],
            snapshot=snapshot() if rng.random() < 0.3 else None))
    return T.MessageBatch(requests=msgs, deployment_id=rng.randrange(2**64),
                          source_address=f"src:{rng.randrange(9999)}",
                          bin_ver=rng.randrange(2**32))


@pytest.mark.parametrize("seed", range(6))
def test_codec_bytes_equal(seed):
    (Tr, Tp), (Cr, Cp) = pair("types"), pair("codec")
    ref = Cr.encode_message_batch(seeded_batch(Tr, random.Random(seed)))
    port = Cp.encode_message_batch(seeded_batch(Tp, random.Random(seed)))
    assert port == ref
    # each decodes the other's bytes back to the same encoding
    assert Cr.encode_message_batch(Cr.decode_message_batch(port)[0]) == ref
    assert Cp.encode_message_batch(Cp.decode_message_batch(ref)[0]) == port


@pytest.mark.parametrize("seed", range(3))
def test_codec_records_equal(seed):
    (Tr, Tp), (Cr, Cp) = pair("types"), pair("codec")
    br = seeded_batch(Tr, random.Random(seed))
    bp = seeded_batch(Tp, random.Random(seed))
    ents_r = [e for m in br.requests for e in m.entries]
    ents_p = [e for m in bp.requests for e in m.entries]
    assert Cp.encode_entries(ents_p) == Cr.encode_entries(ents_r)
    st = dict(term=seed + 3, vote=2, commit=40 + seed)
    assert Cp.encode_state(Tp.State(**st)) == Cr.encode_state(Tr.State(**st))
    snaps = [(r.snapshot, p.snapshot) for r, p in zip(br.requests, bp.requests)
             if r.snapshot is not None]
    for r, p in snaps:
        assert Cp.encode_snapshot(p) == Cr.encode_snapshot(r)
        assert Cp.encode_membership(p.membership) == Cr.encode_membership(r.membership)
    rng = random.Random(seed)
    chunk = dict(cluster_id=rng.randrange(99), node_id=rng.randrange(9),
                 from_=rng.randrange(9), chunk_id=rng.randrange(99),
                 chunk_size=rng.randrange(999), chunk_count=rng.randrange(99),
                 index=rng.randrange(999), term=rng.randrange(9),
                 data=rng.randbytes(33), deployment_id=rng.randrange(2**32))
    assert Cp.encode_chunk(Tp.SnapshotChunk(**chunk)) == Cr.encode_chunk(Tr.SnapshotChunk(**chunk))
    boot = dict(addresses={1: "a:1", 2: "b:2"}, join=bool(seed % 2), type=seed % 3)
    assert Cp.encode_bootstrap(Tp.Bootstrap(**boot)) == Cr.encode_bootstrap(Tr.Bootstrap(**boot))


def test_native_copies_share_one_library():
    """Both packages' native WAL bindings resolve one native/ directory,
    so they build and load one libwalkv.so from one walkv.cc."""
    ref, port = pair("storage.native_kv")
    assert os.path.realpath(port._NATIVE_DIR) == os.path.realpath(ref._NATIVE_DIR)
    assert port._LIB_PATH == ref._LIB_PATH
