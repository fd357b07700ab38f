"""Twin of tests/test_forensics.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): trace ids on the wire, the recorder's filters and
its mandatory cluster field, the mmap flight ring (wrap-around, torn and
unsealed slots, oversized events, rotation of a crashed ring), a scalar
NodeHost in a child process SIGKILLed mid-chaos whose ring is recovered,
and the causal chain of one sampled proposal across the nodes of a shared
vector core under a seeded partition schedule, merged and rendered by
`tools.timeline`, at the reference's ticks.

`test_session_ring_covers_timeout_kills` skips here, as the reference's own
test does without a session ring: tests/conftest.py attaches its session
ring to the reference's flight recorder only, and the port's recorder has
none. Like the conftest does for the reference's, `fresh_port_recorder`
empties the port's process-wide recorder before each test.

`test_causal_chain_matches_reference` runs the causal-chain body through
both packages at its seed (1789) and holds equal the partition schedule
that each body applied and the verdict: a chain with `propose_enqueue`,
`replicate_send`, `quorum_commit` and `proposal_applied` in that order
across at least two nodes. The tests after it hold both packages equal on
what a forensic run exchanges: partition schedules of several seeds, trace
ids on the wire (byte-equal encodings), crash rings read across packages,
and tools.timeline's merge and chains of the same dumps."""
import importlib
import json

import numpy as np
import pytest

from dragonboat_tpu_torch.trace import flight_recorder
from torch_twin import one_thread, port_copy, recording, reference_tests  # noqa: F401

R = port_copy("test_forensics")
globals().update(reference_tests(R))

NEED = ("propose_enqueue", "replicate_send", "quorum_commit", "proposal_applied")


@pytest.fixture(autouse=True)
def fresh_port_recorder():
    flight_recorder().reset()


def _ref():
    return importlib.import_module("test_forensics")


def ordered_chain(chains):
    """Whether some chain holds NEED in order across two nodes or more."""
    for evs in chains.values():
        stages = [e["event"] for e in evs]
        if all(s in stages for s in NEED) and len({e.get("node") for e in evs}) >= 2:
            pos = [stages.index(s) for s in NEED]
            if pos == sorted(pos):
                return True
    return False


def causal_run(M, root):
    """`M`'s causal-chain body: the partition windows it applied (victim,
    window) and whether its merged dumps held an ordered chain."""
    rec = M.flight_recorder()
    rec.reset()
    with recording(M.timeline, ["causal_chains"]) as got:
        M.test_e2e_causal_chain_across_nodes_under_partition(root)
    windows = [(e["victim"], e["window_s"]) for e in rec.dump(event="partition_window")]
    return windows, ordered_chain(got["causal_chains"][0])


def planned(pkg):
    faults = importlib.import_module(pkg + ".faults")
    fp = faults.FaultPlane(1789, faults.FaultSpec())
    return [(v, round(w, 4)) for v, w, _idle in fp.partition_schedule(
        "causal", (1, 2, 3), total_s=1.2, min_window_s=0.1, max_window_s=0.3)]


def test_causal_chain_matches_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("CHAOS_SEED", raising=False)
    ref = causal_run(_ref(), tmp_path / "ref")
    port = causal_run(R, tmp_path / "port")
    assert planned("dragonboat_tpu_torch") == planned("dragonboat_tpu")
    assert port[0] == ref[0] == planned("dragonboat_tpu_torch") and len(port[0]) >= 2
    assert port[1] == ref[1] is True


def _both(name):
    return (importlib.import_module("dragonboat_tpu." + name),
            importlib.import_module("dragonboat_tpu_torch." + name))


@pytest.mark.parametrize("seed", [1789, 1, 2, 3, 4, 5])
def test_partition_schedule_matches_reference(seed):
    ref, port = (m.FaultPlane(seed, m.FaultSpec()) for m in _both("faults"))
    draw = lambda fp: list(fp.partition_schedule("causal", (1, 2, 3), total_s=1.2,
                                                 min_window_s=0.1, max_window_s=0.3))
    assert draw(port) == draw(ref)


def _traced(pkg, rng):
    """Seeded entries and a REPLICATE message of `pkg`'s types, some
    entries trace-stamped."""
    T = importlib.import_module(pkg + ".types")
    entries = [T.Entry(term=int(rng.integers(1, 9)), index=i + 1,
                       cmd=bytes(rng.integers(0, 256, int(rng.integers(0, 24))).tolist()),
                       trace_id=int(rng.integers(1, 2**63)) if rng.random() < 0.5 else 0)
               for i in range(int(rng.integers(1, 6)))]
    return T.Message(type=T.MessageType.REPLICATE, cluster_id=int(rng.integers(1, 99)), to=2,
                     from_=1, term=int(rng.integers(1, 9)), log_index=int(rng.integers(0, 50)),
                     commit=int(rng.integers(0, 50)), trace_id=int(rng.integers(0, 2**63)),
                     entries=entries)


@pytest.mark.parametrize("seed", range(8))
def test_trace_ids_on_the_wire_match_reference(seed):
    ref, port = _both("codec")
    m_ref = _traced("dragonboat_tpu", np.random.default_rng(seed))
    m_port = _traced("dragonboat_tpu_torch", np.random.default_rng(seed))
    wire = ref.encode_message(m_ref)
    assert port.encode_message(m_port) == wire
    got, _ = port.decode_message(wire)
    assert got.trace_id == m_ref.trace_id
    assert [e.trace_id for e in got.entries] == [e.trace_id for e in m_ref.entries]
    assert [port.encode_entry(e) for e in got.entries] == [ref.encode_entry(e)
                                                           for e in m_ref.entries]


@pytest.mark.parametrize("count", [5, 11])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mmap_ring_readable_across_packages(tmp_path, writer, count):
    """A crash ring one package wrote (8 slots; 11 events wrap) reads the
    same through either package's reader."""
    ref, port = _both("trace")
    path = str(tmp_path / "x.ring")
    ring = (ref if writer == "reference" else port).MmapRing(path, capacity=8, slot_size=256)
    for i in range(count):
        ring.write(json.dumps({"t": i / 10, "event": "e", "i": i, "cluster": 0}).encode())
    ring.close()
    (_m1, a), (_m2, b) = ref.read_mmap_ring(path), port.read_mmap_ring(path)
    assert b == a and [e["i"] for e in b] == list(range(max(0, count - 8), count))


@pytest.mark.parametrize("seed", range(4))
def test_causal_chains_match_reference(tmp_path, seed):
    """Per-node dumps of seeded trace-stamped events (stages in random
    order and nodes, two clocks) merge and chain alike in both
    packages' tools.timeline."""
    rng = np.random.default_rng(seed)
    stages = list(NEED) + ["replicate_recv", "leader_changed"]
    paths = []
    for node in (1, 2, 3):
        p = tmp_path / f"n{node}.jsonl"
        lines = [{"event": "_meta", "mono_offset": 1000.0 + node, "source": f"n{node}"}]
        for _ in range(int(rng.integers(4, 12))):
            lines.append({"t": float(rng.random() * 5), "event": str(rng.choice(stages)),
                          "node": node, "cluster": 2,
                          "trace": int(rng.choice([0, 11, 12, 13]))})
        p.write_text("\n".join(json.dumps(x, sort_keys=True) for x in lines) + "\n")
        paths.append(str(p))
    ref, port = _both("tools.timeline")
    merged = port.merge_dumps(paths)
    assert merged == ref.merge_dumps(paths)
    assert port.causal_chains(merged) == ref.causal_chains(ref.merge_dumps(paths))
