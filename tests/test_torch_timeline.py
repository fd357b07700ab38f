"""Twin of test_timeline.py for the port's `tools.timeline`: the same
checked-in two-node fixture dumps (tests/data/timeline_node*.jsonl, raw
monotonic clocks 4.5 s apart) through both packages' merge, filters,
chains and CLI — equal events and equal output — and the reference's
assertions on the port's."""
import contextlib
import io
import json
import os

from dragonboat_tpu.tools import timeline as REF
from dragonboat_tpu_torch.tools import timeline

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
N1 = os.path.join(DATA, "timeline_node1.jsonl")
N2 = os.path.join(DATA, "timeline_node2.jsonl")
TRACE = 0x0123456789ABCDEF


def test_merge_negotiates_clock_offsets():
    merged = timeline.merge_dumps([N1, N2])
    assert merged == REF.merge_dumps([N1, N2])
    assert [e["event"] for e in merged] == [
        "leader_changed", "partition_window", "propose_enqueue",
        "replicate_send", "replicate_recv", "replicate_ack",
        "quorum_commit", "proposal_applied",
    ]
    raw = sorted(merged, key=lambda e: e["t"])
    assert [e["event"] for e in raw] != [e["event"] for e in merged]
    assert {e["_src"] for e in merged} == {"n1", "n2"}


def test_filters_and_chains():
    merged = timeline.merge_dumps([N1, N2])
    only_group = timeline.filter_events(merged, cluster=2)
    assert only_group == REF.filter_events(merged, cluster=2)
    assert all(e["cluster"] == 2 for e in only_group)
    assert len(only_group) == len(merged) - 1
    by_kind = timeline.filter_events(merged, kinds={"replicate_recv"})
    assert len(by_kind) == 1 and by_kind[0]["node"] == 2
    chains = timeline.causal_chains(merged)
    assert chains == REF.causal_chains(merged)
    assert set(chains) == {TRACE}
    assert [e["event"] for e in chains[TRACE]] == [
        "propose_enqueue", "replicate_send", "replicate_recv",
        "replicate_ack", "quorum_commit", "proposal_applied",
    ]
    assert {e["node"] for e in chains[TRACE]} == {1, 2}


def _run(mod, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(args)
    return rc, buf.getvalue()


def _run_cli(args):
    """The port's CLI; its exit code and output equal the reference's."""
    out = _run(timeline, args)
    assert out == _run(REF, args)
    return out


def test_cli_smoke_over_fixture_dump():
    rc, out = _run_cli([N1, N2])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 8
    assert lines[0].startswith("+") and "[n1] leader_changed" in lines[0]
    assert "replicate_recv" in out and "[n2]" in out
    rc, out = _run_cli([N1, N2, "--chains"])
    assert rc == 0 and f"trace {TRACE:#x}" in out and "nodes [1, 2]" in out
    assert out.index("propose_enqueue") < out.index("quorum_commit")
    rc, out = _run_cli([N1, N2, "--trace", hex(TRACE), "--event", "quorum_commit", "--json"])
    rows = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert rc == 0 and len(rows) == 1
    assert rows[0]["event"] == "quorum_commit" and rows[0]["trace"] == TRACE
    rc, out = _run_cli([N1, "--cluster", "2", "--event", "nonexistent"])
    assert rc == 0 and "(no events)" in out
    assert _run_cli([N1, N2, "--spans"])[0] == 0
    assert _run_cli(["--sweep", DATA, "--json"])[0] == 0


def test_cli_handles_torn_tail_lines(tmp_path):
    p = tmp_path / "torn.jsonl"
    with open(N1) as f:
        content = f.read()
    p.write_text(content + '{"t": 9.9, "event": "trunc')
    merged = timeline.merge_dumps([str(p)])
    assert merged == REF.merge_dumps([str(p)])
    assert len(merged) == 5
