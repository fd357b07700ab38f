"""The log-hole family (ROADMAP §3 faults 9 and 11) through both packages on
the CPU (tests/torch_log_hole.py has the recipes).

Fault 9. A follower that a snapshot install brings back moved its log
window to the snapshot twice: on the step thread that installed it, and
again on the snapshot worker that rebuilt the state machine from it. On
the scalar engine, when the step thread had appended entries above the
snapshot in between, the second move dropped them from the window, and
the next append raised `log hole: marker S len 1 appending at S+3`.
Meanwhile the task worker applied the entries queued behind the install
to the state machine that the recovery then overwrote: the replicas
reached one applied index with different state machine hashes. The port
moves the window only where the install is applied (the scalar step
thread, the vector engine's loop through the queued restore), and its
task workers leave a node alone while it recovers from a snapshot.

Fault 11. A member caught up from its leader's host log below a rebased
window could accept, in one step, a run wider than its arena's W-slot
ring: entry i+W displaced entry i before the save wave, which saved
nothing for the lane and still sent the step's acks; the next save raised
a log hole. The port's arena holds a displaced entry until its save (also
where a new leader overwrites a saved suffix), and a run the arena lacks
stops the engine (`VectorEngine.fault`) instead of saving less and acking
it: the requests on its nodes end, and `engine_step_faults` says so."""
import importlib

import pytest

import torch_log_hole as L
from torch_twin import one_thread  # noqa: F401

PORT, REF = "dragonboat_tpu_torch", "dragonboat_tpu"


def _held(r):
    """Every step of the recipe ran: elected, entries committed before and
    after the gate, the logs compacted past the follower, the install
    reached the gate."""
    v = r["verdicts"]
    return all(v[k] for k in ("elected", "first_entries_committed", "fill_committed",
                              "compacted_past_victim", "install_reached_the_gate",
                              "after_entries_committed"))


def test_scalar_install_interleaving_through_both_packages(tmp_path):
    """The follower's step thread appends two entries above the installed
    snapshot before its snapshot worker recovers from it. The port ends
    with the three replicas at one applied index and one state machine
    hash, no log hole, and the window moved to the snapshot once, by the
    step thread. The JAX package moves it again on the snapshot worker,
    back over the appended entries: it raises a log hole if the step
    appends after that move, and its replicas end with different hashes
    if the task worker applied entries behind the install before the
    recovery overwrote them; which of these follow depends on the run."""
    port = L.install_interleaving(PORT, str(tmp_path / "port"), "scalar")
    ref = L.install_interleaving(REF, str(tmp_path / "ref"), "scalar", converge_s=5.0)
    print("reference:", ref["verdicts"], ref["log_holes"][:1], ref["window_moves"])
    for r in (port, ref):
        assert _held(r), r
        assert r["appended_past_install_while_held"] >= 2, r
    assert all(port["verdicts"].values()), port
    assert not L.worker_window_moves(port), port
    # the reference's worker moved the window back over the entries the
    # step thread had appended above the snapshot (what follows depends on
    # the run: a log hole, different hashes, both or neither)
    assert any(m["length"] > 1 for m in L.worker_window_moves(ref)), ref


def test_vector_install_interleaving_through_both_packages(tmp_path):
    """The same recipe on the vector engine, the gate holding the install
    for a second while the leader commits. The engine loop holds a
    recovering lane's traffic, so nothing is appended above the snapshot
    meanwhile, and both packages converge without a log hole; the port
    moves the lane's window on the engine loop (the queued restore), the
    JAX package on the snapshot worker."""
    port = L.install_interleaving(PORT, str(tmp_path / "port"), "vector", device="cpu")
    ref = L.install_interleaving(REF, str(tmp_path / "ref"), "vector")
    print("reference:", ref["verdicts"], ref["window_moves"])
    for r in (port, ref):
        assert _held(r), r
        assert r["verdicts"]["replicas_converged"] and r["verdicts"]["no_log_hole"], r
    assert not L.worker_window_moves(port), port
    moves = [m for m in port["window_moves"] if m["after_gate"]]
    assert moves and all(m["thread"] == "vec-step" for m in moves), port
    assert L.worker_window_moves(ref), ref


def test_rebased_catchup_never_acks_or_saves_past_a_missing_payload(tmp_path, monkeypatch):
    """Fault 11's recipe with the joiner's inbox held while its leaders'
    host-log catch-up streams 32-entry runs to it: one step then accepts
    more entries than the 32-slot window holds. The port saves every
    entry it acks, with no log hole and a caught-up joiner, and counts the
    wide saves it made. The JAX package never starts that catch-up below
    a rebased base (ROADMAP §3 fault 6): its joiners stay at index 0."""
    for pkg in (PORT, REF):
        monkeypatch.setattr(importlib.import_module(pkg + ".engine.vector"),
                            "_REBASE_THRESHOLD", 32)
    port = L.rebased_overflow(PORT, str(tmp_path / "port"), device="cpu")
    ref = L.rebased_overflow(REF, str(tmp_path / "ref"), catch_s=10.0)
    print("port:", port["verdicts"], port["wide_saves"], port["wide_save_notes"][:1])
    print("reference:", ref["verdicts"], ref["joiner_applied"])
    assert all(port["verdicts"].values()), port
    assert port["wide_saves"] > 0 and port["wide_save_notes"], port
    assert port["engine_fault"] is None, port
    assert ref["verdicts"]["every_group_elected"], ref
    assert set(ref["joiner_applied"].values()) == {0}, ref


def _arena_after_overwrite(pkg):
    """A follower's arena (W=32) holds term-1 entries 1..140, saved through
    140 where the package tracks that; a new leader then overwrites the
    suffix from 95 with term-2 entries 95..140 in one step, more than the
    ring's 32 slots. Returns the arena and the run the save asks for."""
    V = importlib.import_module(pkg + ".engine.vector")
    Entry = importlib.import_module(pkg + ".types").Entry
    a = V._Arena(32)
    for i in range(1, 141):
        a[i] = Entry(index=i, term=1, cmd=b"old")
    if hasattr(a, "mark_saved"):
        a.mark_saved(140)
    for i in range(95, 141):
        a[i] = Entry(index=i, term=2, cmd=b"new")
    return a, a.get_run(95, 140)


def test_arena_keeps_an_overwritten_saved_suffix_until_its_save():
    """Entry 95 of the new run shares a slot with 127 and is displaced
    before the save wave. It lies at or below the saved watermark, yet it
    is not saved any more: the port lowers the watermark on the overwrite,
    keeps 95..108 in the spill (the stale 127..140 it displaced leave the
    spill as their new entries are placed), and serves the save all 46 new entries,
    every one of term 2; once marked saved, the spill is emptied. The JAX
    package's ring loses 95 (its save would miss the run)."""
    a, (ents, missing) = _arena_after_overwrite(PORT)
    assert missing == -1 and [e.index for e in ents] == list(range(95, 141))
    assert {e.term for e in ents} == {2} and {e.cmd for e in ents} == {b"new"}
    assert a.saved == 94 and sorted(a.spill) == list(range(95, 109))
    a.mark_saved(140)
    assert a.saved == 140 and not a.spill
    ents, missing = a.get_run(109, 140)
    assert missing == -1 and {e.term for e in ents} == {2}
    _a, (ref_ents, ref_missing) = _arena_after_overwrite(REF)
    assert ref_ents is None and ref_missing == 95


def test_a_save_the_arena_cannot_serve_stops_the_engine_through_both_packages(tmp_path):
    """A follower's arena misses the run its step says to save. The port
    neither saves nor acks that run: its engine stops with the fault
    named (`fault`, the `faults` step stat, the `engine_step_faults`
    gauge at 1), the follower's proposal ends as terminated well before
    its 10 s timeout, and a proposal or a read made after it raises
    ErrClusterClosed at once. The JAX package logs the miss, saves
    nothing of the run and acks it all the same."""
    port = L.save_fault(PORT, str(tmp_path / "port"), device="cpu")
    ref = L.save_fault(REF, str(tmp_path / "ref"))
    print("port:", port)
    print("reference:", ref)
    for r in (port, ref):
        assert all(r["verdicts"].values()), r
    assert not port["acked_missing"] and not port["saved_missing"], port
    assert "missing arena entry" in (port["fault"] or ""), port
    assert port["faults_stat"] == 1, port
    assert [line.split()[-1] for line in port["faults_gauge"]] == ["1"], port
    assert port["proposal"] == "terminated" and port["proposal_s"] < 5.0, port
    assert port["propose_after"] == port["read_after"] == "ErrClusterClosed", port
    assert ref["acked_missing"], ref
    assert ref["fault"] is None, ref
