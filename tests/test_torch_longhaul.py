"""The port's long-haul runner (`dragonboat_tpu_torch.tools.longhaul`, a
copy of the reference's with a `device` option) on the CPU: the reference's
bounded smoke profile (tests/test_longhaul.py) on the port, under the
`longhaul` marker. The scalar engine runs where the reference's does; the
vector and sharded smoke run the port's vector engine with device="cpu",
and the replay line also names the device when it is not the card.

Beside them (tests/test_torch_longhaul_cross.py): the same seeded rounds
through both packages give the same orchestration schedule, and chip_smoke
phase 8's card rounds are pinned to the reference's signatures.
"""
import json
import os
import subprocess
import sys

import pytest

from dragonboat_tpu_torch.analysis import RULES_VERSION
from dragonboat_tpu_torch.tools.longhaul import Options, run_longhaul
from dragonboat_tpu_torch.tools.timeline import merge_dumps, sweep_artifacts

pytestmark = pytest.mark.longhaul


@pytest.fixture(autouse=True)
def _one_thread():
    """Four hosts' engines share this process: one torch thread each
    step keeps their loops from starving each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_longhaul_smoke_multi_round(tmp_path, capsys):
    report = run_longhaul(
        Options(
            budget_s=25.0,
            rounds_max=2,
            round_s=4.0,
            engine="scalar",
            out_dir=str(tmp_path / "run"),
            seed=0xD0C5,
            rotate=True,
            ring=False,  # the pytest session owns the process ring
        )
    )
    assert report["ok"], [r.verdicts for r in report["rounds"]]
    assert len(report["rounds"]) >= 1
    for r in report["rounds"]:
        assert r.ok and r.verdicts["lincheck"]
        assert r.verdicts["fairness_no_stall"]
        assert r.signature  # schedule signature printed per round
    out = capsys.readouterr().out
    assert "round 1 seed=0x" in out and "verdict=OK" in out
    # seed rotation: the two rounds must not share a seed
    if len(report["rounds"]) == 2:
        assert report["rounds"][0].seed != report["rounds"][1].seed


def test_longhaul_failure_bundle_sweeps_rings_and_prints_replay(
    tmp_path, capsys
):
    """Injected failure -> artifact bundle with the swept crash ring
    merged in + a replay command that names the exact seed."""
    from dragonboat_tpu_torch.trace import MmapRing

    out_dir = str(tmp_path / "run")
    seed = 0xF00D
    # plant a crash ring where a SIGKILL'd co-process would have left
    # one: the sweep must pick it up without manual collection
    round_dir = os.path.join(out_dir, f"round-001-seed-0x{seed:X}")
    os.makedirs(round_dir, exist_ok=True)
    ring = MmapRing(os.path.join(round_dir, "crashed.ring"))
    ring.write(
        json.dumps(
            {"t": 1.0, "event": "planted_marker", "cluster": 0}
        ).encode()
    )
    ring.close()
    report = run_longhaul(
        Options(
            budget_s=20.0,
            rounds_max=1,
            round_s=3.0,
            engine="scalar",
            out_dir=out_dir,
            seed=seed,
            ring=False,
            inject_failure=True,
            reuse_out=True,  # the planted ring must survive the guard
            triage=False,  # the triage replay has its own test
        )
    )
    assert not report["ok"]
    r = report["rounds"][0]
    assert r.bundle and os.path.isdir(r.bundle)
    manifest = json.load(open(os.path.join(r.bundle, "manifest.json")))
    assert manifest["verdicts"]["injected_failure"] is False
    assert any(p.endswith("crashed.ring") for p in manifest["swept_artifacts"])
    # the bundle carries the telemetry history ring + doctor diagnosis
    from dragonboat_tpu_torch.profile import read_history

    _meta, samples = read_history(os.path.join(r.bundle, "history.ring"))
    assert samples and all(s["event"] == "history_sample" for s in samples)
    diag = json.load(open(os.path.join(r.bundle, "diagnosis.json")))
    assert diag["schema"] == 1 and diag["samples"] == len(samples)
    kinds = [v["kind"] for v in diag["verdicts"]]
    assert kinds, diag
    assert r.diagnosis == kinds[0]
    assert manifest["doctor_verdict"] == kinds[0]
    merged = os.path.join(r.bundle, "merged_timeline.jsonl")
    events = [json.loads(ln) for ln in open(merged)]
    assert any(e.get("event") == "planted_marker" for e in events)
    assert any(e.get("event") != "planted_marker" for e in events)
    # the one-line replay command names the failing seed verbatim
    assert f"CHAOS_SEED=0x{seed:X}" in r.replay
    assert f"--seed 0x{seed:X} --rounds 1" in r.replay
    out = capsys.readouterr().out
    assert "replay: CHAOS_SEED=0x" in out and "FAILED" in out


def test_longhaul_out_dir_guard_rotates_stale_runs(tmp_path, capsys):
    """A populated --out dir is rotated to <out>.prev before any round
    starts: reusing stale h<N> dirs makes restarted hosts replay old WAL
    state and fail lincheck spuriously (the flake this guard kills)."""
    from dragonboat_tpu_torch.tools.longhaul import _prepare_out_dir

    out = str(tmp_path / "run")
    stale = os.path.join(out, "round-001-seed-0xDEAD", "h1")
    os.makedirs(stale)
    with open(os.path.join(stale, "wal.bin"), "w") as f:
        f.write("stale")
    # unit: non-empty dir rotates (replacing an older .prev), empty and
    # reuse=True do not
    assert _prepare_out_dir(out) is True
    assert os.listdir(out) == []
    assert os.path.isdir(os.path.join(out + ".prev", "round-001-seed-0xDEAD"))
    assert _prepare_out_dir(out) is False  # now empty: no rotation
    assert _prepare_out_dir(out + ".prev", reuse=True) is False
    assert os.path.exists(os.path.join(stale.replace(out, out + ".prev"),
                                       "wal.bin"))
    # runner level: a zero-budget run over a dirty dir stamps the
    # rotation in the header and the report
    os.makedirs(os.path.join(out, "leftover"))
    report = run_longhaul(
        Options(budget_s=0.0, out_dir=out, seed=1, ring=False)
    )
    assert report["out_dir_rotated"] is True
    assert not os.path.exists(os.path.join(out, "leftover"))
    assert os.path.isdir(os.path.join(out + ".prev", "leftover"))
    assert "(rotated stale run to .prev)" in capsys.readouterr().out


def test_longhaul_triage_tags_injected_failure_deterministic(tmp_path):
    """Failure triage: an injected failure is a new signature, gets ONE
    same-seed replay in a fresh `-triage` dir, and — since the replay
    fails the same verdict — lands in triage.json as DETERMINISTIC."""
    out = str(tmp_path / "run")
    report = run_longhaul(
        Options(
            budget_s=30.0,
            rounds_max=1,
            round_s=3.0,
            engine="scalar",
            out_dir=out,
            seed=0xABC,
            ring=False,
            inject_failure=True,
        )
    )
    assert not report["ok"]
    assert len(report["triage"]) == 1
    entry = report["triage"][0]
    assert entry["tag"] == "DETERMINISTIC"
    assert "injected_failure" in entry["verdicts"]
    assert entry["rounds"] == [1] and entry["seed"] == "0xABC"
    assert report["rounds"][0].triage == "DETERMINISTIC"
    # the replay ran in its own dir (stale h<N> reuse is poison)
    assert os.path.isdir(os.path.join(out, "round-001-seed-0xABC-triage"))
    ledger = json.load(open(report["triage_path"]))
    assert ledger["schema"] == 1
    assert [e["signature"] for e in ledger["entries"]] == [entry["signature"]]


def test_longhaul_triage_signature_dedupes_repeat_failures(tmp_path):
    """Ledger mechanics without running rounds: equal (failed-verdicts,
    diagnosis) pairs share a signature and later rounds join the entry
    with NO extra replay; different pairs get distinct signatures."""
    from dragonboat_tpu_torch.tools.longhaul import (
        RoundResult, _triage_round, _triage_signature,
    )

    a1 = RoundResult(1, 7, verdicts={"lincheck": False, "x": True},
                     diagnosis="wal_fsync_stall")
    a2 = RoundResult(5, 9, verdicts={"lincheck": False, "x": True},
                     diagnosis="wal_fsync_stall")
    b = RoundResult(2, 7, verdicts={"lincheck": False, "x": False},
                    diagnosis="wal_fsync_stall")
    c = RoundResult(3, 7, verdicts={"lincheck": False, "x": True},
                    diagnosis="election_churn")
    assert _triage_signature(a1) == _triage_signature(a2)
    assert len({_triage_signature(r) for r in (a1, b, c)}) == 3
    ledger = {
        _triage_signature(a1): {
            "signature": _triage_signature(a1),
            "verdicts": ["lincheck"], "diagnosis": "wal_fsync_stall",
            "rounds": [1], "seed": "0x7", "tag": "LOAD_SENSITIVE",
        }
    }
    # a known signature joins the entry; no _Round replay fires (it
    # would blow up on this bogus Options out dir if it did)
    _triage_round(a2, 9, Options(out_dir=str(tmp_path / "nope")), ledger)
    entry = ledger[_triage_signature(a2)]
    assert entry["rounds"] == [1, 5]
    assert a2.triage == "LOAD_SENSITIVE"


def test_timeline_sweep_flag_merges_run_dir(tmp_path):
    """`tools.timeline --sweep DIR` replaces manual artifact listing."""
    d = str(tmp_path)
    with open(os.path.join(d, "a.jsonl"), "w") as f:
        f.write(json.dumps({"t": 1.0, "event": "x", "cluster": 0}) + "\n")
    sub = os.path.join(d, "nested")
    os.makedirs(sub)
    with open(os.path.join(sub, "b.jsonl"), "w") as f:
        f.write(json.dumps({"t": 2.0, "event": "y", "cluster": 0}) + "\n")
    swept = sweep_artifacts(d)
    assert [os.path.basename(p) for p in swept] == ["a.jsonl", "b.jsonl"]
    assert [e["event"] for e in merge_dumps(swept)] == ["x", "y"]
    p = subprocess.run(
        [
            sys.executable, "-m", "dragonboat_tpu_torch.tools.timeline",
            "--sweep", d, "--json",
        ],
        cwd=_REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert p.returncode == 0, p.stderr
    events = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [e["event"] for e in events] == ["x", "y"]

def test_longhaul_sharded_multistep_smoke(tmp_path, capsys, monkeypatch):
    """The smoke rotation covers the sharded K-step engine: one round on
    shard_over_mesh + steps_per_sync=4 runs the usual chaos schedule to green verdicts —
    partition/drop force lanes onto the host-fallback path while the
    healthy co-hosted lanes keep riding the on-device router. The engines
    shard over 8 logical CPU shards (engine.vector.mesh_devices), as the
    reference's run shards over the conftest's 8 virtual devices."""
    import torch

    import dragonboat_tpu_torch.engine.vector as V

    meshes = []
    monkeypatch.setattr(V, "mesh_devices",
                        lambda device: meshes.append(device) or (torch.device("cpu"),) * 8)
    orig_init = V.VectorEngine.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        meshes.append(self._mesh_devices)

    monkeypatch.setattr(V.VectorEngine, "__init__", init)
    report = run_longhaul(
        Options(
            budget_s=90.0,
            rounds_max=1,
            round_s=3.0,
            engine="vector",
            out_dir=str(tmp_path / "run"),
            seed=0xD0C5,
            ring=False,
            scenarios=("partition", "drop", "none"),
            steps_per_sync=4,
            shard_over_mesh=True,
            device="cpu",
        )
    )
    assert report["ok"], [r.verdicts for r in report["rounds"]]
    r = report["rounds"][0]
    assert r.ok and r.verdicts["lincheck"]
    out = capsys.readouterr().out
    assert "verdict=OK" in out
    # every vector engine of the round sharded over the 8 logical shards
    widths = [m for m in meshes if isinstance(m, int)]
    assert widths and set(widths) == {8}, meshes


def test_longhaul_replay_cmd_reproduces_engine_composition(tmp_path):
    """A sharded K-step failure must replay on the sharded K-step
    engine: the one-line replay command carries the composition flags."""
    from dragonboat_tpu_torch.tools.longhaul import _Round

    opts = Options(
        out_dir=str(tmp_path / "run"), steps_per_sync=4,
        shard_over_mesh=True,
    )
    cmd = _Round(1, 0xBEEF, opts)._replay_cmd()
    assert "--steps-per-sync 4" in cmd
    assert "--shard-over-mesh" in cmd
    # the default composition stays flag-free (legacy replay lines keep
    # working)
    cmd = _Round(2, 0xBEEF, Options(out_dir=str(tmp_path / "run")))._replay_cmd()
    assert "--steps-per-sync" not in cmd
    assert "--shard-over-mesh" not in cmd
    # the device and the tick are part of the composition: the card and
    # 5 ms by default, so the default replay line names neither; a CPU
    # round replays on the CPU at its tick
    assert "--device" not in cmd and "--rtt-ms" not in cmd
    assert "python -m dragonboat_tpu_torch.tools.longhaul " in cmd
    cmd = _Round(3, 0xBEEF, Options(out_dir=str(tmp_path / "run"),
                                    device="cpu", rtt_ms=10))._replay_cmd()
    assert cmd.endswith(" --device cpu --rtt-ms 10")


def test_longhaul_same_seed_round_signature_is_bit_identical(tmp_path):
    """The replay contract at the RUNNER level: two same-seeded rounds
    print the same orchestration-schedule signature even though wire/
    fsync draw counts follow traffic timing (they are excluded from the
    digest, see _ORCH_SITES), and execute the same scenario sequence."""
    runs = []
    for i in (1, 2):
        report = run_longhaul(
            Options(
                budget_s=20.0,
                rounds_max=1,
                round_s=3.0,
                engine="scalar",
                out_dir=str(tmp_path / f"run{i}"),
                seed=0x516,
                ring=False,
            )
        )
        assert report["ok"], [r.verdicts for r in report["rounds"]]
        runs.append(report["rounds"][0])
    assert runs[0].signature == runs[1].signature
    assert runs[0].scenarios == runs[1].scenarios


@pytest.mark.chaos
def test_longhaul_lease_clock_chaos_round_replays_bit_identical(tmp_path):
    """The `lease_clock_chaos` scenario (seeded skew/drift/
    jump windows on live hosts' tick clocks while lease-read traffic
    runs) passes its verdicts in a single seeded round, and the SAME
    seed replays to the SAME orchestration-schedule signature — clock
    faults ride the FaultPlane decision streams like crashes do."""
    runs = []
    for i in (1, 2):
        report = run_longhaul(
            Options(
                budget_s=30.0,
                rounds_max=1,
                round_s=4.0,
                engine="scalar",
                out_dir=str(tmp_path / f"run{i}"),
                seed=0x2B1,
                ring=False,
                scenarios=("lease_clock_chaos",),
            )
        )
        assert report["ok"], [r.verdicts for r in report["rounds"]]
        r = report["rounds"][0]
        assert r.verdicts["lincheck"]
        assert r.verdicts["fairness_no_stall"]
        # the lease verdicts are present whenever fault windows ran, and
        # a round that injected skew past the margin must show FALLBACK
        # (reads served via ReadIndex), never a lincheck violation
        if "lease_reads_linearizable" in r.verdicts:
            assert r.verdicts["lease_reads_linearizable"]
        if "lease_fallback_served" in r.verdicts:
            assert r.verdicts["lease_fallback_served"]
        runs.append(r)
    assert runs[0].signature == runs[1].signature
    assert runs[0].scenarios == runs[1].scenarios


def test_longhaul_preflight_verdict_recorded_in_report(tmp_path, capsys):
    """Every run report pins WHICH static-analysis gate the tree passed
    (findings count + rule version), and the header says so (tools.check
    is the pre-merge bar, longhaul refuses dirty trees)."""
    report = run_longhaul(
        Options(budget_s=0.0, out_dir=str(tmp_path / "run"), seed=1, ring=False)
    )
    check = report["check"]
    assert check["ok"] is True
    assert check["findings"] == 0
    assert check["rule_version"] == RULES_VERSION
    assert "skipped" not in check
    out = capsys.readouterr().out
    assert "preflight tools.check:" in out
    assert "-> OK" in out


def test_longhaul_preflight_failure_refuses_to_start(
    tmp_path, capsys, monkeypatch
):
    from dragonboat_tpu_torch.tools import longhaul as lh

    monkeypatch.setattr(
        lh,
        "_preflight_check",
        lambda: {
            "ok": False,
            "findings": 2,
            "suppressed": 0,
            "rule_version": "2.0",
            "first": ["engine/vector.py:1: [device-sync/device-get] boom"],
        },
    )
    report = run_longhaul(
        Options(
            budget_s=30.0,
            rounds_max=1,
            round_s=2.0,
            out_dir=str(tmp_path / "run"),
            seed=1,
            ring=False,
        )
    )
    assert report["ok"] is False
    assert report["rounds"] == []  # zero rounds ran on a dirty tree
    assert report["check"]["findings"] == 2
    out = capsys.readouterr().out
    assert "-> FAIL" in out
    assert "refusing to start" in out
    assert "[device-sync/device-get]" in out


def test_longhaul_no_preflight_skips_the_gate(tmp_path):
    report = run_longhaul(
        Options(
            budget_s=0.0,
            out_dir=str(tmp_path / "run"),
            seed=1,
            ring=False,
            preflight=False,
        )
    )
    assert report["check"] == {"ok": True, "skipped": True}
