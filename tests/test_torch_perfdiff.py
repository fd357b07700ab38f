"""Twin of test_perfdiff.py for the port's `tools.perfdiff`: every case of
the reference's tests runs through both packages' perfdiff on the same
checked-in fixtures (tests/data/perfdiff_*.json) or the same derived
records, and the port's report, rendering and exit code must EQUAL the
reference's (JSON field for field, text byte for byte); the reference's
assertions then hold on the port's result. Then the rule the port adds:
a record stamped with a `backend` against one of another backend, or
against an unstamped record (the JAX package's fixtures carry none), is
`incomparable`, exit 2."""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from dragonboat_tpu.tools import perfdiff as REF
from dragonboat_tpu_torch.tools import perfdiff as PORT
from dragonboat_tpu_torch.tools.perfdiff import (
    FAIL,
    INCOMPARABLE,
    PASS,
    compare,
    compare_config,
    load_record,
    phase_regressed,
    render,
)

pytestmark = pytest.mark.perf

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DATA = os.path.join(_REPO, "tests", "data")
BASE = os.path.join(_DATA, "perfdiff_base.json")
REGRESS = os.path.join(_DATA, "perfdiff_regress.json")
NOMINAL = os.path.join(_DATA, "perfdiff_nominal.json")
HBM = os.path.join(_DATA, "perfdiff_hbm.json")
MESH8 = os.path.join(_DATA, "perfdiff_mesh8.json")
LEASE = os.path.join(_DATA, "perfdiff_lease.json")


def both(fn):
    """fn(module) through the reference and the port: equal results,
    the port's returned."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


def _main(mod, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = mod.main(list(args))
    return rc, buf.getvalue()


def cli(*args):
    """Both packages' CLI in process: equal exit code and output."""
    return both(lambda mod: _main(mod, *args))


def copy(d):
    return json.loads(json.dumps(d))


def test_port_cli_runs_as_a_module():
    p = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.tools.perfdiff", BASE, REGRESS,
         "--gate"], cwd=_REPO, capture_output=True, text=True, timeout=60)
    assert p.returncode == 1, p.stdout + p.stderr
    assert (p.returncode, p.stdout) == _main(REF, BASE, REGRESS, "--gate")


# ---------------------------------------------------------------------------
# the three gate verdicts, via the CLI
# ---------------------------------------------------------------------------


def test_gate_identical_runs_exit_zero():
    rc, out = cli(BASE, BASE, "--gate")
    assert rc == 0 and "PASS" in out


def test_gate_flags_injected_phase_regression():
    rc, out = cli(BASE, REGRESS, "--gate")
    assert rc == 1
    assert "save" in out and "REGRESSED" in out and "FAIL" in out


def test_gate_threshold_is_honored():
    rc, _ = cli(BASE, REGRESS, "--gate", "--threshold-pct", "40")
    assert rc == 0


def test_refuses_scaled_down_vs_nominal():
    for extra in ((), ("--gate",)):
        rc, out = cli(BASE, NOMINAL, *extra)
        assert rc == 2
        assert "INCOMPARABLE" in out and "scaled_down" in out


def test_json_report_shape():
    rc, out = cli(BASE, REGRESS, "--json")
    rep = json.loads(out.splitlines()[0])
    assert rep["verdict"] == FAIL
    c1 = rep["configs"]["1"]
    assert c1["verdict"] == FAIL
    assert c1["phases"]["save"]["regressed"] is True
    assert c1["phases"]["save"]["delta_pct"] == pytest.approx(30.0)
    assert rep["configs"]["3"]["verdict"] == PASS


# ---------------------------------------------------------------------------
# API semantics
# ---------------------------------------------------------------------------


def test_hbm_and_counter_deltas_are_informational():
    with open(HBM) as f:
        rec = json.load(f)
    worse = copy(rec)
    for cfg in worse["configs"].values():
        cfg["hbm_bytes_total"] *= 2
        cfg["hbm_waste_ratio"] = min(0.99, cfg["hbm_waste_ratio"] * 1.3)
        cfg["counters"] = {k: v * 10 for k, v in cfg["counters"].items()}
    rep = both(lambda m: m.compare(rec, worse))
    assert rep["verdict"] == PASS
    c1 = rep["configs"]["1"]
    assert c1["hbm"]["hbm_bytes_total"]["delta_pct"] == pytest.approx(100.0)
    assert c1["counters"]["heartbeats_sent"]["new"] == 84000
    assert not c1["reasons"]
    assert "hbm (info)" in both(lambda m: m.render(rep))
    rc, out = cli(HBM, HBM, "--gate")
    assert rc == 0 and "hbm (info)" in out


def test_legacy_records_without_census_keys_keep_comparing():
    rep = both(lambda m: m.compare(m.load_record(BASE), m.load_record(HBM)))
    assert rep["verdict"] == PASS
    for c in rep["configs"].values():
        assert "hbm" not in c and "counters" not in c
    assert cli(BASE, HBM, "--gate")[0] == 0


@pytest.mark.parametrize("old,new,pct,floor,want", [
    (1.0, 1.3, 20.0, 0.001, True),
    (1.0, 1.1, 20.0, 0.001, False),
    (0.0001, 0.0005, 20.0, 0.001, False),
    (0.0, 0.01, 20.0, 0.001, True),
    (2.0, 1.0, 20.0, 0.001, False),
])
def test_phase_regression_rule(old, new, pct, floor, want):
    assert both(lambda m: m.phase_regressed(old, new, pct, floor)) is want
    assert phase_regressed(old, new, pct, floor) is want


def _cfg1():
    return load_record(BASE)["configs"]["1"]


def test_out_of_seam_sync_growth_fails():
    a = _cfg1()
    b = copy(a)
    b["device_syncs"]["out_of_seam"] = 3
    b["device_syncs"]["sites"] = {"engine/vector.py:9:_decode": 3}
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == FAIL
    assert any("out-of-seam" in s for s in r["reasons"])


def test_watched_function_retrace_fails():
    """In the port's records per_function counts kernel builds per source
    (`build:<source>`): a build in the window gates like a retrace."""
    a = _cfg1()
    b = copy(a)
    b["compile_events"]["total"] = 3
    b["compile_events"]["per_function"] = {"step_batch[g4]": 3}
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == FAIL
    assert any("retraces" in s for s in r["reasons"])
    built = copy(a)
    built["compile_events"]["per_function"] = {"build:step_batch.cu": 1}
    assert compare_config(a, built)["verdict"] == FAIL


def test_unwatched_lazy_compile_does_not_gate():
    a = _cfg1()
    b = copy(a)
    b["compile_events"]["total"] = 1
    assert both(lambda m: m.compare_config(a, b))["verdict"] == PASS


def test_refuses_steps_per_sync_mismatch():
    a = _cfg1()
    b = copy(a)
    b["steps_per_sync"] = 8
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("steps_per_sync" in s for s in r["reasons"])
    assert both(lambda m: m.compare_config(b, a))["verdict"] == INCOMPARABLE


def test_refuses_front_vs_raw_workload_mismatch():
    a = _cfg1()
    b = copy(a)
    b["workload"] = "through_front"
    b["session_mode"] = "sessions"
    b["placement_enabled"] = True
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("workload" in s for s in r["reasons"])
    assert both(lambda m: m.compare_config(b, a))["verdict"] == INCOMPARABLE
    assert both(lambda m: m.compare_config(b, copy(b)))["verdict"] == PASS
    legacy_front = copy(a)
    legacy_front["session_mode"] = "sessions"
    assert both(lambda m: m.compare_config(a, legacy_front))["verdict"] == INCOMPARABLE


def test_refuses_mesh_shape_mismatch():
    for extra in ((), ("--gate",)):
        rc, out = cli(BASE, MESH8, *extra)
        assert rc == 2 and "INCOMPARABLE" in out and "mesh" in out
    a = _cfg1()
    b = load_record(MESH8)["configs"]["1"]
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("mesh" in s for s in r["reasons"])
    assert both(lambda m: m.compare_config(b, a))["verdict"] == INCOMPARABLE
    assert both(lambda m: m.compare_config(b, copy(b)))["verdict"] == PASS
    a1 = copy(a)
    a1["n_devices"] = 1
    a1["mesh_shape"] = [1]
    assert both(lambda m: m.compare_config(a, a1))["verdict"] == PASS


def test_refuses_lease_vs_readindex_reads():
    for extra in ((), ("--gate",)):
        rc, out = cli(BASE, LEASE, *extra)
        assert rc == 2 and "INCOMPARABLE" in out and "read_mode" in out
    a = _cfg1()
    b = load_record(LEASE)["configs"]["1"]
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("read_mode" in s for s in r["reasons"])
    r = both(lambda m: m.compare_config(b, a))
    assert r["verdict"] == INCOMPARABLE
    assert both(lambda m: m.compare_config(b, copy(b)))["verdict"] == PASS
    a1 = copy(a)
    a1["read_mode"] = "readindex"
    assert both(lambda m: m.compare_config(a, a1))["verdict"] == PASS


def test_same_steps_per_sync_stays_comparable():
    a = _cfg1()
    a8, b8 = copy(a), copy(a)
    a8["steps_per_sync"] = b8["steps_per_sync"] = 8
    assert both(lambda m: m.compare_config(a8, b8))["verdict"] == PASS
    explicit1 = copy(a)
    explicit1["steps_per_sync"] = 1
    assert both(lambda m: m.compare_config(a, explicit1))["verdict"] == PASS


def test_refuses_cross_host_records():
    a = load_record(BASE)
    b = copy(a)
    a["host"] = {"id": "box-a/8cpu", "calib_s": 0.1}
    b["host"] = {"id": "box-b/64cpu", "calib_s": 0.03}
    r = both(lambda m: m.compare(a, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("host mismatch" in s for s in r["reasons"])
    assert "box-a/8cpu" in both(lambda m: m.render(r))
    legacy = load_record(BASE)
    r = both(lambda m: m.compare(legacy, b))
    assert r["verdict"] == INCOMPARABLE
    assert any("provenance unknown" in s for s in r["reasons"])
    assert both(lambda m: m.compare(b, legacy))["verdict"] == INCOMPARABLE


def test_same_host_and_legacy_pairs_stay_comparable():
    a = load_record(BASE)
    b = copy(a)
    assert both(lambda m: m.compare(a, b))["verdict"] == PASS
    a["host"] = {"id": "box-a/8cpu", "calib_s": 0.1}
    b["host"] = {"id": "box-a/8cpu", "calib_s": 0.4}
    assert both(lambda m: m.compare(a, b))["verdict"] == PASS


def test_both_scaled_to_different_widths_incomparable():
    a = load_record(BASE)["configs"]["3"]
    b = copy(a)
    b["actual_groups"] = 128
    assert both(lambda m: m.compare_config(a, b))["verdict"] == INCOMPARABLE


def test_throughput_drop_fails():
    a = _cfg1()
    b = copy(a)
    b["value"] = a["value"] * 0.7
    r = both(lambda m: m.compare_config(a, b))
    assert r["verdict"] == FAIL
    assert any("throughput" in s for s in r["reasons"])


def test_legacy_vs_modern_normalizes_renamed_phases():
    legacy = {"configs": {"2": {"value": 100.0, "host_stage_total_s": {
        "step": 1.0, "apply": 1.0, "save": 0.5}}}}
    modern = {"configs": {"2": {"value": 100.0, "phase_breakdown": {
        "fetch": 1.5, "apply": 0.9, "reads": 0.4, "save": 0.5}}}}
    c = both(lambda m: m.compare(legacy, modern))["configs"]["2"]
    assert c["phases"]["fetch"]["regressed"] is True
    assert c["phases"]["apply"]["regressed"] is True
    assert "reads" not in c["phases"]
    assert not c["phases"]["save"].get("regressed")


def test_legacy_records_fall_back_to_host_stage_totals():
    a = {"configs": {"2": {"value": 100.0,
                           "host_stage_total_s": {"save": 1.0, "pack": 0.5}}}}
    b = {"configs": {"2": {"value": 100.0,
                           "host_stage_total_s": {"save": 1.5, "pack": 0.5}}}}
    rep = both(lambda m: m.compare(a, b))
    assert rep["verdict"] == FAIL
    assert rep["configs"]["2"]["phases"]["save"]["regressed"] is True
    assert "save" in both(lambda m: m.render(rep))


def test_trajectory_directory_mode(tmp_path):
    shutil.copy(BASE, tmp_path / "BENCH_r01.json")
    shutil.copy(BASE, tmp_path / "BENCH_r02.json")
    shutil.copy(REGRESS, tmp_path / "BENCH_r03.json")
    assert cli(str(tmp_path), "--gate")[0] == 1
    shutil.copy(BASE, tmp_path / "BENCH_r04.json")
    assert cli(str(tmp_path), "--gate")[0] == 0


def test_real_bench_trajectory_is_loadable():
    paths = sorted(
        os.path.join(_REPO, f) for f in os.listdir(_REPO)
        if f.startswith("BENCH_r") and f.endswith(".json"))
    assert len(paths) >= 2, "the repo's BENCH_r0x trajectory"
    rep = both(lambda m: m.compare(m.load_record(paths[-2]), m.load_record(paths[-1])))
    assert rep["verdict"] in (PASS, FAIL, INCOMPARABLE)
    assert both(lambda m: m.render(rep))


def test_every_fixture_pair_equals_the_reference():
    """Every ordered pair of the checked-in fixtures, in JSON mode with
    the gate: the same exit code and the same report."""
    fixtures = sorted(os.path.join(_DATA, f) for f in os.listdir(_DATA)
                      if f.startswith("perfdiff_"))
    assert len(fixtures) == 6
    for a in fixtures:
        for b in fixtures:
            cli(a, b, "--gate", "--json")
            cli(a, b)


# ---------------------------------------------------------------------------
# the port's rule: the backend stamp
# ---------------------------------------------------------------------------


def _torch_record(**over):
    rec = load_record(BASE)
    rec["backend"] = "torch"
    rec.update(over)
    return rec


def test_same_backend_compares():
    a = _torch_record()
    assert compare(a, copy(a))["verdict"] == PASS
    a["host"] = {"id": "h100-box/8cpu"}
    assert compare(a, copy(a))["verdict"] == PASS


def test_refuses_cross_backend_records():
    a, b = load_record(BASE), _torch_record()
    a["backend"] = "jax"
    r = compare(a, b)
    assert r["verdict"] == INCOMPARABLE and r["configs"] == {}
    assert r["reasons"] == [
        "backend mismatch: old ran on 'jax', new on 'torch'; deltas would "
        "compare two implementations, not code"]
    assert "backend mismatch" in render(r)


@pytest.mark.parametrize("stamped", ["old", "new"])
def test_refuses_one_sided_backend_stamp(stamped):
    """The JAX package's records carry no backend: against a torch
    record they are refused, whichever side is stamped."""
    plain, torch_rec = load_record(BASE), _torch_record()
    old, new = (torch_rec, plain) if stamped == "old" else (plain, torch_rec)
    r = compare(old, new)
    assert r["verdict"] == INCOMPARABLE
    which = "new" if stamped == "old" else "old"
    assert r["reasons"][0].startswith(f"backend unknown: the {which} record")


def test_cli_refuses_cross_backend_pair_with_exit_2(tmp_path):
    """A port e2e record (e2e.bench_record) against the JAX package's
    fixture, and against itself."""
    from dragonboat_tpu_torch import e2e

    cfg = copy(load_record(BASE)["configs"]["1"])
    cfg.update(backend="torch", host=None)
    path = str(tmp_path / "port.json")
    with open(path, "w") as f:
        json.dump(e2e.bench_record({1: cfg}), f)
    assert load_record(path)["backend"] == "torch"
    for extra in ((), ("--gate",)):
        rc, out = _main(PORT, BASE, path, *extra)
        assert rc == 2 and "INCOMPARABLE" in out and "backend unknown" in out
    rc, out = _main(PORT, path, path, "--gate")
    assert rc == 0 and "PASS" in out


def test_compile_watch_counts_kernel_builds_per_source():
    """What the port's records gate in `compile_events.per_function`: one
    `build:<source>` count per nvcc build, seen by the window's diff and
    by perfdiff's gate."""
    from dragonboat_tpu_torch.ops import cuda
    from dragonboat_tpu_torch.profile import CompileWatch, diff_compiles

    cw = CompileWatch().install()
    listener = cuda.BUILD_LISTENERS[-1]
    try:
        before = cw.snapshot()
        listener("step_batch.cu", 2.5)
        listener("route.cu", 3.0)
        listener("step_batch.cu", 2.0)
        d = diff_compiles(before, cw.snapshot())
    finally:
        cuda.BUILD_LISTENERS.remove(listener)
    assert d["total"] == 3 and d["total_s"] == 7.5
    assert d["per_function"] == {"build:step_batch.cu": 2, "build:route.cu": 1}
    a = _cfg1()
    b = copy(a)
    b["compile_events"] = d
    r = compare_config(a, b)
    assert r["verdict"] == FAIL and r["compile_events"]["new_retraces"] == 3
