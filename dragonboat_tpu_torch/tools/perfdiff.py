"""`python -m dragonboat_tpu_torch.tools.perfdiff` — the bench regression
gate of the PyTorch port.

Compares two bench JSON records (the single line `bench.py` prints, saved
to a file — the `BENCH_r0x.json` trajectory format — or a record of the
port's e2e harness, `e2e.bench_record`) per config and per phase, and in
`--gate` mode exits non-zero on regression.

    python -m dragonboat_tpu_torch.tools.perfdiff OLD.json NEW.json
    python -m dragonboat_tpu_torch.tools.perfdiff OLD.json NEW.json --gate \\
        --threshold-pct 20
    python -m dragonboat_tpu_torch.tools.perfdiff .    # BENCH_* trajectory
    python -m dragonboat_tpu_torch.tools.perfdiff A.json B.json --json

What is compared, per config present in BOTH records:

  * headline `value` (proposals/s; a drop >= threshold is a regression)
  * `phase_breakdown` — per-phase host seconds from the step-phase
    profiler (dragonboat_tpu_torch.profile); a phase that grows >= threshold
    (and by at least `--min-seconds`, the absolute noise floor) is a
    regression. Records that predate `phase_breakdown` fall back to
    `host_stage_total_s`; only phases present in both are compared.
  * `device_syncs.out_of_seam` — any NEW out-of-seam device sync is a
    regression (the runtime twin of the `device-sync` lint family).
  * `compile_events.per_function` — any growth in measurement-window
    compiles of the watched functions is a regression. In the port's
    records these count KERNEL BUILDS (`profile.CompileWatch` listens on
    `ops/cuda.build_kernels`: one event per nvcc build of a `csrc/*.cu`
    source), the runtime twin of the `build` lint family; in the JAX
    package's records they count retraces of its jitted functions. The
    raw `total` is reported but not gated.
  * `hbm_*` census keys and the `counters` event totals, when BOTH
    records carry them — informational deltas only, never gated (more
    HBM may be the fix, fewer elections may be the workload); legacy
    records without the keys keep comparing untouched.
  * `history_*` telemetry-sampler keys (sample count + total sample
    cost), when BOTH records carry them — informational only, never
    gated: they describe the observability overhead the run paid, not
    the code under test.

Honesty rule: a config stamped `scaled_down` (it ran fewer groups than
its `nominal_groups` regime) is NOT comparable against a nominal run of
the same config — the numbers measure different workloads. perfdiff
refuses (verdict `incomparable`, exit code 2) instead of printing a
delta that would be read as a regression or a win. The same rule shape
covers `steps_per_sync` (a K=8 multi-step run measures a different
engine than a K=1 run) and, at the record level, the `host` stamp: two
records from DIFFERENT boxes (or one stamped, one of unknown
provenance) measure hardware, not code — recalibrating one commit on
two boxes of this repo's own trajectory showed a 1.65x throughput gap
at identical code and shape. Two legacy records (neither stamped)
still compare: the pre-stamp trajectory keeps diffing. The `backend`
stamp follows the same rule: a record of the PyTorch port
(`"backend": "torch"`) against one of another backend, or against a
record with no stamp (the JAX package's bench.py records carry none),
measures two implementations, not a code change, and is refused.

Exit codes: 0 = pass, 1 = regression (with --gate), 2 = incomparable.

Directory mode: a single directory argument collects `BENCH_*.json`
(sorted), prints the delta for every consecutive pair, and gates on the
LAST pair — the newest step of the trajectory.

Reads JSON only: usable as a pre-merge hook on any box, like
`tools.check`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

DEFAULT_THRESHOLD_PCT = 20.0
DEFAULT_MIN_SECONDS = 0.001

PASS = "pass"
FAIL = "fail"
INCOMPARABLE = "incomparable"


def _record_from_text(text: str) -> Optional[dict]:
    """First parseable JSON object line that looks like a bench record
    (tolerates surrounding log noise)."""
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            d = json.loads(ln)
        except ValueError:
            continue
        if isinstance(d, dict) and ("configs" in d or "metric" in d):
            return d
    return None


def load_record(path: str) -> dict:
    """A bench record: either the single line bench.py prints, or a CI
    wrapper object (the checked-in BENCH_r0x trajectory) whose `tail`
    string embeds that line among the run's log output."""
    with open(path) as f:
        text = f.read()
    try:
        d = json.loads(text)
    except ValueError:
        d = None
    if isinstance(d, dict):
        if "configs" in d or "metric" in d:
            return d
        parsed = d.get("parsed")
        if isinstance(parsed, dict) and ("configs" in parsed or "metric" in parsed):
            return parsed
        tail = d.get("tail")
        if isinstance(tail, str):
            r = _record_from_text(tail)
            if r is not None:
                return r
    r = _record_from_text(text)
    if r is not None:
        return r
    raise ValueError(f"{path}: no bench JSON record found")


def _phases(cfg: dict) -> Tuple[Dict[str, float], bool]:
    """(phase totals, legacy flag). Legacy = pre-attribution-plane
    records whose host_stage_total_s used the old stage vocabulary."""
    pb = cfg.get("phase_breakdown")
    if isinstance(pb, dict):
        return {k: float(v) for k, v in pb.items()}, False
    hs = cfg.get("host_stage_total_s")
    if isinstance(hs, dict):
        return {k: float(v) for k, v in hs.items()}, True
    return {}, True


def _normalize_legacy(
    legacy: Dict[str, float], modern: Dict[str, float]
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Align a legacy record's stage vocabulary with a modern one so the
    diff compares like with like across the stage rename: the
    old 'step' stage IS the new 'fetch' (the _fetch_output sync), and
    the old 'apply' covered decode phases 4 AND 5, so the modern side's
    'apply'+'reads' fold together and 'reads' drops."""
    leg = dict(legacy)
    mod = dict(modern)
    if "fetch" not in leg and "step" in leg:
        leg["fetch"] = leg.pop("step")
    if "reads" in mod and "reads" not in leg:
        mod["apply"] = mod.get("apply", 0.0) + mod.pop("reads")
    return leg, mod


def _scaled(cfg: dict) -> bool:
    return bool(cfg.get("scaled_down"))


def _steps_per_sync(cfg: dict) -> int:
    """The engine's K (protocol steps per kernel launch / device sync).
    Records that predate the stamp ran the classic one-step engine."""
    try:
        return int(cfg.get("steps_per_sync", 1) or 1)
    except (TypeError, ValueError):
        return 1


def _workload(cfg: dict) -> str:
    """The config's measured workload shape. `through_front` runs drive
    traffic THROUGH SessionManager/ServingFront (admission, weighted-
    fair pump, session dedup), so their headline is ADMITTED throughput
    — a different machine than a raw propose_batch run. Records that
    predate the stamp are raw by construction."""
    w = cfg.get("workload")
    if w:
        return str(w)
    return "through_front" if cfg.get("session_mode") else "raw"


def _read_mode(cfg: dict) -> str:
    """The config's read path: 'lease' serves linearizable reads off the
    leader lease (no quorum round per read), 'readindex' pays the
    ReadIndex confirmation. Records that predate the stamp ran
    ReadIndex by construction (leases did not exist)."""
    return str(cfg.get("read_mode") or "readindex")


def _mesh(cfg: dict) -> Tuple[int, Tuple[int, ...]]:
    """The config's device mesh: (n_devices, mesh_shape). Records that
    predate the stamp ran unsharded single-device engines — (1, (1,))
    by construction, so a legacy record compares cleanly against a
    modern explicit 1-device run."""
    try:
        n = int(cfg.get("n_devices", 1) or 1)
    except (TypeError, ValueError):
        n = 1
    shape = cfg.get("mesh_shape")
    if isinstance(shape, (list, tuple)) and shape:
        try:
            return n, tuple(int(d) for d in shape)
        except (TypeError, ValueError):
            pass
    return n, (n,)


def _host_id(rec: dict) -> Optional[str]:
    """The record's box fingerprint (bench.py stamps hostname/cpu-count
    plus a timed calibration spin). None = legacy record, pre-stamp."""
    h = rec.get("host")
    if isinstance(h, dict) and h.get("id"):
        return str(h["id"])
    return None


def _backend(rec: dict) -> Optional[str]:
    """The record's implementation stamp (`"torch"` on the port's e2e
    records). None = a record with no stamp (the JAX package's bench.py
    records)."""
    b = rec.get("backend")
    return str(b) if b else None


def phase_regressed(
    old: float, new: float, threshold_pct: float, min_seconds: float
) -> bool:
    """The gate's per-phase rule: a regression must clear BOTH the
    relative threshold and an absolute floor (sub-millisecond jitter on
    a near-zero phase is noise, not a regression); a phase growing from
    zero past the floor is always a regression."""
    if new - old < min_seconds:
        return False
    if old <= 0.0:
        return True
    return (new - old) / old * 100.0 >= threshold_pct


def _pct(old: float, new: float) -> Optional[float]:
    if old == 0.0:
        return None
    return round((new - old) / old * 100.0, 1)


def compare_config(
    old: dict,
    new: dict,
    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
    min_seconds: float = DEFAULT_MIN_SECONDS,
) -> dict:
    """Compare one ladder config's old/new records; returns the verdict,
    the reasons behind it, and the per-dimension deltas."""
    reasons: List[str] = []
    # ---- honesty: scaled-down vs nominal is not a comparison ----------
    if _scaled(old) != _scaled(new):
        which, scaled = ("old", old) if _scaled(old) else ("new", new)
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"scaled_down mismatch: the {which} run stands in "
                f"{scaled.get('actual_groups', scaled.get('groups'))} "
                f"groups for a nominal {scaled.get('nominal_groups')}-group "
                f"regime; deltas would compare different workloads"
            ],
        }
    oa = old.get("actual_groups", old.get("groups"))
    na = new.get("actual_groups", new.get("groups"))
    if _scaled(old) and oa != na:
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"both runs scaled down, but to different group counts "
                f"({oa} vs {na})"
            ],
        }
    # ---- honesty: different steps_per_sync is a different engine ------
    # K changes how many protocol steps one dispatch+fetch covers, so
    # per-phase host seconds and client-visible latency measure different
    # machines; a K=8 run "beating" a K=1 run is a config change, not a
    # perf delta (same rule shape as the scaled-down refusal).
    ok, nk = _steps_per_sync(old), _steps_per_sync(new)
    if ok != nk:
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"steps_per_sync mismatch: old ran K={ok}, new ran K={nk};"
                " per-phase deltas would compare different engines"
            ],
        }
    # ---- honesty: through-front vs raw is a different workload --------
    # an admitted-throughput number (admission control + weighted-fair
    # pump + session dedup in the path) "regressing" against a raw
    # propose_batch number is a workload change, not a perf delta (same
    # rule shape as the scaled-down and K refusals)
    ow, nw = _workload(old), _workload(new)
    if ow != nw:
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"workload mismatch: old measured '{ow}', new measured "
                f"'{nw}'; admitted-front throughput and raw "
                "propose_batch throughput are different machines"
            ],
        }
    # ---- honesty: lease reads vs ReadIndex is a different read path ---
    # a lease-mode reads/s number "beating" a ReadIndex-mode number is
    # the POINT of the lease feature, not a perf delta of the same code;
    # and a lease run "regressing" against itself after a fallback-heavy
    # window would misread degradation as a code change (same rule shape
    # as the scaled-down / K / workload refusals)
    orm, nrm = _read_mode(old), _read_mode(new)
    if orm != nrm:
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"read_mode mismatch: old measured '{orm}' reads, new "
                f"measured '{nrm}'; lease-served and ReadIndex-confirmed "
                "reads are different read paths"
            ],
        }
    # ---- honesty: a different device mesh is a different machine ------
    # sharding the lane axis over N devices changes what one kernel
    # launch covers and where cross-shard traffic flows; an 8-device run
    # "beating" a 1-device run is a topology change, not a perf delta
    # (same rule shape as the scaled-down / K / workload refusals)
    om, nm = _mesh(old), _mesh(new)
    if om != nm:
        return {
            "verdict": INCOMPARABLE,
            "reasons": [
                f"mesh mismatch: old ran {om[0]} device(s) "
                f"(mesh {list(om[1])}), new ran {nm[0]} device(s) "
                f"(mesh {list(nm[1])}); deltas would compare different "
                "device topologies"
            ],
        }
    out: dict = {"verdict": PASS, "reasons": reasons}
    # ---- headline throughput ------------------------------------------
    ov, nv = float(old.get("value", 0.0)), float(new.get("value", 0.0))
    out["value"] = {"old": ov, "new": nv, "delta_pct": _pct(ov, nv)}
    if ov > 0 and (ov - nv) / ov * 100.0 >= threshold_pct:
        reasons.append(
            f"throughput regressed {((ov - nv) / ov * 100.0):.1f}% "
            f"({ov:.0f} -> {nv:.0f} proposals/s)"
        )
    # ---- per-phase host seconds ---------------------------------------
    op, old_legacy = _phases(old)
    np_, new_legacy = _phases(new)
    if old_legacy and not new_legacy:
        op, np_ = _normalize_legacy(op, np_)
    elif new_legacy and not old_legacy:
        np_, op = _normalize_legacy(np_, op)
    phases: Dict[str, dict] = {}
    for name in sorted(set(op) & set(np_)):
        o, n = op[name], np_[name]
        phases[name] = {"old": o, "new": n, "delta_pct": _pct(o, n)}
        if phase_regressed(o, n, threshold_pct, min_seconds):
            phases[name]["regressed"] = True
            reasons.append(
                f"phase '{name}' regressed "
                f"{'from zero' if o <= 0 else f'{(n - o) / o * 100.0:.1f}%'}"
                f" ({o:.4f}s -> {n:.4f}s)"
            )
    out["phases"] = phases
    # ---- runtime sync/retrace audit -----------------------------------
    ods, nds = old.get("device_syncs"), new.get("device_syncs")
    if isinstance(ods, dict) and isinstance(nds, dict):
        o, n = int(ods.get("out_of_seam", 0)), int(nds.get("out_of_seam", 0))
        out["device_syncs"] = {"old_out_of_seam": o, "new_out_of_seam": n}
        if n > o:
            sites = nds.get("sites") or {}
            reasons.append(
                f"out-of-seam device syncs grew {o} -> {n}"
                + (f" (sites: {sorted(sites)[:3]})" if sites else "")
            )
    oce, nce = old.get("compile_events"), new.get("compile_events")
    if isinstance(oce, dict) and isinstance(nce, dict):
        # gate on the watched functions' window compiles (per_function:
        # kernel builds per source in the port's records, retraces per
        # jitted function in the JAX package's); raw `total` stays
        # informational. The keys and the reason text are the JAX
        # package's, so both packages print the same report
        o = sum((oce.get("per_function") or {}).values())
        n = sum((nce.get("per_function") or {}).values())
        out["compile_events"] = {
            "old_total": int(oce.get("total", 0)),
            "new_total": int(nce.get("total", 0)),
            "old_retraces": o,
            "new_retraces": n,
        }
        if n > o:
            per = nce.get("per_function") or {}
            reasons.append(
                f"window retraces of watched jitted functions grew "
                f"{o} -> {n}"
                + (f" (functions: {sorted(per)[:3]})" if per else "")
            )
    # ---- HBM census + counter plane (INFORMATIONAL, never gated) ------
    # device-memory footprint and protocol-event totals are honest run
    # descriptors, not perf verdicts: more HBM may be the fix (bigger
    # log window), fewer elections may be the workload. Deltas surface
    # for the operator; nothing here ever lands in `reasons`. Records
    # that predate the census (either side) simply omit the section —
    # legacy trajectories keep comparing untouched.
    if all(k in old and k in new for k in ("hbm_bytes_total",
                                           "hbm_waste_ratio")):
        hbm: dict = {}
        for k in ("hbm_bytes_total", "hbm_log_bytes",
                  "log_fill_p50", "log_fill_p99", "hbm_waste_ratio"):
            o, n = float(old.get(k, 0)), float(new.get(k, 0))
            hbm[k] = {"old": o, "new": n, "delta_pct": _pct(o, n)}
        out["hbm"] = hbm
    octr, nctr = old.get("counters"), new.get("counters")
    if isinstance(octr, dict) and isinstance(nctr, dict):
        out["counters"] = {
            k: {"old": int(octr[k]), "new": int(nctr[k])}
            for k in sorted(set(octr) & set(nctr))
        }
    # ---- telemetry-history sampler (INFORMATIONAL, never gated) -------
    # the sampler runs live through the measured window; its sample
    # count and total sample cost describe the observability overhead
    # the run paid, not the code under test — surfaced for the operator,
    # never in `reasons`. Pre-sampler records omit the section.
    if all(
        k in old and k in new
        for k in ("history_samples_total", "history_sample_cost_seconds_total")
    ):
        hs: dict = {}
        for k in ("history_samples_total", "history_errors_total",
                  "history_sample_cost_seconds_total"):
            o, n = float(old.get(k, 0)), float(new.get(k, 0))
            hs[k] = {"old": o, "new": n, "delta_pct": _pct(o, n)}
        out["history"] = hs
    if reasons:
        out["verdict"] = FAIL
    return out


def _refused(reason: str, threshold_pct: float, min_seconds: float) -> dict:
    return {
        "verdict": INCOMPARABLE,
        "threshold_pct": threshold_pct,
        "min_seconds": min_seconds,
        "reasons": [reason],
        "configs": {},
    }


def compare(
    old: dict,
    new: dict,
    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
    min_seconds: float = DEFAULT_MIN_SECONDS,
) -> dict:
    """Whole-record comparison over the configs present in both; the
    overall verdict is incomparable > fail > pass."""
    # ---- honesty: different boxes measure hardware, not code ----------
    # A per-phase/throughput delta across hosts would be read as a code
    # regression or win; refuse up front. One-sided stamps also refuse —
    # the unstamped record's provenance is unknown, so the delta cannot
    # be attributed to code. Neither-stamped (two legacy records) keeps
    # comparing: the pre-stamp trajectory loses nothing retroactively.
    oh, nh = _host_id(old), _host_id(new)
    if oh != nh:
        if oh and nh:
            reason = (
                f"host mismatch: old ran on {oh!r}, new on {nh!r}; "
                "deltas would measure hardware, not code"
            )
        else:
            which = "old" if nh else "new"
            reason = (
                f"host provenance unknown: the {which} record predates "
                "the host stamp, so deltas cannot be attributed to code "
                "(rerun the old side on this box to compare)"
            )
        return _refused(reason, threshold_pct, min_seconds)
    # ---- honesty: two backends are two implementations ----------------
    # the same rule shape as the host stamp: a torch record against a
    # record of another backend (or of unknown backend) compares two
    # implementations of the system, not a code change of one
    ob, nb = _backend(old), _backend(new)
    if ob != nb:
        if ob and nb:
            reason = (
                f"backend mismatch: old ran on {ob!r}, new on {nb!r}; "
                "deltas would compare two implementations, not code"
            )
        else:
            which = "old" if nb else "new"
            reason = (
                f"backend unknown: the {which} record carries no backend "
                "stamp, so deltas cannot be attributed to code of one "
                "implementation (rerun that side with the same backend)"
            )
        return _refused(reason, threshold_pct, min_seconds)
    oc = old.get("configs") or {}
    nc = new.get("configs") or {}
    configs: Dict[str, dict] = {}
    for cid in sorted(set(oc) & set(nc), key=str):
        a, b = oc[cid], nc[cid]
        if "error" in a or "error" in b:
            configs[cid] = {
                "verdict": INCOMPARABLE,
                "reasons": ["one of the runs recorded an error"],
            }
            continue
        configs[cid] = compare_config(a, b, threshold_pct, min_seconds)
    verdict = PASS
    if any(c["verdict"] == FAIL for c in configs.values()):
        verdict = FAIL
    if any(c["verdict"] == INCOMPARABLE for c in configs.values()):
        verdict = INCOMPARABLE
    return {
        "verdict": verdict,
        "threshold_pct": threshold_pct,
        "min_seconds": min_seconds,
        "configs": configs,
    }


def render(report: dict, old_name: str = "old", new_name: str = "new") -> str:
    lines = [f"perfdiff {old_name} -> {new_name}"]
    for cid, c in sorted(report["configs"].items(), key=lambda kv: kv[0]):
        lines.append(f"  config {cid}: {c['verdict'].upper()}")
        v = c.get("value")
        if v:
            d = v["delta_pct"]
            lines.append(
                f"    value: {v['old']:.1f} -> {v['new']:.1f}"
                + (f" ({d:+.1f}%)" if d is not None else "")
            )
        for name, p in sorted(c.get("phases", {}).items()):
            d = p["delta_pct"]
            mark = "  << REGRESSED" if p.get("regressed") else ""
            lines.append(
                f"    phase {name:<10} {p['old']:.4f}s -> {p['new']:.4f}s"
                + (f" ({d:+.1f}%)" if d is not None else "")
                + mark
            )
        h = c.get("hbm")
        if h:
            b, w = h["hbm_bytes_total"], h["hbm_waste_ratio"]
            lines.append(
                f"    hbm (info): {b['old']:.0f} -> {b['new']:.0f} bytes,"
                f" waste {w['old']:.2f} -> {w['new']:.2f}"
            )
        hs = c.get("history")
        if hs:
            s, cost = (
                hs["history_samples_total"],
                hs["history_sample_cost_seconds_total"],
            )
            lines.append(
                f"    history (info): {s['old']:.0f} -> {s['new']:.0f} "
                f"samples, cost {cost['old']:.4f}s -> {cost['new']:.4f}s"
            )
        for r in c.get("reasons", []):
            lines.append(f"    ! {r}")
    for r in report.get("reasons", []):
        lines.append(f"  ! {r}")
    lines.append(f"verdict: {report['verdict'].upper()}")
    return "\n".join(lines)


def _exit_code(report: dict, gate: bool) -> int:
    if report["verdict"] == INCOMPARABLE:
        return 2  # refusal is unconditional: a non-comparison is not a pass
    if gate and report["verdict"] == FAIL:
        return 1
    return 0


def _trajectory(dirpath: str) -> List[str]:
    paths = sorted(glob.glob(os.path.join(dirpath, "BENCH_*.json")))
    if len(paths) < 2:
        paths = sorted(glob.glob(os.path.join(dirpath, "*.json")))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.perfdiff",
        description="per-config, per-phase bench regression gate",
    )
    ap.add_argument(
        "paths", nargs="+",
        help="two bench JSON files, or ONE directory of BENCH_*.json",
    )
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on regression (2 on incomparable runs)")
    ap.add_argument("--threshold-pct", type=float,
                    default=DEFAULT_THRESHOLD_PCT,
                    help="relative regression threshold per phase/value")
    ap.add_argument("--min-seconds", type=float, default=DEFAULT_MIN_SECONDS,
                    help="absolute per-phase noise floor in seconds")
    ap.add_argument("--json", action="store_true",
                    help="emit the comparison report as JSON")
    args = ap.parse_args(argv)
    if len(args.paths) == 1 and os.path.isdir(args.paths[0]):
        paths = []
        for p in _trajectory(args.paths[0]):
            try:
                load_record(p)
            except ValueError:
                # a failed run leaves a wrapper with no record (e.g. the
                # trajectory's rc!=0 entries): skip it, keep the axis
                print(f"skipping {p}: no bench record", file=sys.stderr)
                continue
            paths.append(p)
        if len(paths) < 2:
            print(f"{args.paths[0]}: fewer than two bench JSONs",
                  file=sys.stderr)
            return 2
    elif len(args.paths) == 2:
        paths = args.paths
    else:
        ap.error("pass exactly two bench JSON files or one directory")
        return 2  # unreachable (error raises); keeps the type checker calm
    reports = []
    for a, b in zip(paths, paths[1:]):
        rep = compare(
            load_record(a), load_record(b),
            threshold_pct=args.threshold_pct, min_seconds=args.min_seconds,
        )
        reports.append((a, b, rep))
        if args.json:
            out = dict(rep)
            out["old"], out["new"] = a, b
            print(json.dumps(out, sort_keys=True))
        else:
            print(render(rep, os.path.basename(a), os.path.basename(b)))
    # the gate rides the LAST pair: the trajectory's newest step
    return _exit_code(reports[-1][2], args.gate)


if __name__ == "__main__":
    raise SystemExit(main())
