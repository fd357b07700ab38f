"""Tally the long-haul smoke profile over many runs of one package, on the
CPU (ROADMAP §3 fault 9).

    python3 longhaul_tally.py --package dragonboat_tpu_torch --runs 150 --jobs 6 [--out FILE]

One run is tests/test_longhaul.py's test_longhaul_smoke_multi_round: the
scalar engine, master seed 0xD0C5 rotated, at most two 4 s rounds in a 25 s
budget, through `--package`'s `tools.longhaul` (the JAX package's runs pin
JAX to the CPU first). Each run is a process of its own; `--jobs` run at
once. Prints one JSON line per run (its rounds' verdicts, whether the run's
output reported a log hole, its seconds) and, last, the counts: runs, runs
with a false verdict, runs with `hashes_converged` false, runs with
`applied_converged` false, runs whose output reported a log hole, and runs
that ended without a report. `--out` also writes every line to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

_REPO = os.path.dirname(os.path.abspath(__file__))
MARK = "TALLY "


def one(package: str, out_dir: str) -> int:
    """A single smoke run; its verdicts on the last line after MARK."""
    if package == "dragonboat_tpu":
        from dragonboat_tpu._jaxenv import pin_cpu

        pin_cpu()
    import importlib

    L = importlib.import_module(package + ".tools.longhaul")
    report = L.run_longhaul(L.Options(
        budget_s=25.0, rounds_max=2, round_s=4.0, engine="scalar", out_dir=out_dir,
        seed=0xD0C5, rotate=True, ring=False))
    print(MARK + json.dumps({"ok": report["ok"],
                             "rounds": [r.verdicts for r in report["rounds"]]}), flush=True)
    return 0


def run(package: str, i: int, timeout_s: float) -> dict:
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="longhaul-tally-") as d:
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--package", package, "--one", d],
                capture_output=True, text=True, timeout=timeout_s, cwd=_REPO,
                env=dict(os.environ, PYTHONPATH=_REPO))
            text, rc = p.stdout + p.stderr, p.returncode
        except subprocess.TimeoutExpired as e:
            text, rc = (e.stdout or b"").decode() + (e.stderr or b"").decode(), None
    got = [ln[len(MARK):] for ln in text.splitlines() if ln.startswith(MARK)]
    rec = json.loads(got[-1]) if got else None
    return {"run": i, "rc": rc, "seconds": round(time.monotonic() - t0, 1),
            "log_hole": "log hole" in text,
            "ok": rec["ok"] if rec else None,
            "rounds": rec["rounds"] if rec else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="dragonboat_tpu_torch",
                    choices=("dragonboat_tpu_torch", "dragonboat_tpu"))
    ap.add_argument("--runs", type=int, default=150)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=180.0, help="seconds a run may take")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args.package, args.one)
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def false(r, verdict):
        return any(not v.get(verdict, True) for v in r["rounds"] or ())

    runs = []
    with ThreadPoolExecutor(args.jobs) as pool:
        for r in pool.map(lambda i: run(args.package, i, args.timeout), range(args.runs)):
            emit(r)
            runs.append(r)
    emit({"package": args.package, "runs": len(runs),
          "not_ok": sum(r["ok"] is False for r in runs),
          "hashes_converged_false": sum(false(r, "hashes_converged") for r in runs),
          "applied_converged_false": sum(false(r, "applied_converged") for r in runs),
          "log_hole": sum(r["log_hole"] for r in runs),
          "no_report": sum(r["ok"] is None for r in runs),
          "failed_verdicts": sorted({k for r in runs for v in r["rounds"] or ()
                                     for k, ok in v.items() if not ok})})
    return 0


if __name__ == "__main__":
    sys.exit(main())
