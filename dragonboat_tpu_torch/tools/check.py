"""`python -m dragonboat_tpu_torch.tools.check` — run the static analyzers
of the PyTorch port.

Runs every registered rule family (see `dragonboat_tpu_torch.analysis`)
over the port's package source (or explicit paths), prints findings, and
exits non-zero when any UNSUPPRESSED finding remains — the tier-1 gate
(tests/test_torch_static_analysis.py) is exactly this call.

    python -m dragonboat_tpu_torch.tools.check                 # whole package
    python -m dragonboat_tpu_torch.tools.check engine/vector.py
    python -m dragonboat_tpu_torch.tools.check --json          # machine output
    python -m dragonboat_tpu_torch.tools.check --list-rules    # the rule table
    python -m dragonboat_tpu_torch.tools.check --family locks  # one family
    python -m dragonboat_tpu_torch.tools.check --changed       # vs HEAD
    python -m dragonboat_tpu_torch.tools.check --changed main  # vs a ref
    python -m dragonboat_tpu_torch.tools.check --baseline snap.json

`--changed [REF]` (default HEAD) still ANALYZES the whole tree — the
interprocedural families need the full call graph — but only REPORTS
findings in files `git diff --name-only REF` touched, plus the modules
that CALL into them (a changed callee creates findings at its call
sites). `--baseline FILE` compares against a stored `--json` snapshot:
only NEW unsuppressed findings fail, and fixed ones are counted — the
ratchet mode for landing the gate on a tree with known debt.

Suppressed findings are counted and visible with --show-suppressed (and
always present in --json with "suppressed": true); a suppression without
a reason is itself a finding, and on full runs a suppression that
suppresses NOTHING is one too (pragma/unused).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set, Tuple

from ..analysis import (
    ALL_RULES,
    FAMILIES,
    RULES_VERSION,
    Finding,
    build_analyzer,
    unsuppressed,
)


def _list_rules() -> str:
    lines = []
    fam = None
    for r in ALL_RULES:
        f = r.id.split("/", 1)[0]
        if f != fam:
            fam = f
            lines.append(f"[{fam}]")
        lines.append(f"  {r.id}")
        lines.append(f"      catches: {r.doc}")
        lines.append(f"      why:     {r.motivation}")
    return "\n".join(lines)


def _finding_relpath(f: Finding, root: str) -> str:
    p = f.path
    if os.path.isabs(p):
        p = os.path.relpath(p, root)
    return p.replace(os.sep, "/")


def _git_changed_relpaths(
    ref: str, root: str
) -> Tuple[Optional[Set[str]], str]:
    """Package-relative paths of .py files changed vs `ref` (tracked
    diff + untracked), limited to files under the analyzer root.
    (None, error) when git fails — the caller must NOT fall back to a
    full-pass-looking empty set."""

    def git(args: List[str], cwd: str) -> str:
        return subprocess.run(
            ["git"] + args,
            cwd=cwd,
            capture_output=True,
            text=True,
            check=True,
        ).stdout

    try:
        top = git(["rev-parse", "--show-toplevel"], root).strip()
        names = git(["diff", "--name-only", ref], top)
        names += git(["ls-files", "--others", "--exclude-standard"], top)
    except (OSError, subprocess.CalledProcessError) as e:
        err = getattr(e, "stderr", "") or str(e)
        return None, err.strip()
    rels: Set[str] = set()
    absroot = os.path.abspath(root)
    for line in names.splitlines():
        line = line.strip()
        if not line or not line.endswith(".py"):
            continue
        rp = os.path.relpath(os.path.join(top, line), absroot)
        if rp.startswith(".."):
            continue
        rels.add(rp.replace(os.sep, "/"))
    return rels, ""


def _load_baseline(path: str, root: str) -> Set[Tuple[str, str, str]]:
    """(rule, relpath, message) of every unsuppressed finding in a stored
    --json snapshot (either the full object or a bare findings list)."""
    with open(path, "r", encoding="utf-8") as fp:
        data = json.load(fp)
    items = data.get("findings", []) if isinstance(data, dict) else data
    out: Set[Tuple[str, str, str]] = set()
    absroot = os.path.abspath(root)
    for d in items:
        if d.get("suppressed"):
            continue
        p = d.get("path", "").replace(os.sep, "/")
        # stored snapshots hold whatever paths the run printed (absolute
        # for tree walks): root-relative first, then the package tail so
        # baselines travel between checkouts
        if os.path.isabs(p):
            rp = os.path.relpath(p, absroot).replace(os.sep, "/")
            if not rp.startswith(".."):
                p = rp
        if "dragonboat_tpu_torch/" in p:
            p = p.split("dragonboat_tpu_torch/", 1)[1]
        out.add((d.get("rule", ""), p, d.get("message", "")))
    return out


def _baseline_key(f: Finding, root: str) -> Tuple[str, str, str]:
    p = _finding_relpath(f, root)
    if "dragonboat_tpu_torch/" in p:
        p = p.split("dragonboat_tpu_torch/", 1)[1]
    return (f.rule, p, f.message)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.tools.check",
        description="static analysis over the dragonboat_tpu_torch source tree",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/directories (default: the dragonboat_tpu_torch package)",
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--family",
        action="append",
        choices=FAMILIES,
        help="restrict to a rule family (repeatable)",
    )
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print pragma-suppressed findings",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    ap.add_argument(
        "--root",
        default="",
        help="package root for target matching (default: the installed "
        "dragonboat_tpu_torch directory) — point it at a checkout/overlay to "
        "lint out-of-tree files against the same targets",
    )
    ap.add_argument(
        "--changed",
        nargs="?",
        const="HEAD",
        default=None,
        metavar="REF",
        help="report only findings in files changed vs REF (default "
        "HEAD) plus modules calling into them; the whole tree is still "
        "analyzed so the interprocedural families stay sound",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="compare against a stored --json snapshot: exit non-zero "
        "only on NEW unsuppressed findings; fixed ones are counted",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    analyzer = build_analyzer(families=args.family, root=args.root)
    findings = analyzer.run(args.paths or None)

    note = ""
    if args.changed is not None:
        changed, err = _git_changed_relpaths(args.changed, analyzer.root)
        if changed is None:
            print(
                f"dragonboat_tpu_torch.tools.check: --changed needs git: {err}",
                file=sys.stderr,
            )
            return 2
        scope = set(changed)
        if analyzer.last_program is not None:
            scope |= analyzer.last_program.graph.caller_modules_of(changed)
        findings = [
            f for f in findings if _finding_relpath(f, analyzer.root) in scope
        ]
        note = (
            f" [--changed {args.changed}: {len(changed)} file(s) "
            f"+ {len(scope) - len(changed)} caller module(s)]"
        )

    failing = unsuppressed(findings)
    n_suppressed = len(findings) - len(failing)

    baseline_info = None
    if args.baseline is not None:
        try:
            base = _load_baseline(args.baseline, analyzer.root)
        except (OSError, ValueError) as e:
            print(
                f"dragonboat_tpu_torch.tools.check: cannot read baseline "
                f"{args.baseline}: {e}",
                file=sys.stderr,
            )
            return 2
        keys = {_baseline_key(f, analyzer.root) for f in failing}
        new = [
            f for f in failing if _baseline_key(f, analyzer.root) not in base
        ]
        baseline_info = {
            "file": args.baseline,
            "new": len(new),
            "fixed": len(base - keys),
        }
        failing = new

    if args.json:
        out = {
            "findings": [f.to_dict() for f in findings],
            "unsuppressed": len(failing),
            "suppressed": n_suppressed,
            "ok": not failing,
            "rule_version": RULES_VERSION,
        }
        if baseline_info is not None:
            out["baseline"] = baseline_info
        print(json.dumps(out, indent=2, sort_keys=True))
        return 1 if failing else 0

    shown = findings if args.show_suppressed else failing
    for f in shown:
        print(f.render())
    tail = (
        f"{len(failing)} finding(s), {n_suppressed} suppressed"
        if findings
        else "clean"
    )
    if baseline_info is not None:
        tail += (
            f" [baseline {baseline_info['file']}: {baseline_info['new']} "
            f"new, {baseline_info['fixed']} fixed]"
        )
    print(f"dragonboat_tpu_torch.tools.check: {tail}{note}")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
