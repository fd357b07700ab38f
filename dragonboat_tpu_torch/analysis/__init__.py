"""`dragonboat_tpu_torch.analysis`: the static-analysis subsystem of the
PyTorch port.

A pure-AST rule engine (no imports of the checked code, no third-party
dependency in the process) plus the analyzer families for the failure
classes this architecture is exposed to:

  * silent hot-path regressions — host waits on the card in the engine
    step loop (`device-sync/*`: `.item()`, `.cpu()`, `.tolist()`,
    `.numpy()`, `.to("cpu")`, coercions and `np.asarray` of device
    tensors, `torch.cuda.synchronize()` and event/stream waits outside
    the two fetch seams), kernel builds on the launch path and host reads
    in the launch wrappers (`build/*`), plus the four hot-path families
    shared with the JAX package: `columnar/*`, `locks/lock-in-hot-loop`,
    `telemetry/unguarded`, `trace/unguarded-stamp`;
  * host-side lock-discipline races — a declared lock hierarchy and
    guarded-state map checked lexically (`locks/order`,
    `locks/guarded-state`) and over the call graph.

Entry points:

    python -m dragonboat_tpu_torch.tools.check [--json] [paths...]
    from dragonboat_tpu_torch.analysis import build_analyzer
    findings = build_analyzer().run()

Suppression: `# lint: allow(<rule-or-family>) <reason>` on the flagged
line (or alone on the line above). See engine.py for pragma semantics.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .engine import (
    Analyzer,
    CrossRule,
    Finding,
    FunctionInfo,
    LEGACY_MARK,
    Rule,
    SourceModule,
    unsuppressed,
)
from .targets import DEFAULT_TARGETS, LockSpec, Targets
from . import (
    rules_device,
    rules_hotpath,
    rules_locks,
    rules_retrace,
    rules_xlocks,
    rules_xretrace,
    rules_xsync,
)

#: bumped when the rule set / semantics change in a way that invalidates
#: stored baselines. Recorded in --json output so a run report pins WHICH
#: gate it passed.
RULES_VERSION = "torch-1.0"

#: every registered rule, in family order (hotpath -> device -> build ->
#: locks -> interprocedural); tools.check --list-rules renders this
ALL_RULES: List[Rule] = (
    list(rules_hotpath.RULES)
    + list(rules_device.RULES)
    + list(rules_retrace.RULES)
    + list(rules_locks.RULES)
    + list(rules_xlocks.RULES)
    + list(rules_xretrace.RULES)
    + list(rules_xsync.RULES)
)

FAMILIES = sorted({r.id.split("/", 1)[0] for r in ALL_RULES})


def rules_for_families(families: Iterable[str]) -> List[Rule]:
    fams = set(families)
    return [r for r in ALL_RULES if r.id.split("/", 1)[0] in fams]


def build_analyzer(
    families: Optional[Sequence[str]] = None,
    targets: Targets = DEFAULT_TARGETS,
    root: str = "",
) -> Analyzer:
    """The standard analyzer over the dragonboat_tpu_torch package root;
    narrow to specific rule families with `families=("columnar",
    "locks")`."""
    rules = ALL_RULES if families is None else rules_for_families(families)
    # pragma/unused is only meaningful when every rule ran: a family-
    # restricted run would call every other family's pragmas dead
    return Analyzer(rules, targets, root=root, unused_pragmas=families is None)


def run_default(paths: Optional[Sequence[str]] = None) -> List[Finding]:
    return build_analyzer().run(paths)


__all__ = [
    "ALL_RULES",
    "Analyzer",
    "CrossRule",
    "DEFAULT_TARGETS",
    "FAMILIES",
    "Finding",
    "FunctionInfo",
    "LEGACY_MARK",
    "LockSpec",
    "RULES_VERSION",
    "Rule",
    "SourceModule",
    "Targets",
    "build_analyzer",
    "rules_for_families",
    "run_default",
    "unsuppressed",
]
