"""Interprocedural lock discipline over the static call graph.

The lexical rules (rules_locks.py) see one function at a time; these see
the program. Three checks, all driven by callgraph.Program:

  locks/cross-function-order    — the held-lock set propagates through
      call edges: a function holding rank-N that (transitively) calls
      into an acquisition of an equal-or-outer rank is the same deadlock
      shape as a nested `with`, just split across frames — exactly where
      the lexical rule's blind spot was.
  locks/locked-callee-unheld    — VERIFY the `*_locked` caller-holds
      convention instead of trusting the suffix: a call to a `*_locked`
      method whose class declares exactly one lock must happen with that
      lock lexically held on the same receiver (or from a `*_locked`
      sibling / `__init__` of the same class). Call sites inside nested
      closures are their own functions with their own (usually empty)
      held set — which is precisely the "closure runs later, lock not
      held" bug the old per-function skip could never express.
  locks/blocking-under-hot-lock — fsync / .result() / sleep / queue
      waits reachable (transitively) while an engine-hot lock
      (targets.hot_locks) is held: every lane's step stalls behind one
      blocking call. `.wait()` on the condition that IS the held lock is
      the CV idiom and exempt.

Acquisition reachability deliberately ignores DEFERRED edges (closures
created here but called later): the closure does not run under the
caller's `with`, so its acquisitions are not nested inside it — flagging
them would be pure noise. The closure body is still checked on its own.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import FnKey, Program, lock_ref, resolve_lock_spec, walk_with_held
from .engine import CrossRule, Finding, FunctionInfo


def _chain_str(program: Program, chain: Tuple[FnKey, ...]) -> str:
    return " -> ".join(qn for _rp, qn in chain)


def _lexical_acquisitions(fn: FunctionInfo, targets):
    """(LockSpec, lineno) for every `with <lock>` in this function's own
    body (nested defs excluded — they are their own functions)."""
    out = []

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ref = lock_ref(item.context_expr)
                if ref is not None:
                    spec = resolve_lock_spec(fn, targets, *ref)
                    if spec is not None:
                        out.append((spec, node.lineno))
        for c in ast.iter_child_nodes(node):
            visit(c)

    for c in fn.node.body:
        visit(c)
    return out


def _acq_star(program: Program):
    """FnKey -> {(cls, attr) -> (LockSpec, witness chain)} of every lock
    acquisition reachable through non-deferred call edges (fixpoint;
    chains are first-discovered witnesses, cycles terminate on set
    membership)."""
    graph = program.graph
    targets = program.targets
    acc: Dict[FnKey, Dict[Tuple[str, str], Tuple[object, Tuple[FnKey, ...]]]] = {}
    for key, fn in graph.functions.items():
        acc[key] = {}
        for spec, _ln in _lexical_acquisitions(fn, targets):
            acc[key].setdefault((spec.cls, spec.attr), (spec, (key,)))
    changed = True
    while changed:
        changed = False
        for key in graph.functions:
            for site in graph.callees(key):
                for k2, (spec, chain) in acc.get(site.callee, {}).items():
                    if k2 not in acc[key]:
                        acc[key][k2] = (spec, (key,) + chain)
                        changed = True
    return acc


class CrossLockOrder(CrossRule):
    id = "locks/cross-function-order"
    doc = (
        "holding a declared lock across a call whose callee (transitively) "
        "acquires an equal-or-outer-ranked lock — the nested-with deadlock "
        "shape split across stack frames"
    )
    motivation = (
        "the lexical rule's documented blind spot; a lock taken "
        "by a callee was invisible, so the hierarchy was only enforced "
        "within single functions"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        acq = _acq_star(program)
        for site in program.graph.edges:
            if site.deferred or not site.held:
                continue
            caller_fn = program.graph.functions.get(site.caller)
            if caller_fn is None:
                continue
            for k2, (spec, chain) in sorted(acq.get(site.callee, {}).items()):
                for h in site.held:
                    if h.spec is None:
                        continue
                    if spec.rank > h.spec.rank:
                        continue
                    if spec is h.spec:
                        detail = (
                            "same lock reacquired through the call chain "
                            "(self-deadlock on one instance, undefined "
                            "order across two)"
                        )
                    else:
                        detail = "declared order is the reverse"
                    yield self.finding(
                        caller_fn,
                        site.node,
                        f"holds {h.spec.cls}.{h.spec.attr} (rank "
                        f"{h.spec.rank}) across a call that acquires "
                        f"{spec.cls}.{spec.attr} (rank {spec.rank}) via "
                        f"{_chain_str(program, chain)} — {detail}",
                    )


class LockedCalleeUnheld(CrossRule):
    id = "locks/locked-callee-unheld"
    doc = (
        "call to a `*_locked` method without its class's declared lock "
        "lexically held on the same receiver (callers named `*_locked` on "
        "the same class, and `__init__`, assert it instead) — the "
        "caller-holds convention, verified rather than trusted"
    )
    motivation = (
        "the `_locked` suffix was an unchecked comment; one "
        "call site that skips the lock makes the suffix a lie and the "
        "race invisible"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        targets = program.targets
        suffix = targets.locked_suffix
        for site in program.graph.edges:
            if site.deferred:
                continue  # a nested def EXISTS here; it is not CALLED here
            callee = program.graph.functions.get(site.callee)
            if callee is None or not callee.name.endswith(suffix):
                continue
            if callee.class_name is None:
                continue  # module-level helper: no declared class lock
            specs = [s for s in targets.locks if s.cls == callee.class_name]
            if len(specs) != 1:
                # multi-lock classes (VectorEngine, _Shard): WHICH lock a
                # given _locked method asserts is not declared — skip
                # rather than guess
                continue
            lock_attr = specs[0].attr
            caller = program.graph.functions.get(site.caller)
            if caller is None:
                continue
            # ANY lock held on the same receiver satisfies the convention:
            # classes keep auxiliary undeclared mutexes (Node._init_mu
            # guards the one-shot recovery path) and a `*_locked` callee
            # may assert one of those — the bug class this rule exists
            # for is the call with NOTHING held on the receiver
            held = any(h.root == site.recv_root for h in site.held)
            if held:
                continue
            same_class = (
                caller.class_name == callee.class_name
                and site.recv_root in ("self", "cls")
            )
            if same_class and (
                caller.name.endswith(suffix) or caller.name == "__init__"
            ):
                continue
            yield self.finding(
                caller,
                site.node,
                f"calls {callee.class_name}.{callee.name} without holding "
                f"{site.recv_root or '<recv>'}.{lock_attr} — `{suffix}` "
                f"methods assert the caller holds the class lock",
            )


# call shapes that block the calling thread
_BLOCKING_ATTRS = ("result", "wait", "wait_for")
_CV_WAITS = ("wait", "wait_for")


def _blocking_desc(node: ast.Call, held_refs) -> Optional[str]:
    """Describe a blocking call, or None. `.wait()`/`wait_for()` on a
    lock lexically held at the site is the CV idiom (you wait ON the
    lock you hold) and returns None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in ("fsync", "sleep"):
            return f"{f.attr}()"
        if f.attr in _BLOCKING_ATTRS:
            if f.attr in _CV_WAITS:
                recv = lock_ref(f.value)
                if recv is not None and recv in held_refs:
                    return None
            return f".{f.attr}()"
    elif isinstance(f, ast.Name) and f.id in ("fsync", "sleep"):
        return f"{f.id}()"
    return None


def _lexical_blocking(fn: FunctionInfo):
    """(desc, node) for each non-exempt blocking call in this function's
    own body."""
    out = []
    for kind, node, held_refs in walk_with_held(fn.node):
        if kind != "call":
            continue
        desc = _blocking_desc(node, held_refs)
        if desc is not None:
            out.append((desc, node))
    return out


def _blk_star(program: Program):
    """FnKey -> (desc, witness chain) for functions from which a
    (non-exempt) blocking call is reachable through non-deferred edges."""
    graph = program.graph
    acc: Dict[FnKey, Tuple[str, Tuple[FnKey, ...]]] = {}
    for key, fn in graph.functions.items():
        sites = _lexical_blocking(fn)
        if sites:
            acc[key] = (sites[0][0], (key,))
    changed = True
    while changed:
        changed = False
        for key in graph.functions:
            if key in acc:
                continue
            for site in graph.callees(key):
                w = acc.get(site.callee)
                if w is not None:
                    acc[key] = (w[0], (key,) + w[1])
                    changed = True
                    break
    return acc


class BlockingUnderHotLock(CrossRule):
    id = "locks/blocking-under-hot-lock"
    doc = (
        "a blocking call (fsync, .result(), sleep, queue/future wait) "
        "lexically or transitively reachable while an engine-hot lock "
        "(targets.hot_locks) is held — one blocked thread stalls every "
        "lane's step"
    )
    motivation = (
        "the step loop's locks gate all lanes; blocking I/O "
        "under one turns a per-node hiccup into a cluster-wide stall, "
        "and only a transitive check can see the fsync three frames down"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        targets = program.targets
        if not targets.hot_locks:
            return
        blk = _blk_star(program)
        for key, fn in program.graph.functions.items():
            # 1. blocking call directly under a hot `with`
            for kind, node, held_refs in walk_with_held(fn.node):
                if kind != "call":
                    continue
                desc = _blocking_desc(node, held_refs)
                if desc is None:
                    continue
                hot = self._hot_held(fn, targets, held_refs)
                if hot is None:
                    continue
                yield self.finding(
                    fn,
                    node,
                    f"{desc} while holding {hot.cls}.{hot.attr} "
                    f"(engine-hot) — blocks every lane's step",
                )
            # 2. hot lock held across an edge into blocking-reachable code
            for site in program.graph.callees(key):
                w = blk.get(site.callee)
                if w is None:
                    continue
                for h in site.held:
                    if targets.is_hot_lock_spec(h.spec):
                        yield self.finding(
                            fn,
                            site.node,
                            f"holds {h.spec.cls}.{h.spec.attr} (engine-hot) "
                            f"across a call that reaches {w[0]} via "
                            f"{_chain_str(program, w[1])}",
                        )
                        break

    @staticmethod
    def _hot_held(fn: FunctionInfo, targets, held_refs) -> Optional[object]:
        for r, a in held_refs:
            spec = resolve_lock_spec(fn, targets, r, a)
            if targets.is_hot_lock_spec(spec):
                return spec
        return None


RULES = [CrossLockOrder(), LockedCalleeUnheld(), BlockingUnderHotLock()]

__all__ = [
    "RULES",
    "BlockingUnderHotLock",
    "CrossLockOrder",
    "LockedCalleeUnheld",
]
