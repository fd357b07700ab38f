"""Lock-discipline checking for the host runtime.

The lock hierarchy is DECLARED in targets.py (LockSpec table: rank,
owner class, role); these rules enforce it lexically:

  locks/order         — a `with` acquiring an equal-or-outer-ranked lock
                        while an inner-ranked one is held: the textbook
                        deadlock shape (two threads, opposite orders).
  locks/guarded-state — a write to declared guarded shared state outside
                        its lock. Two shipped races (snapshot index/data
                        skew, logdb compaction-vs-append lost update) were
                        exactly this: documented-shared-state mutated on a
                        path that skipped the documented lock.

Conventions honored:
  * methods named `*_locked` assert the caller holds the lock (the
    in-tree convention: `_admit_locked`, `_pop_locked`, ...);
  * `__init__` is exempt (no concurrent access before publication);
  * nested `def`s do not inherit the enclosing `with` — they run later,
    possibly without the lock (each is checked separately).

Limits (documented, not hidden): THESE rules are lexical and
per-function; lock objects are recognized by `<root>.<attr>` shape with
class resolution via `self`/declared variable hints. The interprocedural
counterparts live in rules_xlocks.py on top of the static call graph
(callgraph.py): locks taken by callees, the `*_locked` caller-holds
convention, and blocking calls under engine-hot locks are checked there.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .engine import Finding, FunctionInfo, Rule
from .rules_device import dotted_parts

# mutating method names on containers/deques/sets/dicts
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "pop",
        "popleft",
        "popitem",
        "clear",
        "add",
        "discard",
        "remove",
        "update",
        "difference_update",
        "intersection_update",
        "setdefault",
        "insert",
        "rotate",
        "write",  # mmap/file-like guarded handles
        "flush",
        "close",
    }
)


def _lock_ref(expr: ast.AST) -> Optional[Tuple[str, str]]:
    """`self._mu` / `sh._wmu` / `self._sq._cv` -> (dotted root, attr);
    None otherwise."""
    parts = dotted_parts(expr)
    if parts is None or len(parts) < 2:
        return None
    return ".".join(parts[:-1]), parts[-1]


def _resolve_spec(fn: FunctionInfo, targets, root: str, attr: str):
    if root == "self":
        return targets.lock_rank(fn.class_name, attr, fn.module)
    cls = targets.lock_var_hints.get(root)
    if cls is not None:
        return targets.lock_rank(cls, attr, fn.module)
    # unambiguous attr (exactly one spec with that name) still resolves
    matches = [s for s in targets.locks if s.attr == attr]
    return matches[0] if len(matches) == 1 else None


def _walk_with_stack(fn_node, on_with=None, on_node=None):
    """Walk a function body tracking lexically-held `with` items; nested
    function defs are NOT entered (their bodies run later, lock-free)."""

    held: List[Tuple[ast.With, ast.AST]] = []  # (with stmt, context expr)

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # checked as its own FunctionInfo
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if on_with is not None:
                on_with(node, held)
            for item in node.items:
                held.append((node, item.context_expr))
            for c in node.body:
                visit(c)
            del held[len(held) - len(node.items):]
            return
        if on_node is not None:
            on_node(node, held)
        for c in ast.iter_child_nodes(node):
            visit(c)

    for c in fn_node.body:
        visit(c)


class LockOrder(Rule):
    id = "locks/order"
    doc = (
        "nested `with` acquiring a lock ranked at-or-above one already "
        "held (declared hierarchy: analysis/targets.py LockSpec table) — "
        "the opposite-order deadlock shape"
    )
    motivation = (
        "the shipped concurrency bugs all lived at lock boundaries; the "
        "hierarchy table makes the intended order checkable instead of "
        "tribal"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        out: List[Finding] = []

        def on_with(node, held):
            specs_held = []
            for _w, expr in held:
                ref = _lock_ref(expr)
                if ref is None:
                    continue
                spec = _resolve_spec(fn, targets, *ref)
                if spec is not None:
                    specs_held.append((spec, ref))
            if not specs_held:
                return
            for item in node.items:
                ref = _lock_ref(item.context_expr)
                if ref is None:
                    continue
                spec = _resolve_spec(fn, targets, *ref)
                if spec is None:
                    continue
                for h, href in specs_held:
                    if href == ref:
                        continue  # the same lock EXPRESSION (reentrancy
                        # is a different bug class; keep the signal clean)
                    if spec.rank <= h.rank:
                        # h is spec with a DIFFERENT root is the
                        # two-instance AB/BA shape (self._mu then
                        # node._mu on another instance of the same
                        # class): undefined instance order, so it flags
                        detail = (
                            "two instances of the same lock with no "
                            "defined instance order"
                            if h is spec
                            else "declared order is the reverse"
                        )
                        out.append(
                            self.finding(
                                fn,
                                node,
                                f"acquires {spec.cls}.{spec.attr} "
                                f"(rank {spec.rank}) while holding "
                                f"{h.cls}.{h.attr} (rank {h.rank}) — "
                                f"{detail}",
                            )
                        )

        _walk_with_stack(fn.node, on_with=on_with)
        return out


class GuardedStateWrite(Rule):
    id = "locks/guarded-state"
    doc = (
        "write/mutation of declared guarded shared state "
        "(targets.guarded_state) outside a lexical `with` on its "
        "declared lock (methods named *_locked assert the caller holds "
        "it; __init__ is exempt)"
    )
    motivation = (
        "two shipped races had exactly this shape: snapshot "
        "index/data skew and the logdb compaction-vs-append lost update"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        module_map = targets.guarded_state.get(fn.module.relpath)
        if not module_map:
            return []
        if fn.name == "__init__" or fn.name.endswith(targets.locked_suffix):
            return []
        out: List[Finding] = []

        def guard_for(root: str, field_name: str) -> Optional[str]:
            """The lock attr guarding <root>.<field>, or None."""
            if root == "self":
                for cls, fields in module_map.items():
                    if field_name in fields and fn.module.is_subclass_of(
                        fn.class_name, cls
                    ):
                        return fields[field_name]
                return None
            for fields in module_map.values():
                if field_name in fields:
                    return fields[field_name]
            return None

        def held_locks(held):
            refs = set()
            for _w, expr in held:
                ref = _lock_ref(expr)
                if ref is not None:
                    refs.add(ref)
            return refs

        def attr_write_target(node) -> List[Tuple[str, str, ast.AST]]:
            """(root, field, node) for each guarded-shape write target."""
            targets_ = []
            if isinstance(node, ast.Assign):
                tgts = node.targets
            elif isinstance(node, (ast.AugAssign,)):
                tgts = [node.target]
            elif isinstance(node, ast.Delete):
                tgts = node.targets
            else:
                return targets_
            for t in tgts:
                base = t
                if isinstance(base, ast.Subscript):
                    base = base.value  # self._lanes[key] = ...
                parts = dotted_parts(base)
                if parts is not None and len(parts) == 2:
                    targets_.append((parts[0], parts[1], t))
            return targets_

        def on_node(node, held):
            # 1. assignments / deletions
            for root, field_name, t in attr_write_target(node):
                lock = guard_for(root, field_name)
                if lock is None:
                    continue
                if (root, lock) not in held_locks(held):
                    out.append(
                        self.finding(
                            fn,
                            node,
                            f"writes {root}.{field_name} outside "
                            f"`with {root}.{lock}` (declared guard)",
                        )
                    )
            # 2. mutating method calls: self._bulk.append(...)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
            ):
                parts = dotted_parts(node.func.value)
                if parts is None or len(parts) != 2:
                    return
                root, field_name = parts
                lock = guard_for(root, field_name)
                if lock is None:
                    return
                if (root, lock) not in held_locks(held):
                    out.append(
                        self.finding(
                            fn,
                            node,
                            f"mutates {root}.{field_name}."
                            f"{node.func.attr}() outside "
                            f"`with {root}.{lock}` (declared guard)",
                        )
                    )

        _walk_with_stack(fn.node, on_node=on_node)
        return out


RULES = [LockOrder(), GuardedStateWrite()]

__all__ = ["RULES", "GuardedStateWrite", "LockOrder"]
