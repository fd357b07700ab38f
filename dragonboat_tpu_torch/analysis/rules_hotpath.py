"""The four migrated hot-path rule families.

These started life as ad-hoc AST checks embedded in a test file; they
live here, on the shared engine, with pragma-based suppression.

  columnar/*   — per-element host work in the step loop (the 340x
                 kernel-vs-e2e regression class the columnar fan-out
                 closed)
  locks/lock-in-hot-loop
               — lock acquisition inside a per-message/per-lane loop in a
                 hot function (the transport rule, generalized to the
                 whole step loop)
  telemetry/unguarded
               — histogram/recorder appends in hot functions without a
                 sampling gate
  trace/unguarded-stamp
               — causal-trace stamping outside the sampled path (unsampled
                 requests stay allocation- and event-free)
"""
from __future__ import annotations

import ast
from typing import Iterable

from .engine import (
    Finding,
    FunctionInfo,
    Rule,
    guard_test_is_sampling_gate,
)

_TELEMETRY_CALLS = ("observe", "record")


class ColumnarItemInLoop(Rule):
    id = "columnar/item-in-loop"
    doc = (
        ".tolist()/.item() inside a for/while body of a step-loop hot "
        "function (column-level .tolist() OUTSIDE loops is the fast idiom)"
    )
    motivation = (
        "per-(group, peer) scalar reads were the 340x kernel-vs-e2e "
        "gap; one creeping .item() per message silently reopens it"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        for _loop, sub in self.loop_body_nodes(fn.node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("tolist", "item")
            ):
                yield self.finding(
                    fn, sub, f".{sub.func.attr}() inside a hot loop"
                )


class ColumnarScalarIndexInLoop(Rule):
    id = "columnar/scalar-index-in-loop"
    doc = (
        "int(x[...]) scalar conversion of a subscripted value inside a "
        "for/while body of a hot function (a per-element mirror read)"
    )
    motivation = "same regression class as columnar/item-in-loop"

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        for _loop, sub in self.loop_body_nodes(fn.node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "int"
                and sub.args
                and isinstance(sub.args[0], ast.Subscript)
            ):
                yield self.finding(
                    fn, sub, "per-element int(x[...]) inside a hot loop"
                )


class LockInHotLoop(Rule):
    id = "locks/lock-in-hot-loop"
    doc = (
        "`with <lock>` inside a for/while body of a hot function — every "
        "lock on the step/send path must cover the whole batch, not one "
        "message (bulk seams: _SendQueue.put_many / Transport.send_many / "
        "try_local_deliver_many)"
    )
    motivation = (
        "a per-message lock acquisition silently reintroduces "
        "O(messages) synchronization per step"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if not targets.is_hot_lock(fn.key()):
            return
        for _loop, sub in self.loop_body_nodes(fn.node):
            if isinstance(sub, ast.With):
                yield self.finding(
                    fn, sub, "lock acquisition inside a per-message loop"
                )


class _GuardedVisitRule(Rule):
    """Shared machinery for the sampling-guard families: walk a function
    tracking whether the current node sits under an `if` whose condition
    references a sampling/latency gate."""

    def _visit(self, node: ast.AST, guarded: bool, emit) -> None:
        if isinstance(node, ast.If):
            g = guarded or guard_test_is_sampling_gate(node.test)
            for c in node.body:
                self._visit(c, g, emit)
            for c in node.orelse:
                self._visit(c, guarded, emit)
            return
        if not guarded:
            emit(node)
        for c in ast.iter_child_nodes(node):
            self._visit(c, guarded, emit)


class UnguardedTelemetry(_GuardedVisitRule):
    id = "telemetry/unguarded"
    doc = (
        "Histogram.observe()/recorder.record() in a hot function outside "
        "a sampling guard — telemetry on the step path must be 1-in-N or "
        "anomaly-only, never per-call"
    )
    motivation = (
        "per-message unconditional telemetry is exactly the "
        "O(messages) host work the columnar refactor removed"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_telemetry_functions:
            return []
        out = []

        def emit(node):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TELEMETRY_CALLS
            ):
                out.append(
                    self.finding(
                        fn,
                        node,
                        f"unguarded .{node.func.attr}() telemetry in a hot "
                        f"function",
                    )
                )

        self._visit(fn.node, False, emit)
        return out


class UnguardedTraceStamp(_GuardedVisitRule):
    id = "trace/unguarded-stamp"
    doc = (
        "mint_trace_id() calls, `.trace_id = ...` writes and recorder "
        "appends in a hot function outside the sampling gate (passing a "
        "zero trace id through a constructor stays free and allowed)"
    )
    motivation = (
        "trace ids ride the sampled LatencyTrace path only; "
        "unsampled requests must stay allocation- and event-free"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_trace_functions:
            return []
        out = []

        def emit(node):
            if isinstance(node, ast.Call):
                f = node.func
                name = (
                    f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute)
                    else ""
                )
                if name == "mint_trace_id":
                    out.append(
                        self.finding(
                            fn, node,
                            "unguarded mint_trace_id() in a hot function",
                        )
                    )
                elif name in _TELEMETRY_CALLS and isinstance(f, ast.Attribute):
                    out.append(
                        self.finding(
                            fn, node,
                            f"unguarded .{name}() telemetry in a hot function",
                        )
                    )
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in tgts:
                    if isinstance(t, ast.Attribute) and t.attr == "trace_id":
                        out.append(
                            self.finding(
                                fn, node,
                                "unguarded .trace_id stamp in a hot function",
                            )
                        )

        self._visit(fn.node, False, emit)
        return out


RULES = [
    ColumnarItemInLoop(),
    ColumnarScalarIndexInLoop(),
    LockInHotLoop(),
    UnguardedTelemetry(),
    UnguardedTraceStamp(),
]

__all__ = [
    "RULES",
    "ColumnarItemInLoop",
    "ColumnarScalarIndexInLoop",
    "LockInHotLoop",
    "UnguardedTelemetry",
    "UnguardedTraceStamp",
]
