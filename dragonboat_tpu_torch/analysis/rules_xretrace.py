"""Cross-function kernel-build hazards over the static call graph.

The lexical `build/*` rules see one function: a `build_kernels()` moved
into a helper of the step loop, or a tensor handed from a launch wrapper
to a helper that reads it on the host, escaped them. Two passes here:

  * `build/cross-function` — reachability: BFS from every hot function
    and launch wrapper (non-deferred edges plus constructor edges, see
    rules_xsync.reach), never entering the blessed loader
    (`targets.blessed_build`, `ops/cuda.py:_lib`, which builds once and
    caches); every reached helper is scanned for calls that build or
    load kernels. The finding carries the chain from the hot root.
  * `build/cross-function-taint` — a program-wide fixpoint of tensor
    taint born in the launch wrappers' parameters: a call argument that
    reads a tainted name taints the callee parameter (positional and
    keyword; `self` skipped for method and constructor calls;
    `targets.static_param_names` never taint; static escapes such as
    `x.shape` or `x.data_ptr()` kill taint at the argument); a callee
    whose return reads taint taints the name its caller assigns.
    Findings are host reads and Python branches on tainted data at the
    sites the lexical rules provably miss, each with the provenance of
    the taint.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .callgraph import FnKey, Program
from .engine import CrossRule, Finding, FunctionInfo
from .rules_retrace import (
    branch_sites,
    build_call_sites,
    host_read_sites,
    propagate,
    reading_names,
    seed_params,
    tensor_refs,
)
from .rules_xsync import call_edges, chain_text, reach


class CrossFunctionBuild(CrossRule):
    id = "build/cross-function"
    doc = (
        "a call that builds or loads kernels (build_kernels, ctypes.CDLL, "
        "torch.utils.cpp_extension.load*) in a helper REACHABLE from a hot "
        "function or a launch wrapper without passing the cached loader "
        "ops/cuda.py:_lib — a build on the step path, frames down"
    )
    motivation = (
        "moving a build or load into a helper must not launder it past "
        "the build-once architecture; the lexical rule sees only the "
        "function it is written in"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        targets = program.targets
        roots = set(targets.hot_functions) | set(targets.launch_wrappers)
        reached = reach(program, roots, set(targets.blessed_build))
        for key in sorted(reached):
            fn = program.graph.functions.get(key)
            if fn is None:
                continue
            for name, node in build_call_sites(fn, targets):
                yield self.finding(
                    fn, node,
                    f"{name}() reachable from the launch path "
                    f"({chain_text(reached[key])}) outside the cached "
                    f"loader — a kernel build or load per call",
                )


def _param_names(fn: FunctionInfo) -> Tuple[List[str], List[str]]:
    a = fn.node.args
    return (
        [p.arg for p in a.posonlyargs + a.args],
        [p.arg for p in a.kwonlyargs],
    )


def _binds_self(call: ast.Call, graph) -> bool:
    """A method or constructor call binds the callee's first parameter
    implicitly, unless the receiver is a class name (`Cls.m(obj, ...)`)."""
    f = call.func
    if isinstance(f, ast.Name):
        return True  # a constructor call: Cls(...) -> __init__(self, ...)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id not in graph._classes
    return True


class _Taint:
    """Tensor taint from the launch wrappers, to a fixpoint."""

    def __init__(self, program: Program) -> None:
        self.program = program
        self.targets = program.targets
        graph = program.graph
        self.seeds: Dict[FnKey, Set[str]] = {
            k: seed_params(graph.functions[k], self.targets)
            for k in self.targets.launch_wrappers if k in graph.functions
        }
        #: callee param names tainted by some caller
        self.params: Dict[FnKey, Set[str]] = {}
        #: provenance: (key, param) -> (caller key, call line)
        self.prov: Dict[Tuple[FnKey, str], Tuple[FnKey, int]] = {}
        #: functions whose return value reads taint
        self.returns: Set[FnKey] = set()
        self._edges: Dict[FnKey, List[Tuple[FnKey, ast.Call]]] = {}
        self._fixpoint()

    def edges(self, key: FnKey):
        if key not in self._edges:
            self._edges[key] = call_edges(self.program, key)
        return self._edges[key]

    def local(self, key: FnKey, precise: bool = False) -> Set[str]:
        """Tainted names of one function: its seeds (unless `precise`),
        caller-fed params, closed over assignments and calls to
        taint-returning functions."""
        fn = self.program.graph.functions[key]
        names = set() if precise else set(self.seeds.get(key, ()))
        names |= self.params.get(key, set())
        if not names:
            return names
        resolved = {id(n): c for c, n in self.edges(key)}

        def value_tainted(value: ast.AST) -> bool:
            # a call the graph resolves is tainted by its RETURN only
            # (helpers take tensors and hand back metadata); the arguments
            # of an unresolved call (torch.*, builtins) taint its result
            hidden = set()
            for sub in ast.walk(value):
                if isinstance(sub, ast.Call) and id(sub) in resolved:
                    if resolved[id(sub)] in self.returns:
                        return True
                    for arg in sub.args + [k.value for k in sub.keywords]:
                        hidden.update(id(n) for n in ast.walk(arg))
            return any(id(n) not in hidden for n in reading_names(value, names))

        return propagate(fn, names, value_tainted)

    def _fixpoint(self) -> None:
        graph = self.program.graph
        static = self.targets.static_param_names
        changed = True
        while changed:
            changed = False
            for key in sorted(set(self.seeds) | set(self.params)):
                fn = graph.functions[key]
                names = self.local(key)
                if not names:
                    continue
                if key not in self.returns:
                    precise = self.local(key, precise=True)
                    if precise and any(
                        isinstance(n, ast.Return) and n.value is not None
                        and tensor_refs(n.value, precise)
                        for n in ast.walk(fn.node)
                    ):
                        self.returns.add(key)
                        changed = True
                for callee_key, call in self.edges(key):
                    callee = graph.functions.get(callee_key)
                    if callee is None:
                        continue
                    pos, kwonly = _param_names(callee)
                    if pos and pos[0] in ("self", "cls") and _binds_self(call, graph):
                        pos = pos[1:]
                    tgt = self.params.setdefault(callee_key, set())
                    bound = list(zip(pos, call.args))
                    bound += [
                        (kw.arg, kw.value) for kw in call.keywords
                        if kw.arg in pos or kw.arg in kwonly
                    ]
                    for i, (p, arg) in enumerate(bound):
                        if isinstance(arg, ast.Starred):
                            break
                        if p in static or p in tgt:
                            continue
                        if tensor_refs(arg, names):
                            tgt.add(p)
                            self.prov.setdefault(
                                (callee_key, p), (key, call.lineno)
                            )
                            changed = True

    def chain(self, key: FnKey, names: Set[str]) -> str:
        """The provenance of the first tainted param among `names`, back
        toward a launch wrapper (bounded)."""
        graph = self.program.graph
        hops: List[str] = []
        cur, cur_names = key, names
        for _ in range(6):
            hit = next(
                ((p, self.prov[(cur, p)]) for p in sorted(cur_names)
                 if (cur, p) in self.prov),
                None,
            )
            if hit is None:
                break
            p, (caller, line) = hit
            caller_fn = graph.functions[caller]
            hops.append(
                f"`{p}` of {graph.functions[cur].qualname} tainted by "
                f"{caller_fn.qualname} ({caller_fn.module.relpath}:{line})"
            )
            cur = caller
            cur_names = self.params.get(caller, set()) | self.seeds.get(caller, set())
        return "; ".join(hops) if hops else "via call-return taint"


class CrossFunctionTensorTaint(CrossRule):
    id = "build/cross-function-taint"
    doc = (
        "a host read (.item()/.cpu()/int()/np.asarray ...) or a Python "
        "branch on tensor data that arrived from a kernel launch wrapper "
        "through a CALL CHAIN — the per-launch sync the lexical rules "
        "flag, at the sites they provably cannot see"
    )
    motivation = (
        "a launch wrapper hands its tensors to checking and struct-filling "
        "helpers; a data read in one of them syncs every launch exactly "
        "like one in the wrapper"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        taint = _Taint(program)
        for key in sorted(set(taint.seeds) | set(taint.params)):
            fn = program.graph.functions[key]
            cross = taint.local(key)
            if not cross:
                continue
            lexical = taint.seeds.get(key, set())
            lexical = propagate(fn, set(lexical)) if lexical else set()

            def new_taint(expr: ast.AST) -> bool:
                return tensor_refs(expr, cross) and not tensor_refs(expr, lexical)

            for kind, node in branch_sites(fn, new_taint):
                yield self.finding(
                    fn, node,
                    f"Python `{kind}` on tensor data from a launch wrapper "
                    f"({taint.chain(key, cross)}) — a sync per launch",
                )
            for what, node in host_read_sites(fn, new_taint):
                yield self.finding(
                    fn, node,
                    f"{what} of tensor data from a launch wrapper "
                    f"({taint.chain(key, cross)}) — a sync per launch",
                )


RULES = [CrossFunctionBuild(), CrossFunctionTensorTaint()]

__all__ = ["RULES", "CrossFunctionBuild", "CrossFunctionTensorTaint"]
