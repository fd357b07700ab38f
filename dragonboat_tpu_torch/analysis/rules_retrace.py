"""Kernel-build and launch-wrapper hazards: the `build` family.

The port has no jit: its kernels are `csrc/*.cu` sources that
`ops/cuda.build_kernels` compiles with nvcc and `ops/cuda._lib` loads
with ctypes, once per process, on first use. The counterpart of a JAX
retrace is therefore a kernel BUILD or library LOAD at run time — what
`profile.CompileWatch` counts and the e2e harness gates at 0 in its
measured window — and the counterpart of a traced value concretized in
kernel code is a tensor read on the host inside a launch wrapper, which
syncs the stream on every launch. Three rules here:

  * `build/build-in-hot` — a call that builds or loads kernels
    (`targets.build_calls`: `build_kernels`, `ctypes.CDLL`,
    `torch.utils.cpp_extension.load*`) written in a hot function or a
    launch wrapper. Only the blessed loader (`targets.blessed_build`,
    `ops/cuda.py:_lib`) may build, because it caches;
  * `build/host-read-in-launch` — `.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `.to("cpu")`, `int()/float()/bool()` or `np.asarray()`
    of a tensor inside a launch wrapper (`targets.launch_wrappers`);
  * `build/branch-in-launch` — a Python `if`/`while`/conditional
    expression/`assert` whose test reads a tensor inside a launch
    wrapper: the test calls `bool()` on it.

Tensor-valued names are the wrapper's non-static, non-defaulted
parameters, propagated through simple assignments. Static escapes —
`.shape`, `.dtype`, `.device`, `.ndim`, `.dim()`, `.size()`, `.numel()`,
`.stride()`, `.element_size()`, `.is_contiguous()`, `.data_ptr()`,
`len()`, `isinstance()`, `id()` — and identity tests (`x is None`) read
no tensor DATA: checking shapes and filling a parameter struct with
addresses is exactly what a launch wrapper is for.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from .engine import Finding, FunctionInfo, Rule
from .rules_device import COERCIONS, HOST_COPY_ATTRS, dotted_parts, is_np_array_call, to_cpu

STATIC_ATTRS = (
    "shape", "dtype", "device", "ndim", "dim", "size", "numel", "stride",
    "element_size", "is_contiguous", "data_ptr", "is_cuda", "nbytes",
)
STATIC_CALLS = ("len", "isinstance", "id", "type")


def _static_escaped_names(expr: ast.AST) -> Set[int]:
    """ids of Name nodes that only feed static accessors (x.shape, len(x))
    or identity tests (`x is None`) — reading them reads metadata or the
    Python object, not tensor data."""
    escaped: Set[int] = set()

    def mark(node):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                escaped.add(id(sub))

    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            mark(node.value)
        elif isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            mark(node)
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in STATIC_CALLS
        ):
            for a in node.args:
                mark(a)
    return escaped


def reading_names(expr: ast.AST, tensors: Set[str]) -> List[ast.Name]:
    """The Name nodes of `expr` that read tensor data: tensor-valued names
    outside a static escape."""
    escaped = _static_escaped_names(expr)
    return [
        node for node in ast.walk(expr)
        if isinstance(node, ast.Name)
        and node.id in tensors
        and id(node) not in escaped
    ]


def tensor_refs(expr: ast.AST, tensors: Set[str]) -> bool:
    """Does `expr` read a tensor-valued name outside a static escape?"""
    return bool(reading_names(expr, tensors))


def seed_params(fn: FunctionInfo, targets) -> Set[str]:
    """The non-static, non-defaulted parameters (minus self)."""
    args = fn.node.args
    params = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    n_defaults = len(args.defaults)
    defaulted = set(
        a.arg for a in (args.posonlyargs + args.args)[-n_defaults:]
    ) if n_defaults else set()
    defaulted |= {a.arg for a in args.kwonlyargs}
    return {
        p for p in params
        if p not in targets.static_param_names
        and p not in defaulted
        and p not in ("self", "cls")
    }


def propagate(fn: FunctionInfo, tensors: Set[str], value_tainted=None) -> Set[str]:
    """Close `tensors` over simple assignments to a FIXPOINT (ast.walk
    order is not source order, so one pass would miss taint flowing out
    of nested blocks)."""
    test = value_tainted or (lambda v: tensor_refs(v, tensors))
    while True:
        before = len(tensors)
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and test(node.value):
                for t in node.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            tensors.add(sub.id)
            elif isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Name
            ):
                if test(node.value):
                    tensors.add(node.target.id)
        if len(tensors) == before:
            return tensors


def tensor_name_set(fn: FunctionInfo, targets) -> Set[str]:
    return propagate(fn, seed_params(fn, targets))


def branch_sites(fn: FunctionInfo, reads):
    """(kind, node) of every if/while/conditional/assert whose test
    satisfies `reads(test)`."""
    for node in ast.walk(fn.node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if reads(node.test):
                kind = {
                    ast.If: "if", ast.While: "while", ast.IfExp: "conditional",
                    ast.Assert: "assert",
                }[type(node)]
                yield kind, node


def host_read_sites(fn: FunctionInfo, reads):
    """(what, node) of every host read of a value satisfying `reads`."""
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in COERCIONS:
            if node.args and reads(node.args[0]):
                yield f"{f.id}()", node
        elif is_np_array_call(f):
            if node.args and reads(node.args[0]):
                yield f"np.{f.attr}()", node
        elif isinstance(f, ast.Attribute) and reads(f.value):
            if f.attr == "item" or f.attr in HOST_COPY_ATTRS:
                yield f".{f.attr}()", node
            elif to_cpu(node):
                yield '.to("cpu")', node


def build_call_sites(fn: FunctionInfo, targets):
    """(dotted name, node) of every call that builds or loads kernels."""
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            parts = dotted_parts(node.func)
            if parts and targets.is_build_call(".".join(parts)):
                yield ".".join(parts), node


class BuildInHotFunction(Rule):
    id = "build/build-in-hot"
    doc = (
        "a call that builds or loads kernels (build_kernels, ctypes.CDLL, "
        "torch.utils.cpp_extension.load*) in a step-loop hot function or "
        "a launch wrapper — nvcc takes seconds per source and a library "
        "load takes a lock; only the cached loader ops/cuda.py:_lib may"
    )
    motivation = (
        "the port's counterpart of a recompile: one build on the step "
        "path stalls every lane for the nvcc run, and e2e gates window "
        "builds at 0 only for the configs it happens to run"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        key = fn.key()
        if key not in targets.hot_functions and key not in targets.launch_wrappers:
            return
        if key in targets.blessed_build:
            return
        for name, node in build_call_sites(fn, targets):
            yield self.finding(
                fn, node,
                f"{name}() builds or loads kernels on the launch path — "
                f"build once at setup through the cached loader",
            )


class HostReadInLaunch(Rule):
    id = "build/host-read-in-launch"
    doc = (
        ".item()/.tolist()/.cpu()/.numpy()/.to(\"cpu\")/int()/float()/"
        "bool()/np.asarray() of a tensor inside a kernel launch wrapper — "
        "a host sync on every launch"
    )
    motivation = (
        "a launch wrapper must only check metadata and fill the parameter "
        "struct; one data read makes every launch wait for the stream, "
        "and the launch gap becomes the step time"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.launch_wrappers:
            return
        tensors = tensor_name_set(fn, targets)
        if not tensors:
            return
        for what, node in host_read_sites(fn, lambda e: tensor_refs(e, tensors)):
            yield self.finding(
                fn, node,
                f"{what} of a tensor in a launch wrapper syncs every launch",
            )


class BranchInLaunch(Rule):
    id = "build/branch-in-launch"
    doc = (
        "a Python if/while/conditional expression/assert on tensor data "
        "inside a kernel launch wrapper — the test calls bool() on the "
        "tensor, a host sync on every launch"
    )
    motivation = (
        "the same hazard as a Python branch on a traced value: the "
        "kernel, not the host, decides per lane; a branch on device data "
        "in the wrapper serializes host and card"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.launch_wrappers:
            return
        tensors = tensor_name_set(fn, targets)
        if not tensors:
            return
        for kind, node in branch_sites(fn, lambda e: tensor_refs(e, tensors)):
            yield self.finding(
                fn, node,
                f"Python `{kind}` on tensor data in a launch wrapper "
                f"(decide in the kernel, or check metadata only)",
            )


RULES = [
    BuildInHotFunction(),
    HostReadInLaunch(),
    BranchInLaunch(),
]

__all__ = [
    "RULES",
    "BranchInLaunch",
    "BuildInHotFunction",
    "HostReadInLaunch",
    "STATIC_ATTRS",
    "branch_sites",
    "build_call_sites",
    "host_read_sites",
    "propagate",
    "reading_names",
    "seed_params",
    "tensor_name_set",
    "tensor_refs",
]
