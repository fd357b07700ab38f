"""Device-sync detection: host waits on the card in the step loop.

The port's step loop is built around exactly ONE host wait per step:
`VectorEngine._fetch_output` waits on the event `_ship_output` recorded
after the async copy of the whole StepOutput into a pinned host slot
(`_fetch_super` is its once-per-K-steps twin). Everything after it works
on numpy views of that slot. Any OTHER host read of a tensor on the card
in a hot function blocks the host until the stream drains, and the next
launch is queued only after it: the decode no longer overlaps the
kernel, and no test fails — the e2e numbers just quietly decay.

What counts as a sync in PyTorch, each a rule here:

  * `torch.cuda.synchronize()`, and `.synchronize()` on a
    `torch.cuda.Event` or `Stream` — an explicit wait. The runtime
    `profile.SyncAudit` wraps `torch.cuda.synchronize` and the tensor
    reads, but not event or stream waits: this rule is the only guard
    against a second `ev.synchronize()` in the loop;
  * `.item()` or `int()/float()/bool()` of a device value — a scalar
    copy to the host;
  * `.cpu()`, `.numpy()`, `.tolist()`, `.to("cpu")` /
    `.to(device="cpu")` and `np.asarray()/np.array()` of a device value —
    a whole-tensor copy to the host, synchronous with the stream;
  * scalar indexing of a device tensor inside a loop — each read is a
    blocking copy and each write a kernel launch, per iteration.

Device values are recognized by dotted-prefix roots declared in
`targets.device_roots` (the engine's device state `self._state`, the
residual inbox, the device staging planes and the pinned output slots);
the heuristic is deliberately narrow — a false negative costs a missed
review comment, a false positive costs everyone a pragma.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from .engine import Finding, FunctionInfo, Rule

#: attribute calls that copy a whole tensor to the host
HOST_COPY_ATTRS = ("cpu", "numpy", "tolist")
COERCIONS = ("int", "float", "bool")


def dotted_parts(expr: ast.AST) -> Optional[List[str]]:
    """`self._state.term[g]` -> ["self", "_state", "term"]; None when the
    expression is not a name/attribute/subscript chain."""
    parts: List[str] = []
    node = expr
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            return list(reversed(parts))
        else:
            return None


def rooted_in(expr: ast.AST, roots) -> bool:
    parts = dotted_parts(expr)
    if parts is None:
        return False
    dotted = ".".join(parts)
    return any(dotted == r or dotted.startswith(r + ".") for r in roots)


def mentions_device_root(expr: ast.AST, roots) -> bool:
    """Any sub-expression rooted in a declared device root."""
    for node in ast.walk(expr):
        if isinstance(node, (ast.Attribute, ast.Name, ast.Subscript)):
            if rooted_in(node, roots):
                return True
    return False


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def to_cpu(call: ast.Call) -> bool:
    """`x.to("cpu")` / `x.to(device="cpu")`."""
    return (
        isinstance(call.func, ast.Attribute)
        and call.func.attr == "to"
        and (
            any(_is_cpu(a) for a in call.args[:1])
            or any(k.arg == "device" and _is_cpu(k.value) for k in call.keywords)
        )
    )


def is_np_array_call(f: ast.AST) -> bool:
    return (
        isinstance(f, ast.Attribute)
        and f.attr in ("asarray", "array")
        and isinstance(f.value, ast.Name)
        and f.value.id in ("np", "numpy")
    )


#: sync_sites categories
WAIT, SCALAR, COPY = "wait", "scalar", "copy"


def sync_sites(fn: FunctionInfo, roots):
    """(category, kind, node) for every device-sync site in `fn`: every
    `.synchronize()` call (WAIT), and with `roots`, every host read of a
    value rooted in one: scalar reads (SCALAR) and host copies and np
    conversions (COPY)."""
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "synchronize":
            yield WAIT, f"{_callee_text(f)}.synchronize()", node
            continue
        if not roots:
            continue
        if (
            isinstance(f, ast.Name)
            and f.id in COERCIONS
            and node.args
            and mentions_device_root(node.args[0], roots)
        ):
            yield SCALAR, f"{f.id}() on a device value", node
        elif isinstance(f, ast.Attribute) and mentions_device_root(f.value, roots):
            if f.attr == "item":
                yield SCALAR, ".item() on a device value", node
            elif f.attr in HOST_COPY_ATTRS:
                yield COPY, f".{f.attr}() on a device value", node
            elif to_cpu(node):
                yield COPY, '.to("cpu") on a device value', node
        elif (
            is_np_array_call(f)
            and node.args
            and mentions_device_root(node.args[0], roots)
        ):
            yield COPY, f"np.{f.attr}() on a device value", node


def _callee_text(f: ast.Attribute) -> str:
    parts = dotted_parts(f.value)
    return ".".join(parts) if parts else "<expr>"


class SynchronizeOutsideSeam(Rule):
    id = "device-sync/synchronize"
    doc = (
        "torch.cuda.synchronize(), or .synchronize() on a torch.cuda "
        "Event or Stream, in a hot function outside the blessed "
        "_fetch_output/_fetch_super seams — a second host wait per step "
        "drains the stream and stops the decode overlapping the kernel"
    )
    motivation = (
        "the step loop pays exactly one event wait per step (the fetch "
        "of the pinned output slot); the runtime SyncAudit wraps "
        "torch.cuda.synchronize but not event or stream waits, so only "
        "this rule sees a stray ev.synchronize()"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        if fn.key() in targets.blessed_sync:
            return
        for _cat, kind, node in sync_sites(fn, ()):
            yield self.finding(
                fn, node, f"{kind} outside the blessed fetch seams"
            )


class HostScalarReadOfDeviceValue(Rule):
    id = "device-sync/scalar-read"
    doc = (
        "float()/int()/bool()/.item() applied to a device value "
        "(targets.device_roots) in a hot function — each one is a "
        "blocking copy of one scalar from the card"
    )
    motivation = (
        "a scalar read waits for every kernel queued before it: one per "
        "step serializes the host with the card, one per lane costs a "
        "round trip per lane"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        if fn.key() in targets.blessed_sync:
            return
        for cat, kind, node in sync_sites(fn, targets.device_roots):
            if cat == SCALAR:
                yield self.finding(
                    fn, node, f"{kind} is an implicit device->host sync"
                )


class HostCopyOfDeviceValue(Rule):
    id = "device-sync/host-array"
    doc = (
        ".cpu()/.numpy()/.tolist()/.to(\"cpu\") or np.asarray()/np.array() "
        "of a device value in a hot function — a whole-tensor copy to "
        "the host outside the consolidated fetch, synchronous with the "
        "stream"
    )
    motivation = (
        "the planes ship in ONE async copy into a pinned slot; an "
        "ad-hoc .cpu() is a second, blocking transfer per dispatch"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        if fn.key() in targets.blessed_sync:
            return
        for cat, kind, node in sync_sites(fn, targets.device_roots):
            if cat == COPY:
                yield self.finding(
                    fn, node, f"{kind} is an implicit whole-tensor transfer"
                )


class DeviceScalarIndexInLoop(Rule):
    id = "device-sync/index-in-loop"
    doc = (
        "scalar indexing of a device tensor inside a for/while body of a "
        "hot function — a blocking read or a kernel launch per iteration"
    )
    motivation = (
        "per-lane device reads in the fan-out loops were the measured "
        "hot spot the numpy mirrors replaced"
    )

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        if fn.key() not in targets.hot_functions:
            return
        roots = targets.device_roots
        if not roots:
            return
        for _loop, sub in self.loop_body_nodes(fn.node):
            if isinstance(sub, ast.Subscript) and rooted_in(sub.value, roots):
                yield self.finding(
                    fn,
                    sub,
                    "device-tensor indexing inside a hot loop (gather the "
                    "column once outside the loop, or read the mirror)",
                )


RULES = [
    SynchronizeOutsideSeam(),
    HostScalarReadOfDeviceValue(),
    HostCopyOfDeviceValue(),
    DeviceScalarIndexInLoop(),
]

__all__ = [
    "RULES",
    "COERCIONS",
    "COPY",
    "DeviceScalarIndexInLoop",
    "HOST_COPY_ATTRS",
    "HostCopyOfDeviceValue",
    "HostScalarReadOfDeviceValue",
    "SCALAR",
    "SynchronizeOutsideSeam",
    "dotted_parts",
    "is_np_array_call",
    "mentions_device_root",
    "rooted_in",
    "sync_sites",
    "to_cpu",
    "WAIT",
]
