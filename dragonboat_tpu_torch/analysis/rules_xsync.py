"""Cross-function device-sync detection over the static call graph.

The lexical device-sync rules only look INSIDE the declared hot
functions, so moving an `ev.synchronize()` or a `.item()` into a helper
one frame down made it invisible while costing exactly the same per-step
host wait. This pass walks the call graph from every hot root:

  * BFS over NON-deferred edges (a closure created on the hot path but
    called later is not per-step work), plus constructor edges
    (`_Launcher(dev)` reaches `_Launcher.__init__`), which the shared
    call graph does not resolve;
  * the walk never enters a blessed seam (`_fetch_output`/`_fetch_super`
    — that wait is the architecture) nor another hot function (its own
    BFS and the lexical rules cover it);
  * every reachable helper is scanned for sync sites: `.synchronize()`
    (torch.cuda, an Event, a Stream) anywhere, plus `.item()`, `.cpu()`,
    `.numpy()`, `.tolist()`, `.to("cpu")`, coercions and `np.asarray` on
    declared device roots — the root-based checks only in modules that
    host hot functions, because `self._state` names the device state
    there and ordinary host state elsewhere.

Each finding carries the hot-root call chain, which says WHY a
helper is step-path code.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import FnKey, Program
from .engine import CrossRule, Finding
from .rules_device import sync_sites


def constructor_callee(graph, key: FnKey, call: ast.Call) -> Optional[FnKey]:
    """`Cls(...)` -> `Cls.__init__` for a class of the caller's module or
    a class name unique in the program; None otherwise."""
    f = call.func
    if not isinstance(f, ast.Name):
        return None
    relpath = key[0]
    table = graph._methods.get(relpath, {}).get(f.id)
    if table is None:
        hits = graph._classes.get(f.id, [])
        table = hits[0][1] if len(hits) == 1 else None
    init = (table or {}).get("__init__")
    return init.key() if init is not None else None


def call_edges(program: Program, key: FnKey) -> List[Tuple[FnKey, ast.Call]]:
    """(callee, call node) of every non-deferred call edge of `key`: the
    shared graph's resolved edges, then constructor calls."""
    graph = program.graph
    out = [(s.callee, s.node) for s in graph.callees(key)]
    fn = graph.functions.get(key)
    if fn is None:
        return out
    resolved = {id(n) for _c, n in out}
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call) and id(node) not in resolved:
            init = constructor_callee(graph, key, node)
            if init is not None:
                out.append((init, node))
    return out


def reach(
    program: Program, roots: Iterable[FnKey], stop: Set[FnKey]
) -> Dict[FnKey, Tuple[FnKey, ...]]:
    """Functions reachable from `roots` (BFS over call_edges, never
    entering a root or a key in `stop`), each with its SHORTEST chain
    from a root."""
    graph = program.graph
    roots = set(roots)
    reached: Dict[FnKey, Tuple[FnKey, ...]] = {}
    frontier = [(k, (k,)) for k in sorted(roots) if k in graph.functions]
    while frontier:
        nxt = []
        for key, chain in frontier:
            for c, _node in call_edges(program, key):
                if c in roots or c in stop or c in reached:
                    continue
                reached[c] = chain + (c,)
                nxt.append((c, chain + (c,)))
        frontier = nxt
    return reached


def chain_text(chain: Tuple[FnKey, ...]) -> str:
    return " -> ".join(qn for _rp, qn in chain)


class CrossFunctionDeviceSync(CrossRule):
    id = "device-sync/cross-function"
    doc = (
        ".synchronize() (torch.cuda, Event, Stream), or .item()/.cpu()/"
        ".numpy()/.tolist()/.to(\"cpu\")/coercion of a device root, in a "
        "helper REACHABLE from a hot function through a call chain that "
        "does not pass a blessed seam — the same hidden per-step host "
        "wait the lexical rules catch, one or more frames down"
    )
    motivation = (
        "extracting a wait into a helper must not launder it past the "
        "one-wait-per-step architecture; the e2e numbers decay the same "
        "wherever the sync lives"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        targets = program.targets
        hot = targets.hot_functions
        hot_modules = {rp for rp, _qn in hot}
        reached = reach(program, hot, set(targets.blessed_sync))
        for key in sorted(reached):
            fn = program.graph.functions.get(key)
            if fn is None:
                continue
            roots = targets.device_roots if key[0] in hot_modules else ()
            for _cat, kind, node in sync_sites(fn, roots):
                yield self.finding(
                    fn,
                    node,
                    f"{kind} reachable from the hot path "
                    f"({chain_text(reached[key])}) outside a blessed seam "
                    f"— a hidden per-step device sync",
                )


RULES = [CrossFunctionDeviceSync()]

__all__ = [
    "RULES",
    "CrossFunctionDeviceSync",
    "call_edges",
    "chain_text",
    "constructor_callee",
    "reach",
]
