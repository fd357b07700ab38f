"""Static call-graph resolution over parsed SourceModules.

The interprocedural layer under `dragonboat_tpu_torch.analysis`: the
lexical rules are per-function, so a lock taken by a
callee, a traced value branched on inside a helper, or a device sync two
frames below a hot function were all invisible. This module resolves a
STATIC call graph over the existing `SourceModule`/`FunctionInfo` tables
and hands it to the cross-function rule families
(`rules_xlocks`/`rules_xretrace`/`rules_xsync`) as a `Program`.

Resolution rules (deliberately narrow — a false edge makes every
downstream finding noise, a missing edge costs one review comment):

  * `self.m(...)` / `cls.m(...)`  — method on the enclosing class,
    walking the single-level base map (module-local first, then a
    globally-unique class of that name);
  * `f(...)`                      — enclosing nested-def scopes innermost
    first, then module level, then the module's `from x import f` table
    (package-relative and package-absolute imports, re-exports
    chased a bounded number of hops);
  * `C.m(...)` / `mod.f(...)`     — a known class name or an imported
    module name as the receiver;
  * `v.m(...)`                    — receiver class via the declared
    variable hints (`targets.lock_var_hints`: node -> Node, sq ->
    _SendQueue, ...); otherwise, ONLY for `*_locked`-suffixed method
    names, a globally-unique method of that name resolves (the
    caller-holds convention is exactly what the cross-lock rule needs
    call sites for);
  * anything else (dynamic dispatch, getattr, lambdas, callbacks)
    degrades to NO EDGE — never a crash, never a guess.

Each resolved edge is a `CallSite` carrying the lexically-held lock set
at the call expression. Nested `def`s additionally get an explicit
DEFERRED edge with an EMPTY held set: a closure created under a `with`
runs later, lock not held (the lexical rules simply skip nested
defs; the deferred edge makes "closure called later, lock not held" a
first-class fact the lock rules can act on). A direct invocation of the
closure inside the enclosing function still produces a normal edge with
the locks actually held at the invocation site.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import FunctionInfo, SourceModule
from .rules_device import dotted_parts

FnKey = Tuple[str, str]  # (relpath, qualname)

#: bounded re-export chase depth for `from .x import y` chains
_IMPORT_HOPS = 4


def lock_ref(expr: ast.AST) -> Optional[Tuple[str, str]]:
    """`self._mu` / `sh._wmu` / `self._sq._cv` -> (dotted root, attr);
    None when the expression is not a name/attribute chain."""
    parts = dotted_parts(expr)
    if parts is None or len(parts) < 2:
        return None
    return ".".join(parts[:-1]), parts[-1]


def resolve_lock_spec(fn: FunctionInfo, targets, root: str, attr: str):
    """(root, attr) -> LockSpec via the declared hierarchy: `self` binds
    the enclosing class, declared variable hints bind theirs, and an
    attr name carried by exactly ONE spec resolves unambiguously."""
    if root == "self":
        spec = targets.lock_rank(fn.class_name, attr, fn.module)
        if spec is not None:
            return spec
    cls = targets.lock_var_hints.get(root)
    if cls is not None:
        spec = targets.lock_rank(cls, attr, fn.module)
        if spec is not None:
            return spec
    matches = [s for s in targets.locks if s.attr == attr]
    return matches[0] if len(matches) == 1 else None


class HeldLock:
    """One lexically-held lock at a call site: the (root, attr) spelling
    plus the resolved LockSpec (None when the hierarchy doesn't declare
    it — still useful for the caller-holds root/attr match)."""

    __slots__ = ("root", "attr", "spec")

    def __init__(self, root: str, attr: str, spec) -> None:
        self.root = root
        self.attr = attr
        self.spec = spec

    def __repr__(self) -> str:  # debugging aid
        rank = self.spec.rank if self.spec else "?"
        return f"<held {self.root}.{self.attr} rank={rank}>"


class CallSite:
    """One resolved edge caller -> callee."""

    __slots__ = (
        "caller", "callee", "node", "lineno", "held", "deferred", "recv_root",
    )

    def __init__(
        self,
        caller: FnKey,
        callee: FnKey,
        node: ast.AST,
        held: Tuple[HeldLock, ...],
        deferred: bool = False,
        recv_root: str = "",
    ) -> None:
        self.caller = caller
        self.callee = callee
        self.node = node
        self.lineno = getattr(node, "lineno", 1)
        self.held = held
        self.deferred = deferred
        self.recv_root = recv_root


def walk_with_held(fn_node: ast.AST):
    """Yield ("call", node, held_refs) for every call expression and
    ("def", node, held_refs) for every directly-nested function def,
    where held_refs is the tuple of (root, attr) lock spellings of the
    lexically-enclosing `with` items. Nested defs and lambdas are NOT
    entered: their bodies run later, possibly without the lock."""
    held: List[Tuple[str, str]] = []
    out: List[Tuple[str, ast.AST, Tuple[Tuple[str, str], ...]]] = []

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(("def", node, tuple(held)))
            return
        if isinstance(node, ast.Lambda):
            return  # runs later; unresolvable anyway
        if isinstance(node, (ast.With, ast.AsyncWith)):
            n = 0
            for item in node.items:
                # the context expression itself evaluates BEFORE the
                # lock is held
                visit_children(item.context_expr)
                ref = lock_ref(item.context_expr)
                if ref is not None:
                    held.append(ref)
                    n += 1
            for c in node.body:
                visit(c)
            if n:
                del held[-n:]
            return
        if isinstance(node, ast.Call):
            out.append(("call", node, tuple(held)))
        visit_children(node)

    def visit_children(node):
        for c in ast.iter_child_nodes(node):
            visit(c)

    for c in fn_node.body:
        visit(c)
    return out


class _ImportTable:
    """Per-module `from ... import name [as alias]` resolution."""

    def __init__(self, mod: SourceModule) -> None:
        # alias -> ("symbol", module_relpath_stub, original_name)
        #        | ("module", module_relpath_stub, "")
        self.entries: Dict[str, Tuple[str, str, str]] = {}
        pkg_dir = mod.relpath.rsplit("/", 1)[0] if "/" in mod.relpath else ""
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            base = self._base_path(node, pkg_dir)
            if base is None:
                continue
            for alias in node.names:
                name = alias.asname or alias.name
                if node.module is None:
                    # `from . import rules_device` — the NAME is a module
                    stub = (base + "/" if base else "") + alias.name
                    self.entries[name] = ("module", stub, "")
                else:
                    self.entries[name] = ("symbol", base, alias.name)

    @staticmethod
    def _base_path(node: ast.ImportFrom, pkg_dir: str) -> Optional[str]:
        """The imported module as a "/"-separated path stub (no .py)."""
        if node.level == 0:
            modname = node.module or ""
            if not modname.startswith("dragonboat_tpu"):
                return None  # stdlib / third-party: out of scope
            parts = modname.split(".")[1:]
            return "/".join(parts)
        # package-relative: level 1 = the module's own package dir
        parts = pkg_dir.split("/") if pkg_dir else []
        up = node.level - 1
        if up > len(parts):
            return None
        parts = parts[: len(parts) - up]
        if node.module:
            parts = parts + node.module.split(".")
        return "/".join(parts)


class CallGraph:
    """The resolved static call graph over a set of parsed modules."""

    def __init__(self, modules: Sequence[SourceModule], targets) -> None:
        self.targets = targets
        self.modules: Dict[str, SourceModule] = {m.relpath: m for m in modules}
        self.functions: Dict[FnKey, FunctionInfo] = {}
        #: relpath -> {class name -> {method name -> FunctionInfo}}
        self._methods: Dict[str, Dict[str, Dict[str, FunctionInfo]]] = {}
        #: class name -> [(relpath, method table)] across the program
        self._classes: Dict[str, List[Tuple[str, Dict[str, FunctionInfo]]]] = {}
        #: bare function name -> [FnKey] (for the *_locked unique fallback)
        self._by_name: Dict[str, List[FnKey]] = {}
        self._imports: Dict[str, _ImportTable] = {}
        for m in modules:
            self._index_module(m)
        self.edges: List[CallSite] = []
        self.out_edges: Dict[FnKey, List[CallSite]] = {}
        self.in_edges: Dict[FnKey, List[CallSite]] = {}
        for m in modules:
            for fn in m.functions:
                self._collect_edges(fn)

    # -- indexing ----------------------------------------------------------
    def _index_module(self, mod: SourceModule) -> None:
        meth: Dict[str, Dict[str, FunctionInfo]] = {}
        for fn in mod.functions:
            self.functions[fn.key()] = fn
            self._by_name.setdefault(fn.name, []).append(fn.key())
            if fn.class_name and fn.qualname == f"{fn.class_name}.{fn.name}":
                meth.setdefault(fn.class_name, {})[fn.name] = fn
        self._methods[mod.relpath] = meth
        for cls, table in meth.items():
            self._classes.setdefault(cls, []).append((mod.relpath, table))
        self._imports[mod.relpath] = _ImportTable(mod)

    # -- resolution --------------------------------------------------------
    def _module_for_stub(self, stub: str) -> Optional[SourceModule]:
        for cand in (stub + ".py", stub + "/__init__.py"):
            if cand in self.modules:
                return self.modules[cand]
        return None

    def _resolve_import(self, relpath: str, name: str, hops: int = _IMPORT_HOPS):
        """Chase `from x import name` (and one-level re-exports) to a
        FunctionInfo key, or None."""
        if hops <= 0:
            return None
        table = self._imports.get(relpath)
        if table is None:
            return None
        entry = table.entries.get(name)
        if entry is None:
            return None
        kind, stub, orig = entry
        if kind == "module":
            return None  # a module alias is not callable as a function
        mod = self._module_for_stub(stub)
        if mod is None:
            return None
        fn = mod.function(orig)
        if fn is not None:
            return fn.key()
        # re-export: the target module imports it from somewhere else
        return self._resolve_import(mod.relpath, orig, hops - 1)

    def _resolve_class_method(
        self, mod: SourceModule, cls: Optional[str], attr: str
    ) -> Optional[FnKey]:
        """Walk cls and its (single-level) bases looking for a method."""
        seen: Set[str] = set()
        while cls and cls not in seen:
            seen.add(cls)
            local = self._methods.get(mod.relpath, {}).get(cls)
            if local and attr in local:
                return local[attr].key()
            hits = self._classes.get(cls, [])
            if len(hits) == 1 and attr in hits[0][1]:
                return hits[0][1][attr].key()
            bases = mod.class_bases.get(cls, [])
            if not bases and len(hits) == 1:
                bases = self.modules[hits[0][0]].class_bases.get(cls, [])
            cls = bases[0] if bases else None
        return None

    def _resolve(self, fn: FunctionInfo, call: ast.Call):
        """-> (FnKey, recv_root) or None. Never raises on weird shapes."""
        f = call.func
        mod = fn.module
        if isinstance(f, ast.Name):
            name = f.id
            # enclosing nested-def scopes, innermost first
            parts = fn.qualname.split(".")
            for i in range(len(parts), 0, -1):
                cand = ".".join(parts[:i]) + "." + name
                hit = mod.function(cand)
                if hit is not None:
                    return hit.key(), ""
            hit = mod.function(name)
            if hit is not None:
                return hit.key(), ""
            key = self._resolve_import(mod.relpath, name)
            if key is not None:
                return key, ""
            return None
        if not isinstance(f, ast.Attribute):
            return None
        attr = f.attr
        parts = dotted_parts(f.value)
        if parts is not None:
            recv_root = ".".join(parts)
            if parts[0] in ("self", "cls") and len(parts) == 1:
                key = self._resolve_class_method(mod, fn.class_name, attr)
                if key is not None:
                    return key, parts[0]
            elif len(parts) == 1:
                v = parts[0]
                # a known class name used as receiver (classmethod/static
                # or an explicit Cls.m(self, ...) call)
                if v in self._methods.get(mod.relpath, {}) or v in self._classes:
                    key = self._resolve_class_method(mod, v, attr)
                    if key is not None:
                        return key, v
                table = self._imports.get(mod.relpath)
                entry = table.entries.get(v) if table else None
                if entry and entry[0] == "module":
                    tgt = self._module_for_stub(entry[1])
                    if tgt is not None:
                        hit = tgt.function(attr)
                        if hit is not None:
                            return hit.key(), v
                hint = self.targets.lock_var_hints.get(v)
                if hint is not None:
                    key = self._resolve_class_method(mod, hint, attr)
                    if key is not None:
                        return key, v
            # *_locked unique-name fallback: the caller-holds convention
            # is worth a slightly bolder resolution — but only when the
            # whole program has exactly one method of that name
            if attr.endswith(self.targets.locked_suffix):
                hits = self._by_name.get(attr, [])
                if len(hits) == 1:
                    return hits[0], recv_root
        return None

    # -- edge collection ---------------------------------------------------
    def _collect_edges(self, fn: FunctionInfo) -> None:
        key = fn.key()
        for kind, node, held_refs in walk_with_held(fn.node):
            if kind == "def":
                callee = (fn.module.relpath, f"{fn.qualname}.{node.name}")
                if callee in self.functions:
                    self._add(CallSite(key, callee, node, (), deferred=True))
                continue
            resolved = self._resolve(fn, node)
            if resolved is None:
                continue
            callee, recv_root = resolved
            held = tuple(
                HeldLock(r, a, resolve_lock_spec(fn, self.targets, r, a))
                for r, a in held_refs
            )
            self._add(CallSite(key, callee, node, held, recv_root=recv_root))

    def _add(self, site: CallSite) -> None:
        self.edges.append(site)
        self.out_edges.setdefault(site.caller, []).append(site)
        self.in_edges.setdefault(site.callee, []).append(site)

    # -- queries -----------------------------------------------------------
    def callees(self, key: FnKey, deferred: bool = False) -> List[CallSite]:
        return [
            e for e in self.out_edges.get(key, [])
            if deferred or not e.deferred
        ]

    def callers(self, key: FnKey) -> List[CallSite]:
        return list(self.in_edges.get(key, []))

    def caller_modules_of(self, relpaths: Set[str]) -> Set[str]:
        """Modules holding a caller of any function in `relpaths` (the
        --changed expansion: a change in a callee can create findings at
        its call sites)."""
        out: Set[str] = set()
        for e in self.edges:
            if e.callee[0] in relpaths and e.caller[0] not in relpaths:
                out.add(e.caller[0])
        return out


class Program:
    """Everything a CrossRule gets to see: the parsed modules, the
    resolved call graph, and the target configuration."""

    def __init__(self, modules: Sequence[SourceModule], targets) -> None:
        self.modules: List[SourceModule] = list(modules)
        self.targets = targets
        self.by_relpath: Dict[str, SourceModule] = {
            m.relpath: m for m in self.modules
        }
        self._by_path: Dict[str, SourceModule] = {}
        for m in self.modules:
            self._by_path[m.path] = m
            self._by_path.setdefault(m.relpath, m)
        self.graph = CallGraph(self.modules, targets)

    def module_for_path(self, path: str) -> Optional[SourceModule]:
        return self._by_path.get(path)


__all__ = [
    "CallGraph",
    "CallSite",
    "FnKey",
    "HeldLock",
    "Program",
    "lock_ref",
    "resolve_lock_spec",
    "walk_with_held",
]
