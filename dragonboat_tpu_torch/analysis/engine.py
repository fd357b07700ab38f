"""The rule engine under `dragonboat_tpu_torch.analysis`.

Pure-AST static analysis: modules are PARSED, never imported, so the
checker runs in milliseconds with no third-party dependency in the
process, and `python -m dragonboat_tpu_torch.tools.check` can gate CI
before a single kernel builds.

Building blocks:

  * `SourceModule`  — one parsed file: source lines, AST, the function
    table (qualnames like `VectorEngine._decode`, nested defs like
    `make_step_fn.apply`), the single-level class->bases map, and the
    suppression pragmas scanned from the raw lines.
  * `FunctionInfo`  — one function with its qualname, enclosing class and
    a back-pointer to the module; rules receive these.
  * `Rule`          — one check: `id` ("family/name"), `doc`, `motivation`
    (which real bug/PR the rule exists for), and `check_function()`
    yielding findings. The family prefix groups rules for suppression
    (`# lint: allow(family)`) and for the conformance shim.
  * `Analyzer`      — walks files -> modules -> functions -> rules,
    applies suppressions, dedupes, and reports configuration drift
    (a targeted function that no longer exists is itself a finding:
    a silently-unenforced rule is how regressions sneak back in).

Suppression pragmas:

    x = arr[g].item()  # lint: allow(columnar/item-in-loop) rare lane, <=1/step

A pragma allows a rule id, a whole family (`allow(device-sync)`), a
comma-separated list, or `*`. It applies to findings on its own line, or
— when the line holds only the pragma comment — to the line below. Every
suppression must carry a reason; a bare `allow(...)` is itself reported
(`pragma/missing-reason`). The legacy `# hot-path: ok` mark from the old
test-embedded lint keeps working for the four migrated hot-path families.
"""
from __future__ import annotations

import ast
import io
import os
import re
import textwrap
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# families the pre-analysis `# hot-path: ok` mark (tests/test_hot_path_lint
# .py) may suppress — kept so existing in-tree marks migrate untouched
LEGACY_MARK = "hot-path: ok"
LEGACY_MARK_FAMILIES = ("columnar", "locks", "telemetry", "trace")

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)\s*(.*)$")

# identifier fragments that mark a sampling/latency gate in an `if` test
# ("trace": trace-id truthiness gates — nonzero only on sampled requests)
GUARD_HINTS = ("sampl", "lat", "sstats", "trace")


def guard_test_is_sampling_gate(test_node: ast.AST) -> bool:
    """True when an `if` condition references a sampling/latency gate."""
    dump = ast.dump(test_node).lower()
    return any(h in dump for h in GUARD_HINTS)


@dataclass
class Finding:
    """One reported violation. `suppressed` findings stay in the output
    (visible in --json and `--show-suppressed`) but do not fail the run."""

    rule: str
    path: str
    line: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    suppress_reason: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }

    def render(self) -> str:
        tail = f"  [suppressed: {self.suppress_reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tail}"


@dataclass
class _Pragma:
    rules: Tuple[str, ...]
    reason: str
    standalone: bool  # the line holds only the comment -> applies below
    src_line: int = 0  # the line the pragma COMMENT is on (0 = synthetic)


class FunctionInfo:
    """One function/method with enough context for a rule to act on."""

    __slots__ = ("qualname", "name", "class_name", "node", "module")

    def __init__(self, qualname, name, class_name, node, module) -> None:
        self.qualname = qualname
        self.name = name
        self.class_name = class_name  # nearest enclosing class, or None
        self.node = node
        self.module = module

    def line(self, node: ast.AST) -> str:
        try:
            return self.module.lines[node.lineno - 1]
        except IndexError:
            return ""

    def key(self) -> Tuple[str, str]:
        return (self.module.relpath, self.qualname)


class SourceModule:
    """A parsed source file plus the lookup tables rules need."""

    def __init__(self, source: str, relpath: str, path: str = "") -> None:
        self.relpath = relpath  # package-relative, "/"-separated
        self.path = path or relpath  # display path for findings
        self.lines = source.split("\n")
        self.tree = ast.parse(source)
        self.functions: List[FunctionInfo] = []
        self.class_bases: Dict[str, List[str]] = {}
        self.pragmas: Dict[int, _Pragma] = {}
        self._collect_functions()
        self._scan_pragmas()

    @classmethod
    def from_file(cls, path: str, relpath: str) -> "SourceModule":
        with open(path, "r", encoding="utf-8") as f:
            return cls(f.read(), relpath, path)

    @classmethod
    def from_snippet(cls, source: str, relpath: str = "snippet.py") -> "SourceModule":
        return cls(textwrap.dedent(source), relpath)

    # -- structure ---------------------------------------------------------
    def _collect_functions(self) -> None:
        def visit(node, prefix: str, class_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.class_bases[child.name] = [
                        b.id for b in child.bases if isinstance(b, ast.Name)
                    ]
                    visit(child, prefix + child.name + ".", child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = prefix + child.name
                    self.functions.append(
                        FunctionInfo(qn, child.name, class_name, child, self)
                    )
                    visit(child, qn + ".", class_name)
                else:
                    # defs can hide inside any statement (with/if/try):
                    # keep the prefix and keep looking
                    visit(child, prefix, class_name)

        visit(self.tree, "", None)

    def function(self, qualname: str) -> Optional[FunctionInfo]:
        for fn in self.functions:
            if fn.qualname == qualname:
                return fn
        return None

    def is_subclass_of(self, cls: Optional[str], base: str) -> bool:
        """Single-level-per-hop base walk within this module."""
        seen = set()
        while cls is not None and cls not in seen:
            if cls == base:
                return True
            seen.add(cls)
            bases = self.class_bases.get(cls, [])
            cls = bases[0] if bases else None
        return False

    # -- suppression -------------------------------------------------------
    def _comment_lines(self) -> Optional[Set[int]]:
        """Line numbers holding REAL comment tokens. Docstrings and string
        literals that merely MENTION the pragma syntax (this engine's own
        documentation, for one) must neither suppress findings nor be
        reported by pragma/unused; tokenize is the only lexically-honest
        way to tell. None = tokenization failed, treat every regex hit
        as a comment (fail open: suppressions keep working)."""
        try:
            return {
                tok.start[0]
                for tok in tokenize.generate_tokens(
                    io.StringIO("\n".join(self.lines)).readline
                )
                if tok.type == tokenize.COMMENT
            }
        except (tokenize.TokenError, IndentationError):
            return None

    def _scan_pragmas(self) -> None:
        comments = self._comment_lines()
        for i, line in enumerate(self.lines, start=1):
            if comments is not None and i not in comments:
                continue
            m = _PRAGMA_RE.search(line)
            if m is None:
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            reason = m.group(2).strip()
            standalone = line.strip().startswith("#")
            if not standalone:
                self.pragmas[i] = _Pragma(rules, reason, False, i)
                continue
            # a standalone pragma covers the next CODE line; comment lines
            # in between continue the reason text
            j = i + 1
            while j <= len(self.lines):
                nxt = self.lines[j - 1].strip()
                if nxt.startswith("#"):
                    reason = (reason + " " + nxt.lstrip("# ")).strip()
                    j += 1
                elif not nxt:
                    j += 1
                else:
                    break
            if j <= len(self.lines):
                self.pragmas.setdefault(j, _Pragma(rules, reason, True, i))

    def suppression_for(self, rule_id: str, line: int) -> Optional[_Pragma]:
        """Pragma covering `rule_id` at `line`: on the same line, or a
        standalone pragma comment directly above (continuation comment
        lines extend the reason)."""
        family = rule_id.split("/", 1)[0]
        p = self.pragmas.get(line)
        if p is not None:
            for r in p.rules:
                if r in ("*", rule_id, family):
                    return p
        if family in LEGACY_MARK_FAMILIES and 0 < line <= len(self.lines):
            if LEGACY_MARK in self.lines[line - 1]:
                return _Pragma(("*",), "legacy hot-path: ok mark", False, 0)
        return None


class Rule:
    """Base class: one named check over one function."""

    id: str = ""
    doc: str = ""  # one line: what it catches
    motivation: str = ""  # which real bug / PR motivated it

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        raise NotImplementedError

    # -- shared AST helpers ------------------------------------------------
    @staticmethod
    def loop_body_nodes(fn_node: ast.AST):
        """Yield (loop, sub) for every node inside a for/while BODY (the
        iterator expression runs once and is exempt — column-level
        `.tolist()` there is the fast idiom)."""
        for node in ast.walk(fn_node):
            if isinstance(node, (ast.For, ast.While)):
                for stmt in node.body + node.orelse:
                    for sub in ast.walk(stmt):
                        yield node, sub

    def finding(self, fn: FunctionInfo, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            path=fn.module.path,
            line=line,
            message=f"{fn.qualname}: {message}",
            snippet=fn.line(node).strip(),
        )


class CrossRule(Rule):
    """A rule over the whole program — the interprocedural families.

    `check_function` never fires (the Analyzer routes CrossRules through
    `check_program` instead, once per run, with the resolved call graph).
    Findings still anchor at a concrete (function, node) site so the
    same pragma machinery suppresses them."""

    def check_function(self, fn: FunctionInfo, targets) -> Iterable[Finding]:
        return []

    def check_program(self, program) -> Iterable[Finding]:
        """`program` is a callgraph.Program: parsed modules + call graph
        + targets. Yield findings anchored via `self.finding(fn, node,
        msg)` on the function the site lives in."""
        raise NotImplementedError


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Analyzer:
    """Runs a rule set over a file tree and applies suppressions."""

    def __init__(
        self,
        rules: Sequence[Rule],
        targets,
        root: str = "",
        unused_pragmas: bool = True,
    ) -> None:
        self.rules = list(rules)
        self.function_rules = [r for r in self.rules if not isinstance(r, CrossRule)]
        self.cross_rules = [r for r in self.rules if isinstance(r, CrossRule)]
        self.targets = targets
        self.root = root or _PKG_ROOT
        # pragma/unused only makes sense when the FULL rule set ran over
        # the FULL tree — a family- or path-restricted run would report
        # every pragma for the excluded rules as dead
        self.unused_pragmas = unused_pragmas
        #: (relpath, pragma src line) of every pragma that suppressed
        #: at least one finding in the last run
        self._used_pragmas: Set[Tuple[str, int]] = set()
        #: the callgraph.Program from the last run (check.py --changed
        #: uses its caller index)
        self.last_program = None

    # -- discovery ---------------------------------------------------------
    def _iter_files(self, paths: Optional[Sequence[str]]):
        """Yield ("file", path) plus ("missing", path) markers: an explicit
        path that matches NOTHING must fail loudly — a typo'd path in CI
        would otherwise report a permanently-clean gate that checks
        nothing (the exact silently-unenforced failure mode
        config/missing-target exists to prevent). Relative paths that do
        not exist from the cwd are retried against the analyzer root, so
        `tools.check engine/ storage/` works from anywhere."""
        if not paths:
            paths = [self.root]
        for p in paths:
            if not os.path.exists(p):
                rooted = os.path.join(self.root, p)
                if os.path.exists(rooted):
                    p = rooted
                else:
                    yield ("missing", p)
                    continue
            if os.path.isdir(p):
                matched = False
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = [
                        d for d in dirnames
                        if d != "__pycache__" and not d.startswith(".")
                    ]
                    for fname in sorted(filenames):
                        if fname.endswith(".py"):
                            matched = True
                            yield ("file", os.path.join(dirpath, fname))
                if not matched:
                    yield ("missing", p)
            elif p.endswith(".py"):
                yield ("file", p)
            else:
                yield ("missing", p)

    def _relpath(self, path: str) -> str:
        rp = os.path.relpath(os.path.abspath(path), self.root)
        return rp.replace(os.sep, "/")

    # -- run ---------------------------------------------------------------
    def run(self, paths: Optional[Sequence[str]] = None) -> List[Finding]:
        findings: List[Finding] = []
        modules: List[SourceModule] = []
        seen_functions: Set[Tuple[str, str]] = set()
        seen_modules: Set[str] = set()
        self._used_pragmas = set()
        for kind, path in self._iter_files(paths):
            if kind == "missing":
                findings.append(
                    Finding(
                        "config/no-such-path",
                        path,
                        1,
                        "path matches no Python files — a typo here would "
                        "make the gate silently check nothing",
                    )
                )
                continue
            relpath = self._relpath(path)
            try:
                mod = SourceModule.from_file(path, relpath)
            except (SyntaxError, UnicodeDecodeError) as e:
                findings.append(
                    Finding("config/unparseable", path, 1, f"cannot parse: {e}")
                )
                continue
            seen_modules.add(relpath)
            for fn in mod.functions:
                seen_functions.add(fn.key())
            modules.append(mod)
        for mod in modules:
            findings.extend(self.run_module(mod))
        if self.cross_rules:
            findings.extend(self._run_cross(modules))
        if paths is None and self.unused_pragmas:
            findings.extend(self._unused_pragma_findings(modules))
        findings.extend(
            self._config_drift(seen_modules, seen_functions)
        )
        return findings

    def run_module(self, mod: SourceModule) -> List[Finding]:
        out: List[Finding] = []
        dedup: Set[Tuple] = set()
        for fn in mod.functions:
            for rule in self.function_rules:
                for f in rule.check_function(fn, self.targets):
                    key = (f.rule, f.line, f.message)
                    if key in dedup:
                        continue
                    dedup.add(key)
                    self._apply_suppression(mod, f, out, dedup)
                    out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out

    def run_snippet(
        self, source: str, relpath: str = "snippet.py"
    ) -> List[Finding]:
        return self.run_module(SourceModule.from_snippet(source, relpath))

    def run_sources(self, sources: Dict[str, str]) -> List[Finding]:
        """Run function AND cross rules over in-memory sources (relpath ->
        source text). The meta-test entry point for interprocedural
        rules; no drift/unused-pragma checks (the sources are not the
        real tree)."""
        modules = [
            SourceModule.from_snippet(src, rp)
            for rp, src in sorted(sources.items())
        ]
        self._used_pragmas = set()
        findings: List[Finding] = []
        for mod in modules:
            findings.extend(self.run_module(mod))
        if self.cross_rules:
            findings.extend(self._run_cross(modules))
        return findings

    def _run_cross(self, modules: Sequence[SourceModule]) -> List[Finding]:
        from .callgraph import Program  # deferred: engine has no deps on it

        program = Program(modules, self.targets)
        self.last_program = program
        out: List[Finding] = []
        dedup: Set[Tuple] = set()
        for rule in self.cross_rules:
            for f in rule.check_program(program):
                key = (f.rule, f.path, f.line, f.message)
                if key in dedup:
                    continue
                dedup.add(key)
                mod = program.module_for_path(f.path)
                if mod is not None:
                    self._apply_suppression(mod, f, out, dedup)
                out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out

    def _unused_pragma_findings(
        self, modules: Sequence[SourceModule]
    ) -> List[Finding]:
        """A `# lint: allow(...)` that suppressed nothing this run is
        itself a finding: dead suppressions are how rules silently stop
        enforcing (the code they excused was fixed or moved, the pragma
        stayed, and the next REAL violation on that line is invisible).
        Pragmas naming a rule/family in targets.unused_pragma_allowlist
        are exempt (rules gated off by config fire zero findings by
        design)."""
        allow = getattr(self.targets, "unused_pragma_allowlist", set())
        out: List[Finding] = []
        for mod in modules:
            seen_src: Set[int] = set()
            for _line, p in sorted(mod.pragmas.items()):
                if p.src_line in seen_src or p.src_line <= 0:
                    continue
                seen_src.add(p.src_line)
                if (mod.relpath, p.src_line) in self._used_pragmas:
                    continue
                if any(r in allow for r in p.rules):
                    continue
                out.append(
                    Finding(
                        "pragma/unused",
                        mod.path,
                        p.src_line,
                        f"allow({', '.join(p.rules)}) suppresses nothing — "
                        f"delete the pragma (dead suppressions are how "
                        f"rules silently stop enforcing)",
                        snippet=mod.lines[p.src_line - 1].strip()
                        if p.src_line <= len(mod.lines)
                        else "",
                    )
                )
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out

    def _apply_suppression(
        self, mod: SourceModule, f: Finding, out: List[Finding], dedup
    ) -> None:
        p = mod.suppression_for(f.rule, f.line)
        if p is None:
            return
        f.suppressed = True
        f.suppress_reason = p.reason or "(no reason given)"
        if p.src_line > 0:
            self._used_pragmas.add((mod.relpath, p.src_line))
        if not p.reason:
            msg = (
                "suppression carries no reason — every allow() must say why"
            )
            key = ("pragma/missing-reason", f.path, f.line, msg)
            if key not in dedup:
                dedup.add(key)
                out.append(
                    Finding("pragma/missing-reason", f.path, f.line, msg)
                )

    def _config_drift(
        self, seen_modules: Set[str], seen_functions: Set[Tuple[str, str]]
    ) -> List[Finding]:
        """A targeted function that no longer exists means a rule silently
        stopped firing — that is a finding, exactly like the legacy lint's
        'update the HOT_FUNCTIONS list' failure."""
        missing: Dict[Tuple[str, str], List[str]] = {}
        for relpath, qualname, why in self.targets.all_function_targets():
            if relpath in seen_modules and (relpath, qualname) not in seen_functions:
                missing.setdefault((relpath, qualname), []).append(why)
        out = []
        for (relpath, qualname), whys in sorted(missing.items()):
            out.append(
                Finding(
                    "config/missing-target",
                    relpath,
                    1,
                    f"{qualname}: targeted by {', '.join(whys)} but no "
                    f"longer exists — update analysis/targets.py (and "
                    f"keep its replacement covered)",
                )
            )
        return out


def unsuppressed(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


__all__ = [
    "Analyzer",
    "CrossRule",
    "Finding",
    "FunctionInfo",
    "GUARD_HINTS",
    "LEGACY_MARK",
    "Rule",
    "SourceModule",
    "guard_test_is_sampling_gate",
    "unsuppressed",
]
