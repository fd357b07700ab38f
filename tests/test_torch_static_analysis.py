"""Twin of test_static_analysis.py for `dragonboat_tpu_torch.analysis` and
`python -m dragonboat_tpu_torch.tools.check`.

Two halves:

  * the reference's meta-tests of the families the port shares with the
    JAX package (columnar, locks, telemetry, trace, the pragmas, config
    drift) run UNCHANGED against the port: each test body of
    test_static_analysis.py is called with its module's analysis names
    bound to the port's (`ported`), and every analyzer it builds runs
    each snippet through BOTH packages (`Dual`) and requires the same
    findings of the shared families before the reference's assertions
    check the port's;
  * the port's own families, which replace the JAX package's: the
    `device-sync/*` rules aimed at torch's sync points (`.item()`,
    `.cpu()`, `.tolist()`, `.numpy()`, `.to("cpu")`, coercions,
    `np.asarray`, indexing in loops, `torch.cuda.synchronize()` and
    event/stream waits) and the `build/*` rules (kernel builds on the
    launch path, host reads in the launch wrappers), each with seeded
    bad snippets, allowed idioms, a mutation of the port's own
    `_decode`, and the CLI gate over the port's tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

import dragonboat_tpu.analysis as RA
import dragonboat_tpu_torch.analysis as PA
from dragonboat_tpu.analysis.engine import SourceModule as RefSourceModule
from dragonboat_tpu_torch.analysis import (
    ALL_RULES,
    FAMILIES,
    RULES_VERSION,
    build_analyzer,
    unsuppressed,
)
from dragonboat_tpu_torch.analysis.callgraph import CallGraph, Program
from dragonboat_tpu_torch.analysis.engine import Analyzer, CrossRule, SourceModule
from dragonboat_tpu_torch.analysis.targets import DEFAULT_TARGETS, Targets

pytestmark = pytest.mark.lint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "dragonboat_tpu_torch")

#: the families both packages run with the same rule code
SHARED = {"columnar", "locks", "telemetry", "trace", "pragma", "config"}


# ---------------------------------------------------------------------------
# running the reference's test bodies against the port
# ---------------------------------------------------------------------------


def _key(f):
    return (f.rule, f.path, f.line, f.message, f.suppressed, f.suppress_reason)


def shared_findings(findings):
    return sorted(_key(f) for f in findings if f.rule.split("/")[0] in SHARED)


def ref_targets(t: Targets):
    """The reference's Targets carrying a port Targets' values wherever
    the two declare the same field, so the shared rules see one config."""
    names = {f.name for f in dataclasses.fields(RA.Targets)}
    kw = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name in names}
    kw["locks"] = [RA.LockSpec(s.cls, s.attr, s.rank, s.doc) for s in t.locks]
    return dataclasses.replace(RA.DEFAULT_TARGETS, **kw)


class Dual:
    """build_analyzer() of the port, shadowed by the reference's: each
    in-memory run goes through both and must give the same findings of
    the shared families; the port's findings are returned. Tree runs
    (`run`) analyze each package's own tree, so only the port's runs."""

    def __init__(self, families=None, targets=None, root=""):
        targets = DEFAULT_TARGETS if targets is None else targets
        self.port = build_analyzer(families=families, targets=targets, root=root)
        self.ref = RA.build_analyzer(families=families, targets=ref_targets(targets),
                                     root=root)

    def __getattr__(self, name):
        return getattr(self.port, name)

    def run(self, paths=None):
        return self.port.run(paths)

    def run_module(self, mod):
        got = self.port.run_module(mod)
        ref = self.ref.run_module(RefSourceModule("\n".join(mod.lines), mod.relpath, mod.path))
        assert shared_findings(got) == shared_findings(ref)
        return got

    def run_snippet(self, source, relpath="snippet.py"):
        return self.run_module(SourceModule.from_snippet(source, relpath))

    def run_sources(self, sources):
        got = self.port.run_sources(sources)
        assert shared_findings(got) == shared_findings(self.ref.run_sources(sources))
        return got


#: the port's objects under the names the reference's test modules use
PORT_NAMES = {
    "build_analyzer": Dual,
    "ALL_RULES": ALL_RULES,
    "FAMILIES": FAMILIES,
    "RULES_VERSION": RULES_VERSION,
    "unsuppressed": unsuppressed,
    "SourceModule": SourceModule,
    "DEFAULT_TARGETS": DEFAULT_TARGETS,
    "Targets": Targets,
    "Analyzer": Analyzer,
    "CrossRule": CrossRule,
    "CallGraph": CallGraph,
    "Program": Program,
}


@contextlib.contextmanager
def ported(mod, port_names):
    """Bind the port's objects (`port_names`: name -> object) into a
    reference test module for the duration of one test body."""
    names = [n for n in port_names if n in vars(mod)]
    saved = {n: vars(mod)[n] for n in names}
    vars(mod).update({n: port_names[n] for n in names})
    try:
        yield
    finally:
        vars(mod).update(saved)


def run_reference_test(module_name: str, test_name: str, request,
                       port_names=PORT_NAMES) -> None:
    """Call one test body of a reference test module with its names bound
    to the port's, its fixtures taken from `request`."""
    mod = importlib.import_module(module_name)
    fn = getattr(mod, test_name)
    kwargs = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    with ported(mod, port_names):
        fn(**kwargs)


# the reference's tests of the shared families and the engine; the rest
# (the JAX package's device-sync/retrace rules and its CLI name) have the
# port's own twins below
SHARED_TESTS = (
    "test_tree_has_zero_unsuppressed_findings",
    "test_columnar_catches_regressions",
    "test_lock_order_catches_inversion",
    "test_lock_order_catches_two_instance_inversion",
    "test_guarded_state_catches_unlocked_writes",
    "test_guarded_state_nested_def_does_not_inherit_lock",
    "test_lock_in_hot_loop_catches_regressions",
    "test_telemetry_catches_regressions",
    "test_trace_stamp_catches_regressions",
    "test_profiler_stamp_guard_catches_regressions",
    "test_profiler_stamp_guarded_stays_clean",
    "test_pragma_suppresses_with_reason",
    "test_standalone_pragma_covers_next_code_line_with_continuation",
    "test_pragma_without_reason_is_itself_a_finding",
    "test_legacy_hot_path_mark_still_suppresses",
    "test_unrelated_pragma_does_not_suppress",
    "test_missing_target_is_reported",
    "test_nonexistent_path_fails_loudly",
    "test_relative_paths_resolve_against_package_root",
    "test_restart_plane_locks_are_declared",
    "test_device_census_targets_are_declared",
    "test_restart_plane_guarded_state_catches_unlocked_free_list",
    "test_restart_plane_lock_order_nodes_mu_before_node_mu",
    "test_serving_plane_locks_are_declared",
    "test_serving_guarded_state_catches_unlocked_ledger_writes",
    "test_serving_lock_order_front_inside_node_flags",
)


@pytest.mark.parametrize("name", SHARED_TESTS)
def test_reference_meta_test_holds_on_the_port(name, request):
    run_reference_test("test_static_analysis", name, request)


def test_dual_run_sees_a_shared_family_disagreement():
    """The twin harness is not vacuous: a port Targets that drops a hot
    function changes the port's columnar findings, and Dual's check
    fails on it."""
    t = dataclasses.replace(DEFAULT_TARGETS, hot_functions=set())
    d = Dual(families=("columnar",), targets=t)
    d.ref = RA.build_analyzer(families=("columnar",))
    with pytest.raises(AssertionError):
        d.run_snippet(
            """
            class VectorEngine:
                def _decode(self, worked, packs, o):
                    for g in gs:
                        x = o['t'][g].item()
            """,
            "engine/vector.py",
        )


# ---------------------------------------------------------------------------
# the gate and the CLI over the port's tree
# ---------------------------------------------------------------------------


def _run(snippet: str, relpath: str, families=None):
    a = build_analyzer(families=families)
    return a.run_module(SourceModule.from_snippet(snippet, relpath))


def _ids(findings):
    return sorted(f.rule for f in findings if not f.suppressed)


def _check_cli(*argv, cwd=_REPO, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.tools.check", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_every_rule_documents_itself():
    for r in ALL_RULES:
        assert r.id and "/" in r.id, r
        assert r.doc, r.id
        assert r.motivation, r.id
    assert len({r.id for r in ALL_RULES}) == len(ALL_RULES)
    ids = {r.id for r in ALL_RULES}
    assert {
        "locks/cross-function-order",
        "locks/locked-callee-unheld",
        "locks/blocking-under-hot-lock",
        "build/cross-function",
        "build/cross-function-taint",
        "device-sync/cross-function",
    } <= ids
    assert not any(i.startswith("retrace/") for i in ids)
    assert RULES_VERSION.startswith("torch-")


def test_cli_clean_tree_exits_zero():
    p = _check_cli()
    assert p.returncode == 0, p.stdout + p.stderr
    assert "dragonboat_tpu_torch.tools.check: 0 finding(s)" in p.stdout


@functools.lru_cache(maxsize=None)
def tree_findings():
    """The full analyzer over the port's tree, once per process."""
    return tuple(build_analyzer().run())


def test_every_suppression_in_the_port_gives_a_reason():
    findings = tree_findings()
    sup = [f for f in findings if f.suppressed]
    assert sup, "the port's known suppressions"
    assert all(f.suppress_reason and f.suppress_reason != "(no reason given)"
               for f in sup), [f.render() for f in sup]
    assert not [f for f in findings if f.rule.startswith("pragma/")]


#: one known-bad snippet per family, under the relpath it watches
SEEDED = {
    "columnar": (
        "engine/vector.py",
        "class VectorEngine:\n"
        "    def _decode(self, worked, packs, o):\n"
        "        for g in gs:\n"
        "            x = o['term'][g].item()\n",
    ),
    "device-sync": (
        "engine/vector.py",
        "class VectorEngine:\n"
        "    def _decode(self, worked, packs, o):\n"
        "        x = self._state.term.cpu()\n",
    ),
    "build": (
        "ops/cuda.py",
        "def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):\n"
        "    if s.term.sum() > 0:\n"
        "        return s\n",
    ),
    "locks": (
        "transport/transport.py",
        "class _SendQueue:\n"
        "    def put_many(self, msgs):\n"
        "        for m in msgs:\n"
        "            with self._cv:\n"
        "                pass\n",
    ),
    "telemetry": (
        "transport/transport.py",
        "class Transport:\n"
        "    def send_many(self, msgs):\n"
        "        self.metrics.observe('x', (0, 0), 1.0)\n"
        "        flight_recorder().record('evt')\n",
    ),
    "trace": (
        "engine/node.py",
        "class Node:\n"
        "    def propose(self, session, cmd, timeout_ticks):\n"
        "        entry.trace_id = mint_trace_id()\n",
    ),
}


@pytest.mark.parametrize("family", sorted(SEEDED))
def test_cli_flags_seeded_bad_file_per_family(family, tmp_path):
    relpath, src = SEEDED[family]
    root = tmp_path / family
    target = root / relpath
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(src)
    p = _check_cli("--json", "--root", str(root), str(root))
    assert p.returncode == 1, (family, p.stdout, p.stderr)
    out = json.loads(p.stdout)
    assert family in {f["rule"].split("/")[0] for f in out["findings"]}, out


def test_cli_list_rules_renders_table():
    p = _check_cli("--list-rules", timeout=60)
    assert p.returncode == 0
    for r in ALL_RULES:
        assert r.id in p.stdout
        assert r.doc in p.stdout.replace("\n      ", " ")
    assert "[build]" in p.stdout and "[device-sync]" in p.stdout


def test_families_cover_the_port_contract():
    assert set(FAMILIES) >= {
        "columnar", "locks", "telemetry", "trace", "device-sync", "build",
    }
    assert "retrace" not in FAMILIES


def test_every_target_resolves_in_the_port():
    """Every function a target names exists in the port (no config
    drift), and the blessed seams are SyncAudit's pair."""
    from dragonboat_tpu_torch.profile import SyncAudit

    findings = tree_findings()
    assert not [f for f in findings if f.rule.startswith("config/")], findings
    assert {qn.split(".")[-1] for _rp, qn in DEFAULT_TARGETS.blessed_sync} == \
        {fn for _path, fn in SyncAudit.BLESSED}


# ---------------------------------------------------------------------------
# device-sync: torch's sync points
# ---------------------------------------------------------------------------


def test_device_sync_catches_regressions():
    got = _run(
        """
        class VectorEngine:
            def _decode(self, worked, packs, o):
                torch.cuda.synchronize()
                ev.synchronize()
                self._stream.synchronize()
                a = self._state.term.cpu()
                b = self._resid.mtype.numpy()
                c = self._state.commit.tolist()
                d = self._state.match.to("cpu")
                e = self._state.next.to(device="cpu")
                f = np.asarray(self._state.commit)
                h = int(self._state.last_index[3])
                i = self._state.term[0].item()
                j = bool(self._dev_out.t["quiesced"].any())
                for g in gs:
                    k = self._state.term[g]
        """,
        "engine/vector.py",
        families=("device-sync",),
    )
    assert _ids(got) == sorted(
        ["device-sync/synchronize"] * 3
        + ["device-sync/host-array"] * 6
        + ["device-sync/scalar-read"] * 3
        + ["device-sync/index-in-loop"]
    ), got


def test_device_sync_host_state_and_device_moves_stay_allowed():
    """Numpy mirrors, host copies TO the card and reads of tensors that
    are not device roots are not syncs."""
    got = _run(
        """
        class VectorEngine:
            def _decode(self, worked, packs, o):
                a = self._m_role.tolist()
                b = int(self._m_base[3])
                c = np.asarray(o["term"])
                d = self._h2d(a).to(self.device, non_blocking=True)
                self._dev_in.bytes.copy_(self._host_in.bytes, non_blocking=True)
                for g in gs:
                    e = self._m_last[g]
        """,
        "engine/vector.py",
        families=("device-sync",),
    )
    assert not _ids(got), got


def test_device_sync_blessed_seam_stays_allowed():
    got = _run(
        """
        class VectorEngine:
            def _fetch_output(self, pending):
                slot, ev = pending
                ev.synchronize()
                return dict(slot.np)
            def _fetch_super(self, pending):
                slot, ev = pending
                ev.synchronize()
                return slot.np
        """,
        "engine/vector.py",
        families=("device-sync",),
    )
    assert not _ids(got), got


def test_device_sync_off_the_hot_path_is_not_a_finding():
    got = _run(
        """
        class VectorEngine:
            def lane_stats(self):
                torch.cuda.synchronize()
                return self._state.term.cpu()
        """,
        "engine/vector.py",
        families=("device-sync",),
    )
    assert not _ids(got), got


def _port_vector_with(func: str, line: str):
    """The port's engine/vector.py with `line` inserted as the first
    statement of VectorEngine.<func> after its docstring (a mutation),
    and the 1-based line number it landed on."""
    import ast

    with open(os.path.join(_PORT, "engine", "vector.py")) as f:
        src = f.read()
    cls = next(n for n in ast.parse(src).body
               if isinstance(n, ast.ClassDef) and n.name == "VectorEngine")
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == func)
    first = fn.body[1] if isinstance(fn.body[0], ast.Expr) else fn.body[0]
    lines = src.split("\n")
    at = first.lineno - 1
    indent = lines[at][: len(lines[at]) - len(lines[at].lstrip())]
    return "\n".join(lines[:at] + [indent + line] + lines[at:]), at + 1


@pytest.mark.parametrize("func,line,flagged", [
    ("_decode", "_probe = self._state.term[0].item()", True),
    ("_decode", "_probe = self._state.commit.cpu()", True),
    ("_decode", "torch.cuda.current_stream().synchronize()", True),
    ("_fetch_output", "_probe = self._state.term[0].item()", False),
    ("_fetch_output", "torch.cuda.synchronize()", False),
])
def test_mutated_port_engine(func, line, flagged, tmp_path):
    """A sync inserted into a copy of the port's `_decode` is flagged; the
    same line inside the blessed `_fetch_output` is not."""
    src, at = _port_vector_with(func, line)
    root = tmp_path / "pkg"
    (root / "engine").mkdir(parents=True)
    (root / "engine" / "vector.py").write_text(src)
    findings = unsuppressed(build_analyzer(families=("device-sync",), root=str(root)).run())
    hits = [f for f in findings if f.line == at]
    assert bool(hits) is flagged, [f.render() for f in findings]
    if flagged:
        assert all(f.rule.startswith("device-sync/") for f in hits)
    # the unmutated engine is clean under the same run
    clean = tmp_path / "clean"
    (clean / "engine").mkdir(parents=True)
    with open(os.path.join(_PORT, "engine", "vector.py")) as f:
        (clean / "engine" / "vector.py").write_text(f.read())
    assert not unsuppressed(build_analyzer(families=("device-sync",), root=str(clean)).run())


# ---------------------------------------------------------------------------
# build: kernel builds on the launch path, host reads in launch wrappers
# ---------------------------------------------------------------------------


def test_build_catches_regressions_in_launch_wrappers():
    got = _run(
        """
        def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
            if s.term.sum() > 0:
                x = 1
            derived = s.last_index + 1
            while derived.any():
                pass
            assert ticks.max() < 8
            y = 1 if inbox.mtype[0, 0] else 0
            n = int(s.commit[0])
            m = ticks.item()
            c = np.asarray(ticks)
            d = s.term.cpu()
            e = inbox.mtype.to("cpu")
            lib = ctypes.CDLL("x.so")
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert _ids(got) == sorted(
        ["build/branch-in-launch"] * 4
        + ["build/host-read-in-launch"] * 5
        + ["build/build-in-hot"]
    ), got


def test_build_static_escapes_stay_allowed():
    """Shapes, dtypes, devices, addresses, contiguity and identity are
    metadata: checking them and filling a parameter struct is what a
    launch wrapper is for. `cfg` and `steps` are static."""
    got = _run(
        """
        def multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg, steps):
            G, P = s.member.shape
            if G > 8 and s.term.dtype == torch.int32:
                x = 1
            if s.term.device.type != "cuda" or not s.term.is_contiguous():
                raise ValueError("x")
            if len(ticks) > 4 or ticks.dim() != 1 or ticks.numel() == 0:
                pass
            if resid is None or inbox is not resid:
                pass
            if cfg.peers > 2:
                pass
            for t in range(steps):
                p = s.term.data_ptr() + t * s.term.stride(0) * s.term.element_size()
            if isinstance(route, torch.Tensor):
                pass
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert not _ids(got), got


def test_build_taint_flows_out_of_nested_blocks():
    got = _run(
        """
        def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
            for i in range(3):
                y = s.term + i
            z = y
            if z.any():
                pass
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert _ids(got) == ["build/branch-in-launch"], got


def test_build_step_count_must_be_static():
    """A super-step's step count is a Python int fixed per engine
    (`steps`, static); a tensor-valued count read on the host in the
    wrapper syncs every launch."""
    got = _run(
        """
        def multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg, k):
            for _ in range(int(k)):
                pass
            if k > 0:
                pass
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert _ids(got) == ["build/branch-in-launch", "build/host-read-in-launch"], got
    got = _run(
        """
        def multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg, steps):
            for _ in range(steps):
                pass
            if steps > 1:
                pass
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert not _ids(got), got


def test_build_in_hot_function():
    got = _run(
        """
        class VectorEngine:
            def _run_once(self):
                paths = build_kernels()
                lib = ctypes.CDLL(paths["step_batch.cu"])
                ext = torch.utils.cpp_extension.load(name="x", sources=[])
                ext2 = cpp_extension.load_inline(name="y", cpp_sources="")
                data = json.load(f)
        """,
        "engine/vector.py",
        families=("build",),
    )
    assert _ids(got) == ["build/build-in-hot"] * 4, got


def test_build_in_the_blessed_loader_stays_allowed():
    got = _run(
        """
        def _lib(src):
            with _lock:
                if src not in _libs:
                    _libs[src] = ctypes.CDLL(build_kernels()[src])
                return _libs[src]
        """,
        "ops/cuda.py",
        families=("build",),
    )
    assert not _ids(got), got
