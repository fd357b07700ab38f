"""Twins of test_hot_path_lint.py and test_callgraph_lint.py for the
port's analyzer.

The reference's tests of the shared engine, the call graph and the
shared families (columnar, locks, telemetry, trace, the pragmas) run
unchanged against the port (test_torch_static_analysis.ported/Dual:
every snippet through both packages, the same findings of the shared
families, then the reference's assertions on the port's). The port's own
cross-function families get their own snippets here: `device-sync/
cross-function` (a torch sync in a helper the hot path reaches, e.g. an
`ev.synchronize()` one frame below `_decode`), `build/cross-function`
(a kernel build or load reachable from the launch path, constructor
edges included) and `build/cross-function-taint` (tensor taint from a
launch wrapper into the helpers it calls). Then the CLI: `--json`
schema, `--baseline`, `--changed`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from dragonboat_tpu_torch.analysis import ALL_RULES, RULES_VERSION, build_analyzer, unsuppressed
from dragonboat_tpu_torch.analysis.engine import Analyzer, CrossRule
from dragonboat_tpu_torch.analysis.targets import DEFAULT_TARGETS

from test_torch_static_analysis import run_reference_test

pytestmark = pytest.mark.lint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOT_PATH_TESTS = (
    "test_hot_path_stays_columnar",
    "test_transport_send_path_amortizes_locks",
    "test_hot_path_telemetry_is_sampling_guarded",
    "test_trace_stamping_is_sampling_guarded",
    "test_lint_catches_regressions",
    "test_lock_lint_catches_regressions",
    "test_telemetry_lint_catches_regressions",
    "test_trace_lint_catches_regressions",
)

CALLGRAPH_TESTS = (
    "test_callgraph_resolves_self_method_and_module_function",
    "test_callgraph_resolves_method_through_base_class",
    "test_callgraph_resolves_package_relative_import",
    "test_callgraph_nested_def_gets_deferred_edge_and_call_edge",
    "test_callgraph_dynamic_calls_degrade_to_no_edge",
    "test_callgraph_records_held_locks_at_call_sites",
    "test_caller_modules_of_reports_cross_module_callers",
    "test_cross_function_lock_inversion_is_caught",
    "test_cross_function_lock_inversion_missed_by_lexical_rules",
    "test_cross_function_order_two_frames_down",
    "test_cross_function_order_inner_rank_is_clean",
    "test_same_lock_reacquired_through_chain_is_flagged",
    "test_locked_callee_without_lock_is_flagged",
    "test_locked_callee_under_declared_lock_is_clean",
    "test_locked_callee_from_locked_sibling_is_clean",
    "test_locked_callee_under_auxiliary_receiver_lock_is_clean",
    "test_locked_callee_on_other_receiver_lock_is_flagged",
    "test_blocking_reachable_under_hot_lock_is_caught",
    "test_blocking_under_hot_lock_missed_by_lexical_rules",
    "test_direct_sleep_under_hot_lock_is_caught",
    "test_cv_wait_on_held_lock_is_exempt",
    "test_blocking_under_cold_lock_is_clean",
    "test_deferred_closure_acquisition_not_treated_as_nested",
    "test_deferred_closure_calling_locked_method_is_flagged",
    "test_closure_invoked_directly_under_with_keeps_held_set",
    # `.item()` on `self._state` is a sync in both packages
    "test_item_on_device_root_in_reachable_helper_is_caught",
    "test_item_outside_hot_modules_is_not_a_device_sync",
    "test_unused_pragma_is_reported",
    "test_unused_pragma_allowlist_escape",
    "test_unused_pragma_silent_on_family_restricted_runs",
    "test_docstring_mention_of_pragma_syntax_is_not_a_pragma",
    "test_cross_rules_never_fire_lexically",
)


@pytest.mark.parametrize("name", HOT_PATH_TESTS)
def test_reference_hot_path_lint_holds_on_the_port(name, request):
    run_reference_test("test_hot_path_lint", name, request)


@pytest.mark.parametrize("name", CALLGRAPH_TESTS)
def test_reference_callgraph_lint_holds_on_the_port(name, request):
    run_reference_test("test_callgraph_lint", name, request)


def test_e2e_report_carries_commit_latency_keys():
    """The port's e2e records carry bench.py's latency keys (the twin of
    test_bench_json_carries_commit_latency_keys)."""
    from dragonboat_tpu_torch import e2e
    from dragonboat_tpu_torch.events import MetricsRegistry

    class FakeNH:
        def __init__(self):
            self.metrics = MetricsRegistry()

    nh = FakeNH()
    for v in (0.001, 0.002, 0.004, 0.008):
        nh.metrics.observe("proposal_commit_latency_seconds", (1, 1), v)
        nh.metrics.observe("proposal_apply_latency_seconds", (1, 1), 2 * v)
    r = e2e.latency_report({1: nh})
    assert set(r) >= {
        "commit_latency_p50_s", "commit_latency_p99_s", "commit_latency_samples",
        "apply_latency_p99_s", "fsync_latency_p99_s",
    }
    assert r["commit_latency_samples"] == 4
    assert 0 < r["commit_latency_p50_s"] <= r["commit_latency_p99_s"]
    r0 = e2e.latency_report({})
    assert r0["commit_latency_p50_s"] == 0.0 and r0["commit_latency_p99_s"] == 0.0


# ---------------------------------------------------------------------------
# the port's cross-function families
# ---------------------------------------------------------------------------


def _xrun(sources):
    return build_analyzer().run_sources(dict(sources))


def _ids(findings, family=None):
    ids = sorted({f.rule for f in unsuppressed(findings)})
    return [i for i in ids if family is None or i.startswith(family)]


def _lexical_only(sources):
    rules = [r for r in ALL_RULES if not isinstance(r, CrossRule)]
    analyzer = Analyzer(rules, DEFAULT_TARGETS)
    out = []
    for rel, src in sources.items():
        out.extend(analyzer.run_snippet(src, rel))
    return out


_HIDDEN_SYNC = {
    "engine/vector.py": """
        class VectorEngine:
            def _decode(self):
                return self._probe()
            def _probe(self):
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
        """,
}


def test_event_wait_in_helper_reachable_from_hot_is_caught():
    findings = [f for f in unsuppressed(_xrun(_HIDDEN_SYNC))
                if f.rule == "device-sync/cross-function"]
    assert len(findings) == 1, findings
    assert "ev.synchronize()" in findings[0].message
    assert "VectorEngine._decode -> VectorEngine._probe" in findings[0].message


def test_hidden_sync_missed_by_lexical_rules():
    assert _ids(_lexical_only(_HIDDEN_SYNC), "device-sync") == []


def test_chain_through_blessed_seam_is_clean():
    findings = _xrun({
        "engine/vector.py": """
            class VectorEngine:
                def _decode(self):
                    return self._fetch_output(self._pending)
                def _fetch_output(self, pending):
                    slot, ev = pending
                    ev.synchronize()
                    return self._state.term.cpu()
            """,
    })
    assert _ids(findings, "device-sync") == []


def test_host_copy_in_helper_two_frames_down_is_caught():
    findings = _xrun({
        "engine/vector.py": """
            from .util import fold

            class VectorEngine:
                def _decode_apply(self, o):
                    self._mid()
                def _mid(self):
                    return self._leaf()
                def _leaf(self):
                    return self._resid.mtype.to(device="cpu")
            """,
        "engine/util.py": """
            def fold(x):
                torch.cuda.synchronize()
            """,
    })
    msgs = [f.message for f in unsuppressed(findings) if f.rule == "device-sync/cross-function"]
    assert len(msgs) == 1, msgs
    assert '.to("cpu")' in msgs[0]
    assert "_decode_apply -> VectorEngine._mid -> VectorEngine._leaf" in msgs[0]


def test_build_reachable_from_the_hot_path_is_caught():
    """A build or a library load in a helper the hot path reaches, here
    through a constructor (`_Launcher(dev)` -> `_Launcher.__init__`),
    which the shared call graph does not resolve."""
    sources = {
        "engine/vector.py": """
            from ..ops.kernel import step

            class VectorEngine:
                def _run_once(self):
                    step(self._state)
            """,
        "ops/kernel.py": """
            class _Launcher:
                def __init__(self, dev):
                    self.lib = ctypes.CDLL(build_kernels()["step.cu"])

            def step(s):
                _Launcher(s.term.device)
            """,
    }
    findings = [f for f in unsuppressed(_xrun(sources)) if f.rule == "build/cross-function"]
    assert sorted(f.message.split("(")[0] for f in findings) == [
        "_Launcher.__init__: build_kernels", "_Launcher.__init__: ctypes.CDLL"]
    assert "VectorEngine._run_once -> step -> _Launcher.__init__" in findings[0].message
    assert _ids(_lexical_only(sources), "build") == []


def test_build_through_the_blessed_loader_is_clean():
    findings = _xrun({
        "ops/cuda.py": """
            def _lib(src):
                return ctypes.CDLL(build_kernels()[src])

            class _Launcher:
                def __init__(self, device):
                    self.fn = _lib("step_batch.cu")

            def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
                _Launcher(s.term.device)
            """,
    })
    assert _ids(findings, "build") == []


def test_the_ports_launch_path_reaches_the_loader_only_through_the_seam():
    """Over the port's own tree: without the blessed loader the launch
    path's build is reported (so the rule is live on the real code), and
    with it nothing is."""
    import dataclasses

    t = dataclasses.replace(DEFAULT_TARGETS, blessed_build=set())
    findings = unsuppressed(build_analyzer(families=("build",), targets=t).run())
    where = {(f.path.rsplit("/", 2)[-2:][-1], f.message.split(":")[0]) for f in findings}
    assert ("cuda.py", "_lib") in where, [f.render() for f in findings]
    assert not unsuppressed(build_analyzer(families=("build",)).run())


_HELPER_READ = {
    "ops/cuda.py": """
        from .util import check

        def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
            check(s.term)
            return s, out
        """,
    "ops/util.py": """
        def check(x):
            if x.max() > 0:
                return 1
            return int(x[0])
        """,
}


def test_tensor_read_in_helper_of_a_launch_wrapper_is_caught():
    findings = [f for f in unsuppressed(_xrun(_HELPER_READ))
                if f.rule == "build/cross-function-taint"]
    assert len(findings) == 2, findings
    assert all(f.path == "ops/util.py" for f in findings)
    assert all("`x` of check tainted by step_batch_cuda" in f.message for f in findings)


def test_helper_read_missed_by_lexical_rules():
    assert _ids(_lexical_only(_HELPER_READ), "build") == []


def test_taint_killed_by_static_escapes():
    findings = _xrun({
        "ops/cuda.py": """
            from .util import check

            def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
                check(s.term)
            """,
        "ops/util.py": """
            def check(x):
                n = x.shape[0]
                if n > 2 or x.dtype != torch.int32 or not x.is_contiguous():
                    return x.data_ptr()
                if len(x) > 4 or x.device.type != "cuda" or x is None:
                    return 2
                return 0
            """,
    })
    assert _ids(findings, "build/cross-function-taint") == []


def test_return_taint_flows_back_to_callers():
    """A helper that returns a tensor it was handed taints what the launch
    wrapper assigns, and the next helper's branch on it is caught. Taint
    is born in the launch wrappers only: `other`, a caller of the same
    helper that hands it no tensor of a launch, stays clean (the JAX
    package's retrace taint is context-insensitive there; a CPU-side
    caller of a shared helper would read as a per-launch sync)."""
    sources = {
        "ops/cuda.py": """
            from .util import pick, check

            def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
                y = pick(s.term)
                check(y)
            """,
        "ops/util.py": """
            def pick(x):
                y = x
                return y

            def check(v):
                while v.any():
                    v = v - 1

            def other(n):
                flag = pick(n)
                while flag:
                    flag = 0
            """,
    }
    msgs = [f.message for f in unsuppressed(_xrun(sources))
            if f.rule == "build/cross-function-taint"]
    assert len(msgs) == 1, msgs
    assert msgs[0].startswith("check: Python `while`")
    assert "`v` of check tainted by step_batch_cuda" in msgs[0]
    assert _ids(_lexical_only(sources), "build") == []


def test_metadata_returning_helper_does_not_taint_its_caller():
    """A helper handed tensors that returns shapes (`step_shapes`) does
    not taint what its caller assigns: a resolved call is tainted by its
    return only."""
    findings = _xrun({
        "ops/cuda.py": """
            def shapes(s):
                G, P = s.member.shape
                return G, P, s.log_term.shape[1]

            def prepare(s):
                G, P, W = shapes(s)
                if W < 1 or G > 8:
                    raise ValueError("x")

            def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):
                prepare(s)
            """,
    })
    assert _ids(findings, "build/cross-function-taint") == []


def test_untainted_caller_does_not_taint_helper():
    findings = _xrun({
        "nodehost.py": """
            from .util import pick

            class NodeHost:
                def admin(self, req):
                    return pick(req)
            """,
        "util.py": """
            def pick(x):
                if x:
                    return 1
                return 0
            """,
    })
    assert _ids(findings, "build/cross-function-taint") == []


def test_constructor_edge_carries_taint_into_init():
    findings = _xrun({
        "ops/cuda.py": """
            class _Block:
                def __init__(self, s, n):
                    if s.term.sum() > n:
                        pass

            def multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg, steps):
                _Block(s, 1)
            """,
    })
    msgs = [f.message for f in unsuppressed(findings) if f.rule == "build/cross-function-taint"]
    assert len(msgs) == 1 and "`s` of _Block.__init__ tainted by multi_step_cuda" in msgs[0]


def test_used_pragma_is_not_reported(tmp_path):
    root = tmp_path / "overlay"
    (root / "engine").mkdir(parents=True)
    (root / "engine" / "vector.py").write_text(
        "class VectorEngine:\n"
        "    def _decode(self):\n"
        "        self._state.term.cpu()  # lint: allow(device-sync) one-off probe\n")
    findings = build_analyzer(root=str(root)).run(None)
    assert _ids(findings, "pragma") == []
    assert [f.rule for f in findings if f.suppressed] == ["device-sync/host-array"]


def test_interprocedural_rules_are_registered():
    ids = {r.id for r in ALL_RULES}
    assert {
        "locks/cross-function-order",
        "locks/locked-callee-unheld",
        "locks/blocking-under-hot-lock",
        "build/cross-function",
        "build/cross-function-taint",
        "device-sync/cross-function",
    } <= ids


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _check_cli(*argv, cwd=_REPO, env=None):
    return subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.tools.check", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def _write_overlay(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


_CLEAN = "class VectorEngine:\n    def _decode(self):\n        return 1\n"
_BAD = (
    "class VectorEngine:\n"
    "    def _decode(self):\n"
    "        return self._state.term.cpu()\n"
)


def test_cli_json_schema_is_pinned(tmp_path):
    root = tmp_path / "overlay"
    _write_overlay(root, {"engine/vector.py": _BAD})
    p = _check_cli("--json", "--root", str(root), str(root))
    assert p.returncode == 1, p.stdout + p.stderr
    out = json.loads(p.stdout)
    assert set(out) == {"findings", "unsuppressed", "suppressed", "ok", "rule_version"}
    assert out["rule_version"] == RULES_VERSION
    assert out["ok"] is False and out["unsuppressed"] >= 1
    assert set(out["findings"][0]) == {
        "rule", "path", "line", "message", "snippet", "suppressed", "suppress_reason",
    }


def test_cli_baseline_roundtrip(tmp_path):
    root = tmp_path / "overlay"
    _write_overlay(root, {"engine/vector.py": _BAD})
    snap = _check_cli("--json", "--root", str(root), str(root))
    base = tmp_path / "baseline.json"
    base.write_text(snap.stdout)
    p = _check_cli("--baseline", str(base), "--root", str(root), str(root))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new, 0 fixed" in p.stdout
    _write_overlay(root, {"engine/vector.py": _BAD + (
        "    def _pack(self):\n"
        "        return self._state.commit.item()\n")})
    p = _check_cli("--baseline", str(base), "--root", str(root), str(root))
    assert p.returncode == 1, p.stdout + p.stderr
    assert "_pack" in p.stdout
    assert "_decode" not in p.stdout
    _write_overlay(root, {"engine/vector.py": _CLEAN})
    p = _check_cli("--baseline", str(base), "--root", str(root), str(root))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "1 fixed" in p.stdout


def _git(root, *args):
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=root, capture_output=True, text=True, check=True)


def test_cli_changed_mode_filters_to_diff_plus_callers(tmp_path):
    root = tmp_path / "overlay"
    _write_overlay(root, {
        "engine/vector.py": _BAD,
        "ops/util.py": "def fold(s):\n    return s\n",
        "ops/cuda.py": (
            "from .util import fold\n\n"
            "def step_batch_cuda(s, inbox, ticks, cfg=None, out=None):\n"
            "    return fold(s)\n"
        ),
    })
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")
    (root / "ops/util.py").write_text(
        "def fold(s):\n    if s:\n        return 1\n    return s\n")
    p = _check_cli("--changed", "HEAD", "--root", str(root))
    assert p.returncode == 1, p.stdout + p.stderr
    assert "cross-function-taint" in p.stdout
    assert "device-sync" not in p.stdout
    assert "1 file(s)" in p.stdout and "caller module(s)" in p.stdout
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "helper branch")
    p = _check_cli("--changed", "HEAD", "--root", str(root))
    assert p.returncode == 0, p.stdout + p.stderr


def test_cli_changed_outside_git_fails_loudly(tmp_path):
    root = tmp_path / "overlay"
    _write_overlay(root, {"engine/vector.py": _CLEAN})
    env = dict(os.environ, GIT_CEILING_DIRECTORIES=str(tmp_path))
    p = _check_cli("--changed", "--root", str(root), env=env)
    assert p.returncode == 2, p.stdout + p.stderr
