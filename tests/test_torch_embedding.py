"""The embedding C ABI over the PyTorch port: `dragonboat_tpu_torch/native`
builds the port's own libdbtpu.so (native/binding/binding.cc with the
port's Python glue) and native/examples' two demo applications, compiled
unchanged, into build/torch_native/, and runs them with the NodeHost on
the CPU (DBTPU_DEVICE=cpu) — the twins of tests/test_embedding.py, marked
slow as there. Beside them: the C++ text outside the glue string is the
reference's, and without the request for the CPU the glue runs the engine
on the card (here, where there is none, the NodeHost refuses to start)."""
import fcntl
import os
import re
import shutil
import subprocess
import time

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLUGIN = os.path.join(_REPO, "native", "build", "libkvstore_sm.so")
_ONDISK_PLUGIN = os.path.join(_REPO, "native", "build", "libdiskkv_sm.so")
_GLUE = os.path.join(_REPO, "dragonboat_tpu_torch", "native", "binding.cc")
_REF = os.path.join(_REPO, "native", "binding", "binding.cc")


@pytest.fixture(scope="module")
def paths():
    """The port's library and demos, built when a test first needs them,
    under the port's build lock (dragonboat_tpu_torch.native), never while
    the module is collected; skips where there is no toolchain (no g++, or
    no Python development headers: a missing optional dependency, as in
    the reference's test). Any other build failure fails loudly."""
    from dragonboat_tpu_torch import native

    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("native toolchain unavailable")
    try:
        native.build_plugins()
        return native.build_embedding()
    except native.EmbedBuildError as e:
        if "Python.h" in str(e):
            pytest.skip("native toolchain unavailable")
        raise


def _run_demo(args, env, timeout):
    """Run a demo. The demos listen on fixed ports (27847, 27911), as the
    reference's do: a demo that found its port taken by another test's
    demo runs again once that one is done (at most `timeout` in all)."""
    deadline = time.monotonic() + timeout
    while True:
        with open(os.path.join(os.path.dirname(args[0]), ".demo.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            proc = subprocess.run(args, capture_output=True, text=True,
                                  timeout=max(1.0, deadline - time.monotonic()), env=env)
        if "Address already in use" not in proc.stderr or time.monotonic() > deadline:
            return proc
        time.sleep(1.0)


def _split(path):
    """(text before the glue string, the glue, text after it)."""
    src = open(path).read()
    a = src.index('R"PY(') + len('R"PY(')
    b = src.index(')PY"', a)
    return src[:a], src[a:b], src[b:]


def test_outside_the_glue_the_binding_is_the_reference_text():
    port, ref = _split(_GLUE), _split(_REF)
    assert (port[0], port[2]) == (ref[0], ref[2])
    assert port[1] != ref[1]


def test_glue_imports_the_port_and_never_the_jax_package():
    glue = _split(_GLUE)[1]
    roots = set(re.findall(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", glue, re.M))
    assert "dragonboat_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "dragonboat_tpu"}
    assert "jax" not in glue.lower()


def test_build_writes_the_port_library_and_demos(paths):
    from dragonboat_tpu_torch import native

    assert paths == native.build_embedding()
    for p in paths.values():
        assert os.path.dirname(p) == native.BUILD_DIR and os.path.exists(p)
    assert native.BUILD_DIR != os.path.join(_REPO, "native", "build")
    # the demos resolve the port's library, not the reference's
    ldd = subprocess.run(["ldd", paths["embed_demo"]], capture_output=True, text=True)
    if ldd.returncode == 0:
        line = next(ln for ln in ldd.stdout.splitlines() if "libdbtpu.so" in ln)
        assert native.BUILD_DIR in line


def test_default_device_is_the_card(tmp_path, paths):
    """Without DBTPU_DEVICE the glue asks for the card; on a machine with
    none the NodeHost start fails through the ABI, and no CPU engine runs."""
    import torch

    from dragonboat_tpu_torch import native

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run would use it")
    env = native.demo_env()
    env.pop("DBTPU_DEVICE")
    proc = _run_demo([paths["embed_demo"], str(tmp_path), _PLUGIN], env, 120)
    out = proc.stdout + proc.stderr
    assert "EMBED DEMO PASS" not in out
    assert "no CUDA device is available" in out


@pytest.mark.slow
def test_embed_demo_runs(tmp_path, paths):
    from dragonboat_tpu_torch import native

    proc = _run_demo([paths["embed_demo"], str(tmp_path), _PLUGIN],
                     native.demo_env("cpu"), 180)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "EMBED DEMO PASS" in proc.stdout


@pytest.mark.slow
def test_oo_demo_runs(tmp_path, paths):
    """The OO wrapper's demo (sessions, sync/async proposals, ReadIndex and
    local reads, membership and observer add, a snapshot request, restart
    with the on-disk plugin recovering its applied index) over the port's
    library."""
    from dragonboat_tpu_torch import native

    env = native.demo_env("cpu")
    env["DBTPU_DISKKV_DIR"] = str(tmp_path / "diskkv")
    proc = _run_demo([paths["oo_demo"], str(tmp_path), _ONDISK_PLUGIN], env, 600)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "OO DEMO PASS" in proc.stdout
