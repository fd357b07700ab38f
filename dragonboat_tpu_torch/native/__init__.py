"""The C embedding ABI (native/binding/dragonboat_tpu.h) over the PyTorch
package.

`binding.cc` beside this file is native/binding/binding.cc with its own
Python glue: the glue imports `dragonboat_tpu_torch`, and its NodeHosts run
the vector engine on the CUDA card unless the embedding application sets
DBTPU_DEVICE=cpu. `build_embedding()` compiles it with g++ into
`libdbtpu.so` under `build/torch_native/` at the repository root, with the
two example applications of native/examples (`embed_demo`, `oo_demo`)
compiled unchanged and linked against it. The C++ state machine plugins
the demos load come from `make -C native all` (`build_plugins()`), as the
JAX package's builds them.

A failed build raises EmbedBuildError with the compiler's output; nothing
falls back to native/build's library, which embeds the JAX package.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sysconfig
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
GLUE_SOURCE = os.path.join(_HERE, "binding.cc")
HEADER_DIR = os.path.join(NATIVE_DIR, "binding")
PLUGIN_DIR = os.path.join(NATIVE_DIR, "build")

_build_lock = threading.Lock()


@contextlib.contextmanager
def _locked():
    """Serialize builds across threads and processes (test workers build
    at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock, open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


class EmbedBuildError(RuntimeError):
    pass


def _python_flags():
    """Compile and link flags for embedding this interpreter's libpython."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise EmbedBuildError(f"Python.h not found under {inc}: the embedding "
                              "ABI needs the interpreter's development headers")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    libs = [f"-lpython{ver}"] + (sysconfig.get_config_var("LIBS") or "").split() + \
        (sysconfig.get_config_var("SYSLIBS") or "").split()
    return [f"-I{inc}"], [f"-L{libdir}", f"-Wl,-rpath,{libdir}"] + libs


def _stale(out: str, *srcs: str) -> bool:
    return not os.path.exists(out) or any(
        os.path.getmtime(s) > os.path.getmtime(out) for s in srcs)


def _compile(out: str, cmd) -> None:
    """Run one g++ command that writes `out` through a temporary name, so
    a concurrent reader never loads a half-written file."""
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise EmbedBuildError(f"embedding build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def build_embedding(force: bool = False) -> Dict[str, str]:
    """Build (when a source is newer than its output) the port's
    `libdbtpu.so`, `embed_demo` and `oo_demo` into BUILD_DIR; returns
    their paths."""
    cxx = os.environ.get("CXX", "g++")
    flags = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
    lib = os.path.join(BUILD_DIR, "libdbtpu.so")
    header = os.path.join(HEADER_DIR, "dragonboat_tpu.h")
    demos = {
        "embed_demo": (os.path.join(NATIVE_DIR, "examples", "embed_demo.cc"), []),
        "oo_demo": (os.path.join(NATIVE_DIR, "examples", "oo_demo.cc"),
                    [os.path.join(HEADER_DIR, "dragonboat_tpu.hpp")]),
    }
    with _locked():
        if force or _stale(lib, GLUE_SOURCE, header):
            inc, link = _python_flags()
            _compile(lib, [cxx] + flags + inc + [f"-I{HEADER_DIR}", "-shared",
                                                 GLUE_SOURCE] + link)
        out = {"libdbtpu": lib}
        for name, (src, deps) in demos.items():
            path = os.path.join(BUILD_DIR, name)
            if force or _stale(path, src, lib, header, *deps):
                _compile(path, [cxx] + flags + [src, f"-L{BUILD_DIR}",
                                                "-Wl,-rpath,$ORIGIN", "-ldbtpu", "-lpthread"])
            out[name] = path
    return out


def build_plugins() -> Dict[str, str]:
    """`make -C native all`: libwalkv.so and the example C++ state machine
    plugins (regular, concurrent, on-disk) into native/build; returns the
    plugins' paths."""
    with _locked():
        proc = subprocess.run(["make", "-C", NATIVE_DIR, "all"], capture_output=True,
                              text=True)
    if proc.returncode != 0:
        raise EmbedBuildError(f"native build failed:\n{proc.stderr}")
    return {name: os.path.join(PLUGIN_DIR, f"lib{name}_sm.so")
            for name in ("kvstore", "concurrent", "diskkv")}


def demo_env(device: str = "cuda") -> Dict[str, str]:
    """The environment a demo runs in: this repository on PYTHONPATH (the
    embedded interpreter imports the package from there) and the engine's
    device."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DBTPU_DEVICE"] = device
    return env

