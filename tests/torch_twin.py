"""Run a reference test file's scenarios on the PyTorch port.

`port_copy("test_x")` loads tests/test_x.py with every `dragonboat_tpu`
module name mapped to `dragonboat_tpu_torch` and executes it as a module of
its own, `test_x_on_port`: the reference's test bodies, fixtures, helper
classes and seeds, bound to the port's NodeHost, engines, LoopbackCluster
and scalar core. The port path imports nothing of the JAX package. Its
engines run on the CPU: in the copy, `EngineConfig`, `NodeHostConfig`'s
default engine and `LoopbackCluster` default to `device="cpu"` (the port's
own default is the card). A `from tests.<m> import ...` in the reference
loads `<m>` the same way.

`reference_tests(mod)` is what a twin file exports so that pytest collects
the copy's tests (with their marks and parametrisations) and fixtures under
the twin's name. `recording(mod, names)` records what a module's helper
functions return, `instances(mod, names)` the objects its classes make
and `cluster_counters(mod)` each LoopbackCluster step's counter planes,
which lets a twin run the same seeded test body through both packages
and hold the traces equal.
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
import os
import re
import sys
import types

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
_REF_NAME = re.compile(r"\bdragonboat_tpu\b(?!_torch)")
_TESTS_IMPORT = re.compile(r"^(\s*)from tests\.(\w+) import", re.M)
SUFFIX = "_on_port"


def _cpu_defaults(mod) -> None:
    """Bind the copy's engine constructors to the CPU."""
    C = importlib.import_module("dragonboat_tpu_torch.config")

    def EngineConfig(*args, **kw):
        kw.setdefault("device", "cpu")
        return C.EngineConfig(*args, **kw)

    def NodeHostConfig(*args, **kw):
        if "engine" not in kw:
            kw["engine"] = EngineConfig()
        return C.NodeHostConfig(*args, **kw)

    bound = {"EngineConfig": EngineConfig, "NodeHostConfig": NodeHostConfig}
    if "LoopbackCluster" in vars(mod):
        from dragonboat_tpu_torch.ops.loopback import LoopbackCluster as LC

        class LoopbackCluster(LC):
            def __init__(self, *args, device="cpu", **kw):
                super().__init__(*args, device=device, **kw)

        bound["LoopbackCluster"] = LoopbackCluster
    for name, obj in bound.items():
        if name in vars(mod):
            setattr(mod, name, obj)


def port_source(name: str) -> str:
    with open(os.path.join(TESTS, name + ".py")) as f:
        src = f.read()
    for dep in set(_TESTS_IMPORT.findall(src)):
        port_copy(dep[1])
    src = _TESTS_IMPORT.sub(lambda m: f"{m.group(1)}from {m.group(2)}{SUFFIX} import", src)
    return _REF_NAME.sub("dragonboat_tpu_torch", src)


def port_copy(name: str) -> types.ModuleType:
    """tests/<name>.py bound to the port (one module per process)."""
    mod_name = name + SUFFIX
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(TESTS, name + ".py")
    mod = types.ModuleType(mod_name, None)
    mod.__file__ = path
    sys.modules[mod_name] = mod
    try:
        exec(compile(port_source(name), path, "exec"), vars(mod))
    except BaseException:
        del sys.modules[mod_name]
        raise
    _cpu_defaults(mod)
    return mod


def _is_fixture(obj) -> bool:
    return type(obj).__name__ == "FixtureFunctionDefinition" or hasattr(
        obj, "_pytestfixturefunction")


def reference_tests(mod) -> dict:
    """The names a twin file exports: the copy's test functions, test
    classes, fixtures and module marks."""
    out = {}
    for name, obj in vars(mod).items():
        if name == "pytestmark":
            out[name] = obj
        elif _is_fixture(obj):
            out[name] = obj
        elif name.startswith("test_") and inspect.isfunction(obj):
            out[name] = obj
        elif name.startswith("Test") and inspect.isclass(obj):
            out[name] = obj
    return out


@contextlib.contextmanager
def recording(mod, names):
    """Record every return value of `mod`'s functions `names` (a list per
    name) for the duration of the block."""
    saved = {n: getattr(mod, n) for n in names}
    got = {n: [] for n in names}

    def wrap(n, fn):
        def rec(*a, **kw):
            r = fn(*a, **kw)
            got[n].append(r)
            return r
        return rec

    for n, fn in saved.items():
        setattr(mod, n, wrap(n, fn))
    try:
        yield got
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


@contextlib.contextmanager
def cluster_counters(mod):
    """Record each LoopbackCluster's cumulative counter planes (one list of
    replicas' (G, CTR) planes per step) made in `mod` during the block."""
    import numpy as np

    base = mod.LoopbackCluster
    got = []

    class Recording(base):
        def step(self, tick=True):
            super().step(tick=tick)
            got.append([np.asarray(c).tolist() for c in self.counters])

    mod.LoopbackCluster = Recording
    try:
        yield got
    finally:
        mod.LoopbackCluster = base


@contextlib.contextmanager
def instances(mod, names):
    """Record every instance of `mod`'s classes `names` (a list per name)
    made during the block."""
    saved = {n: getattr(mod, n) for n in names}
    got = {n: [] for n in names}

    def recording_class(n, cls):
        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                got[n].append(self)

        Recording.__name__ = cls.__name__
        return Recording

    for n, cls in saved.items():
        setattr(mod, n, recording_class(n, cls))
    try:
        yield got
    finally:
        for n, cls in saved.items():
            setattr(mod, n, cls)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain step is thousands of tiny ops: torch's intra-op thread
    pool only adds overhead at these widths (and engines share it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
