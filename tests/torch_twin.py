"""Run a reference test file's scenarios on the PyTorch port.

`port_copy("test_x")` loads tests/test_x.py with every `dragonboat_tpu`
module name mapped to `dragonboat_tpu_torch` and executes it as a module of
its own, `test_x_on_port`: the reference's test bodies, fixtures, helper
classes and seeds, bound to the port's NodeHost, engines, LoopbackCluster
and scalar core. The port path imports nothing of the JAX package. A
`from tests.<m> import ...` in the reference loads `<m>` the same way.

The copy's engines run on the CPU (the port's own default is the card),
or on the `device` that `port_copy` is given: chip_smoke.py runs the
same bodies on the card as `test_x_on_port_cuda`. Every import statement
the copy executes, at module level or inside a function or fixture,
goes through the copy's own `__import__` (`_copy_import`, installed as
the copy's `__builtins__`): it hands out `EngineConfig`, `NodeHostConfig`
(whose default engine is then one on that device) and `LoopbackCluster`
defaulting to that device, and resolves `import bench` (the reference's
benchmark, a JAX program) to the port's counterpart
`dragonboat_tpu_torch.e2e`, so a name that e2e lacks raises. Nothing
outside the copy changes: the port's modules keep their own defaults.
Source that a copy writes out for a child process runs the port as it
is.

`reference_tests(mod)` is what a twin file exports so that pytest collects
the copy's tests (with their marks and parametrisations) and fixtures under
the twin's name. `recording(mod, names)` records what a module's helper
functions return, `instances(mod, names)` the objects its classes make,
`cluster_counters(mod)` each LoopbackCluster step's counter planes and
`calls(cls, methods)` what a class's methods return, which lets a twin
run the same seeded test body through both packages and hold the traces
equal. `in_mem_log_watch()` records the largest in-memory log size a
replica of the port reached beside its `max_in_mem_log_size`, and
`reporting(test, watch)` prints that record when a test body fails.
"""
from __future__ import annotations

import builtins
import contextlib
import functools
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


# the port's counterpart of the reference's bench.py
BENCH = "dragonboat_tpu_torch.e2e"


def _bound_module(real, names):
    """`real` with `names` in place of its own attributes."""
    m = types.ModuleType(real.__name__, real.__doc__)
    vars(m).update(names, __getattr__=lambda n: getattr(real, n))
    return m


@functools.cache
def _bound_modules(device: str) -> dict:
    """The modules a copy imports its engine constructors from, each with
    the constructors defaulting to `device`."""
    C = importlib.import_module("dragonboat_tpu_torch.config")
    L = importlib.import_module("dragonboat_tpu_torch.ops.loopback")

    def EngineConfig(*args, **kw):
        kw.setdefault("device", device)
        return C.EngineConfig(*args, **kw)

    def NodeHostConfig(*args, **kw):
        if "engine" not in kw:
            kw["engine"] = EngineConfig()
        return C.NodeHostConfig(*args, **kw)

    class LoopbackCluster(L.LoopbackCluster):
        def __init__(self, *args, device=device, **kw):
            super().__init__(*args, device=device, **kw)

    return {C.__name__: _bound_module(C, {"EngineConfig": EngineConfig,
                                          "NodeHostConfig": NodeHostConfig}),
            L.__name__: _bound_module(L, {"LoopbackCluster": LoopbackCluster})}


def _copy_import(name, globals=None, locals=None, fromlist=(), level=0, *, device="cpu"):
    """A copy's `__import__`: the constructors bound to `device` and the
    port's bench; every other import as usual."""
    if level == 0 and name == "bench":
        return importlib.import_module(BENCH)
    mod = __import__(name, globals, locals, fromlist, level)
    if level == 0 and fromlist:
        return _bound_modules(device).get(name, mod)
    return mod


def _suffix(device: str) -> str:
    return SUFFIX if device == "cpu" else f"{SUFFIX}_{device}"


def port_source(name: str, device: str = "cpu") -> str:
    with open(os.path.join(TESTS, name + ".py")) as f:
        src = f.read()
    for dep in set(_TESTS_IMPORT.findall(src)):
        port_copy(dep[1], device)
    suffix = _suffix(device)
    src = _TESTS_IMPORT.sub(lambda m: f"{m.group(1)}from {m.group(2)}{suffix} import", src)
    return _REF_NAME.sub("dragonboat_tpu_torch", src)


def port_copy(name: str, device: str = "cpu") -> types.ModuleType:
    """tests/<name>.py bound to the port, its engines on `device` (one
    module per process and device)."""
    mod_name = name + _suffix(device)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(TESTS, name + ".py")
    mod = types.ModuleType(mod_name, None)
    mod.__file__ = path
    mod.__builtins__ = dict(vars(builtins),
                            __import__=functools.partial(_copy_import, device=device))
    sys.modules[mod_name] = mod
    try:
        exec(compile(port_source(name, device), path, "exec"), vars(mod))
    except BaseException:
        del sys.modules[mod_name]
        raise
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


@contextlib.contextmanager
def calls(cls, methods, probe=None):
    """Record, during the block, what each method of `methods` of the class
    `cls` returns: a list of (method name, result) in call order, or of
    (method name, probe(object, result)) when `probe` is given. The class
    itself is patched, so objects made through any import of it are seen
    (a test body that imports its NodeHost inside the function)."""
    saved = {n: vars(cls)[n] for n in methods}
    got = []

    def wrap(n, fn):
        @functools.wraps(fn)
        def call(self, *a, **kw):
            r = fn(self, *a, **kw)
            got.append((n, r if probe is None else probe(self, r)))
            return r
        return call

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield got
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


@contextlib.contextmanager
def in_mem_log_watch(pkg: str = "dragonboat_tpu_torch"):
    """Record, during the block, the in-memory log sizes the port's replicas
    reached and the limit they were held to (Config.max_in_mem_log_size):
    on the vector engine the arena's unapplied bytes, at every placement
    (`peak_bytes`) and where a proposal checks the limit
    (`peak_bytes_at_check`, `checks`, `limited_checks`); on the scalar core
    its RateLimiter's bytes (`peak_bytes`, `limit`); and on either, the
    proposals the full incoming queue refused (`queue_full`), the other
    source of ErrSystemBusy. Yields the record."""
    V = importlib.import_module(pkg + ".engine.vector")
    RL = importlib.import_module(pkg + ".core.rate").RateLimiter
    Q = importlib.import_module(pkg + ".engine.queue").EntryQueue
    got = {"limit": 0, "peak_bytes": 0, "peak_bytes_at_check": 0, "checks": 0,
           "limited_checks": 0, "queue_full": 0}
    prop, setitem, add = V.VectorNode._rate_limited, V._Arena.__setitem__, Q.add
    saved = {n: vars(RL)[n] for n in ("increase", "set")}

    def checked(node):
        limited = prop.fget(node)
        lane = node._vec_lane
        if node.config.max_in_mem_log_size and lane is not None:
            got["limit"] = node.config.max_in_mem_log_size
            got["peak_bytes_at_check"] = max(got["peak_bytes_at_check"],
                                             lane.arena.unapplied_bytes)
            got["checks"] += 1
            got["limited_checks"] += bool(limited)
        return limited

    def queued(q, e):
        ok = add(q, e)
        got["queue_full"] += not ok
        return ok

    def placed(arena, key, entry):
        setitem(arena, key, entry)
        got["peak_bytes"] = max(got["peak_bytes"], arena.unapplied_bytes)

    def counted(fn):
        @functools.wraps(fn)
        def call(rl, n):
            fn(rl, n)
            if rl.max_bytes:
                got["limit"] = rl.max_bytes
                got["peak_bytes"] = max(got["peak_bytes"], rl.get())
        return call

    V.VectorNode._rate_limited = property(checked, prop.fset)
    V._Arena.__setitem__ = placed
    Q.add = queued
    for n, fn in saved.items():
        setattr(RL, n, counted(fn))
    try:
        yield got
    finally:
        V.VectorNode._rate_limited = prop
        V._Arena.__setitem__ = setitem
        Q.add = add
        for n, fn in saved.items():
            setattr(RL, n, fn)


def reporting(test, watch):
    """`test` (a reference body exported by a twin) run under the context
    manager `watch()`; when the body fails, the watch's record is printed
    beside the failure. The name, signature and marks stay the test's."""
    @functools.wraps(test)
    def run(*args, **kw):
        with watch() as got:
            try:
                return test(*args, **kw)
            except BaseException:
                print(f"{test.__name__}: {got}")
                raise
    return run


@pytest.fixture(autouse=True)
def one_thread():
    """The plain step is thousands of tiny ops: torch's intra-op thread
    pool only adds overhead at these widths (and engines share it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
