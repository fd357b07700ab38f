"""The twin runner itself (tests/torch_twin.py): a copy's engines are bound
to the CPU wherever the copy imports their constructors, at module level,
inside a function or fixture, or in a helper module it loads through
`from tests.<m> import`; the copy's `import bench` is the port's
`dragonboat_tpu_torch.e2e`; nothing of that leaks out of the copy; and no
copy of a twinned file binds anything of the JAX package or of jax."""
import builtins
import contextlib
import importlib
import inspect
import sys
import types

import pytest

from dragonboat_tpu_torch import config, e2e
from dragonboat_tpu_torch.ops.loopback import LoopbackCluster
from dragonboat_tpu_torch.transport.loopback import _Registry
from torch_twin import SUFFIX, one_thread, port_copy  # noqa: F401

IMPORT = builtins.__import__
FIVE = ("test_bring_up", "test_observability", "test_forensics", "test_vector_scale",
        "test_chaos_scale")
# every reference test file that a twin runs on the port
TWINNED = FIVE + ("test_witness_lanes", "test_shared_engine", "test_fanout_columnar",
                  "test_lease", "test_prevote", "test_differential", "test_streamed_install",
                  "test_snapshot_lanes", "test_crash_safety",
                  "test_restart", "test_propose_batch", "test_snapshotstate",
                  "test_snapshot_files", "test_compression", "test_fairness", "test_events",
                  "test_rate_limit", "test_storage", "test_chaos", "test_readindex_tracker")


def _imports(mod, src):
    """Run `src` in a fresh namespace that imports as `mod` does."""
    ns = {"__builtins__": vars(mod)["__builtins__"]}
    exec(src, ns)
    return ns


def test_function_local_engine_config_builds_a_cpu_engine(tmp_path):
    # test_forensics._mk_host imports EngineConfig and NodeHostConfig
    # inside the function
    F = port_copy("test_forensics")
    nh = F._mk_host(1, _Registry(), str(tmp_path), "binding-local")
    try:
        assert nh.engine.core.device.type == "cpu"
    finally:
        nh.stop()
    ns = _imports(F, "def f():\n    from dragonboat_tpu_torch.config import EngineConfig, "
                     "NodeHostConfig\n    return EngineConfig(), NodeHostConfig()\nout = f()")
    eng, nhc = ns["out"]
    assert eng.device == "cpu" and nhc.engine.device == "cpu"
    assert isinstance(eng, config.EngineConfig) and isinstance(nhc, config.NodeHostConfig)
    assert port_defaults() == ("cuda", "cuda", "cuda")


def test_fixture_local_engine_config_builds_a_cpu_engine(tmp_path):
    # test_observability's single_host fixture imports inside its body
    O = port_copy("test_observability")
    with contextlib.contextmanager(O.single_host.__wrapped__)(tmp_path) as nh:
        assert nh.engine.core.device.type == "cpu"
    assert port_defaults() == ("cuda", "cuda", "cuda")


def test_helper_module_and_loopback_bound_to_the_cpu():
    port_copy("test_observability")  # loads tests/test_nodehost.py as a helper
    H = sys.modules["test_nodehost" + SUFFIX]
    assert H.EngineConfig().device == "cpu"
    assert H.NodeHostConfig(raft_address="h:1").engine.device == "cpu"
    ns = _imports(H, "from dragonboat_tpu_torch.ops.loopback import LoopbackCluster")
    assert issubclass(ns["LoopbackCluster"], LoopbackCluster)
    assert inspect.signature(ns["LoopbackCluster"]).parameters["device"].default == "cpu"


def test_a_copy_bound_to_the_card_is_a_module_of_its_own():
    # chip_smoke.py phase 12 runs the reference bodies through such copies
    cpu, card = port_copy("test_observability"), port_copy("test_observability", "cuda")
    assert card is not cpu and card.__name__ == "test_observability" + SUFFIX + "_cuda"
    ns = _imports(card, "from dragonboat_tpu_torch.config import EngineConfig, NodeHostConfig\n"
                        "out = EngineConfig(), NodeHostConfig()")
    assert [c.device for c in (ns["out"][0], ns["out"][1].engine)] == ["cuda", "cuda"]
    assert sys.modules["test_nodehost" + SUFFIX + "_cuda"].EngineConfig().device == "cuda"
    assert cpu.single_host is not card.single_host
    ns = _imports(cpu, "from dragonboat_tpu_torch.config import EngineConfig\nout = EngineConfig()")
    assert ns["out"].device == "cpu"
    assert port_defaults() == ("cuda", "cuda", "cuda")


def port_defaults():
    """The port's own defaults, which no copy may change."""
    return (config.EngineConfig().device, config.NodeHostConfig().engine.device,
            inspect.signature(LoopbackCluster).parameters["device"].default)


def test_the_port_keeps_its_defaults():
    for name in FIVE:
        port_copy(name)
    assert port_defaults() == ("cuda", "cuda", "cuda")
    assert builtins.__import__ is IMPORT


def test_copy_bench_is_the_port_e2e():
    O = port_copy("test_observability")
    ns = _imports(O, "import bench\nfrom bench import _lane_report, _census_report")
    assert ns["bench"] is e2e
    assert ns["_lane_report"] is e2e._lane_report and ns["_census_report"] is e2e._census_report
    # a name of the reference's bench.py that the port's e2e lacks raises
    with pytest.raises(AttributeError):
        ns["bench"].bench_kernel
    with pytest.raises(ImportError):
        _imports(O, "from bench import bench_kernel")


def _bound_origins(mod):
    """The module names that `mod`'s globals come from."""
    out = set()
    for name, v in vars(mod).items():
        if name == "__builtins__":
            continue
        if isinstance(v, types.ModuleType):
            out.add(v.__name__)
        else:
            m = getattr(v, "__module__", None)
            if isinstance(m, str):
                out.add(m)
    return out


@pytest.mark.parametrize("name", TWINNED)
def test_copy_binds_nothing_of_the_reference(name):
    port_copy(name)
    copies = [m for n, m in list(sys.modules.items()) if SUFFIX in n]
    assert sys.modules[name + SUFFIX] in copies
    for mod in copies:
        bad = {o for o in _bound_origins(mod)
               if o.split(".")[0] in ("dragonboat_tpu", "jax", "jaxlib", "bench")}
        assert not bad, f"{mod.__name__} binds {sorted(bad)}"
    assert any(o.startswith("dragonboat_tpu_torch") for o in
               _bound_origins(sys.modules[name + SUFFIX]))


def test_walk_catches_a_reference_binding():
    ref = importlib.import_module("test_bring_up")
    assert "dragonboat_tpu.nodehost" in _bound_origins(ref)
