"""Twin of tests/test_events.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the metrics registry, the event aggregator and
its listeners, percentiles, the profiler's sampling, the logger factory,
the health metrics of a NodeHost on the vector engine, and the scalar
engine's profiler switch.

The test below runs the health-metrics body through both packages'
NodeHosts and holds equal the gauge families of their expositions, with
the once-a-second gauges exported just before each write (a histogram or
counter family appears once its first event is observed, which depends on
timing here). The differences by design are the ones
tests/test_torch_observability.py names: the port's pipelined-step and
engine-fault gauges, and the compile-cache gauge that only a process which compiled something
writes (the JAX package jits its step on the CPU; the port builds
nothing there)."""
import importlib
import io

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_events")
globals().update(reference_tests(R))

PORT_ONLY = {"# TYPE dragonboat_tpu_engine_step_steps_pipelined gauge",
             "# TYPE dragonboat_tpu_engine_step_faults gauge"}
REFERENCE_ONLY = {"# TYPE dragonboat_tpu_engine_compile_cache_entries gauge"}


def families(M, pkg):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    base = NH.write_health_metrics
    got = []

    def write(self, out):
        # the gauges a host exports once a second, exported now, so both
        # expositions hold them whenever the body writes
        self._export_health_gauges()
        base(self, out)
        got.append(out.getvalue() if isinstance(out, io.StringIO) else "")

    NH.write_health_metrics = write
    try:
        M.test_nodehost_health_metrics_end_to_end()
    finally:
        NH.write_health_metrics = base
    # the gauges: a histogram or counter family appears once its first
    # event is observed, which is a matter of timing in this body
    return sorted({line for text in got for line in text.splitlines()
                   if line.startswith("# TYPE") and line.endswith(" gauge")})


def test_exposition_families_match_reference():
    ref = families(importlib.import_module("test_events"), "dragonboat_tpu")
    port = families(R, "dragonboat_tpu_torch")
    assert any("raftnode_has_leader" in line for line in port)
    assert set(port) - set(ref) == PORT_ONLY
    assert set(ref) - set(port) == REFERENCE_ONLY
