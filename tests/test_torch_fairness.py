"""Twin of tests/test_fairness.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the fairness watchdog's starvation gauge, yield
and clock-anomaly rules on a fake clock, the vector engine's per-lane tick
clamp below the election RTT, and the starvation gauges a NodeHost exports.

The test below runs the gauge body through both packages' NodeHosts and
holds equal, when each writes its exposition, the lane's tick clamp
(`_m_tick_cap`), the gauges the body reads and the watchdog's stat names."""
import importlib

from torch_twin import calls, one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_fairness")
globals().update(reference_tests(R))


def clamp_and_gauges(nh, _result):
    core = nh.engine.core
    with core._lanes_mu:
        gs = sorted(lane.g for lane in core._lanes.values())
    key = (0, 0)
    return ([int(core._m_tick_cap[g]) for g in gs], core._catchup_tick_cap,
            nh.metrics.gauge_value("engine_tick_starvation_ratio", key) is not None,
            nh.metrics.gauge_value("transport_breakers_open", key),
            sorted(nh.engine.fairness_stats()))


def gauges(M, pkg):
    NH = importlib.import_module(pkg + ".nodehost").NodeHost
    with calls(NH, ("write_health_metrics",), clamp_and_gauges) as got:
        M.test_nodehost_exports_starvation_gauges()
    return got


def test_tick_clamp_and_gauges_match_reference():
    ref = gauges(importlib.import_module("test_fairness"), "dragonboat_tpu")
    port = gauges(R, "dragonboat_tpu_torch")
    assert port[0][1][0] == [2] and port[0][1][2]
    assert port == ref
