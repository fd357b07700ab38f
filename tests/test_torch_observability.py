"""Twin of tests/test_observability.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): histograms and the Prometheus exposition's
conformance, the reservoir sample, the event aggregator, the flight
recorder, and end to end on a WAL-backed vector host with every request
sampled (the `single_host` fixture): the commit, apply, read and fsync
histograms, `step_stats`, the `engine_step_*`, census, counter and history
gauges, and the scalar engine's parity. The copy's `import bench` is the
port's `dragonboat_tpu_torch.e2e`, whose `_lane_report` and
`_census_report` fold the lanes and the census.

`test_single_host_metrics_match_reference` runs the `single_host` scenario
through both packages and holds equal what does not depend on the wall
clock: the metric families of `write_health_metrics`'s exposition and
their label keys, the keys of `engine.step_stats()`, and the counts of the
commit, apply and read histograms. Three differences are by design, and
the test names them: the port's `step_stats` also counts the steps decoded
pipelined (`steps_pipelined`, hence its `engine_step_steps_pipelined`
gauge) and says whether the engine stopped on a save whose payload a lane
lacked (`faults`, hence `engine_step_faults`), and `engine_compile_cache_entries` is written only by a process
that compiled or built something (`profile.write_exposition`): the JAX
package jits its step on the CPU, the port builds no kernel there. The
tests after it hold the packages equal on seeded inputs: the exposition
text of a registry, byte for byte, the reservoir sample's count, mean and
percentiles, and the latency sampler's decisions."""
import contextlib
import importlib
import io
import re

import numpy as np
import pytest

from torch_twin import one_thread, port_copy, reference_tests  # noqa: F401

R = port_copy("test_observability")
globals().update(reference_tests(R))


def _ref():
    return importlib.import_module("test_observability")


# what the port adds to step_stats, and the gauge each such key becomes
PORT_ONLY_STATS = {"steps_pipelined", "faults"}
PORT_ONLY_FAMILIES = {"dragonboat_tpu_engine_step_steps_pipelined",
                      "dragonboat_tpu_engine_step_faults"}
BUILDS = "dragonboat_tpu_engine_compile_cache_entries"


def _family(name, types):
    base = re.sub(r"_(bucket|sum|count)$", "", name)
    return name if name in types else base


def single_host_metrics(M, root):
    """`M`'s single_host scenario: the e2e body, then what it exposes."""
    host = contextlib.contextmanager(M.single_host.__wrapped__)
    with host(root) as nh:
        M.test_e2e_latency_histograms_and_step_stats(nh)
        m = nh.metrics
        counts = {h: m.histogram(h, (1, 1)).count for h in (
            "proposal_commit_latency_seconds", "proposal_apply_latency_seconds",
            "readindex_latency_seconds")}
        stats = sorted(nh.engine.step_stats())
        out = io.StringIO()
        nh.write_health_metrics(out)
    types, samples = M._parse_exposition("\n".join(
        ln for ln in out.getvalue().splitlines()
        if not ln.startswith("# TYPE dragonboat_tpu_transport_")
        and not ln.startswith("dragonboat_tpu_transport_")))
    labels = {}
    for name, _lb, _v, keys in samples:
        labels.setdefault(_family(name, types), set()).add(tuple(keys))
    pkg = M.Histogram.__module__.split(".")[0]
    built = bool(importlib.import_module(pkg + ".profile").compile_watch().per_function())
    return {"families": types, "label_keys": labels, "step_stats": stats,
            "histogram_counts": counts, "built": built}


def _shared(got):
    """What both packages expose: the port's additions taken out and the
    build gauge, which says whether the process built anything."""
    fams = set(got["families"]) - PORT_ONLY_FAMILIES - {BUILDS}
    return {"families": {f: got["families"][f] for f in fams},
            "label_keys": {f: got["label_keys"][f] for f in fams},
            "step_stats": sorted(set(got["step_stats"]) - PORT_ONLY_STATS),
            "histogram_counts": got["histogram_counts"]}


def test_single_host_metrics_match_reference(tmp_path):
    ref = single_host_metrics(_ref(), tmp_path / "ref")
    port = single_host_metrics(R, tmp_path / "port")
    shared = _shared(port)
    for key, want in _shared(ref).items():
        assert shared[key] == want, key
    assert PORT_ONLY_FAMILIES <= set(port["families"])
    assert PORT_ONLY_STATS <= set(port["step_stats"])
    for got in (ref, port):
        assert (BUILDS in got["families"]) == got["built"]
    assert port["histogram_counts"]["proposal_commit_latency_seconds"] >= 8
    assert "dragonboat_tpu_proposal_commit_latency_seconds" in port["families"]


def _both(name):
    return (importlib.import_module("dragonboat_tpu." + name),
            importlib.import_module("dragonboat_tpu_torch." + name))


def _seeded_registry(M, seed):
    """A registry of `M` (an events module) fed one seeded stream of
    counter, gauge and histogram updates over a few label keys."""
    rng = np.random.default_rng(seed)
    m = M.MetricsRegistry()
    keys = [(0, 0), (1, 1), (1, 2), (7, 3)]
    for _ in range(200):
        k = keys[int(rng.integers(len(keys)))]
        op = int(rng.integers(3))
        if op == 0:
            m.inc("raftnode_campaign_launched_total", k, float(rng.integers(1, 4)))
        elif op == 1:
            m.set_gauge("raftnode_term", k, float(rng.integers(0, 50)))
        else:
            m.observe(str(rng.choice(["proposal_commit_latency_seconds",
                                      "fsync_latency_seconds"])), k,
                      float(10.0 ** rng.uniform(-5, 3)))
    return m


@pytest.mark.parametrize("seed", range(6))
def test_exposition_text_matches_reference(seed):
    """The Prometheus text both packages write for the same updates is the
    same, byte for byte, and conformant."""
    texts = []
    for M in _both("events"):
        out = io.StringIO()
        _seeded_registry(M, seed).write(out)
        texts.append(out.getvalue())
    assert texts[1] == texts[0]
    R._parse_exposition(texts[1])


@pytest.mark.parametrize("cap", [10, 100, 1000, 5000])
def test_sample_reservoir_matches_reference(cap):
    rng = np.random.default_rng(cap)
    values = rng.exponential(1.0, 20_000).tolist()
    got = []
    for T in _both("trace"):
        s = T.Sample("cross", cap=cap)
        for v in values:
            s.record(v)
        got.append((len(s), s.mean(), [s.percentile(q) for q in (0.5, 0.9, 0.99, 0.999)]))
    assert got[1] == got[0]


@pytest.mark.parametrize("ratio", [1, 2, 4, 32])
def test_latency_sampler_matches_reference(ratio):
    ref, port = (T.LatencySampler(ratio) for T in _both("trace"))
    assert [port.sample() for _ in range(256)] == [ref.sample() for _ in range(256)]
