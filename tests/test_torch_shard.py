"""The port's sharded super-step (n logical shards of one device, plain
versions on the CPU) against the JAX package's shard_map path on the
8-device CPU mesh of tests/conftest.py, exact on every field.

- sharded_multi_step_batch with n in {2, 4, 8} lane blocks against the
  JAX make_sharded_multi_step_fn on tests/test_shard_multistep.py's 8-lane
  scenario (election, a config change committing mid-window, a leader
  change mid-window, two padded lanes that must stay inert);
- _shard_route against the JAX _shard_route under shard_map on 6 seeded
  draws whose destinations cross shards;
- ring_gather_reference against lax.all_gather under shard_map, byte for
  byte;
- shard_tree / unshard_tree round trips with per-shard devices, and the
  device rule of make_sharded_multi_step_fn (one device type; distinct
  cards only where visible and mapped for each other).
"""
import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

import test_multistep as tm
import test_shard_multistep as tsm
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from test_torch_multistep import _assert_tree_equal, _np, _to_port, random_route

SKCFG = T.KernelConfig(**tsm.SKCFG._asdict())
N_DEV = 8
CPU = torch.device("cpu")


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N_DEV]), ("groups",))


@pytest.fixture(scope="module")
def jax_windows():
    """The JAX sharded super-step over the 4-window scenario: per window
    the host inbox and (state, outs, plans, resid, resid_count) as numpy."""
    assert jax.device_count() >= N_DEV
    steps, G = 4, SKCFG.groups
    s, route, rdelta = tsm._cluster_state8()
    fn = JK.make_sharded_multi_step_fn(tsm.SKCFG, steps, _mesh(), donate=False)
    ticks = jnp.zeros((G,), jnp.int32)
    resid = J.make_empty_inbox(tsm.SKCFG)
    got = []
    for window in range(4):
        counts = [int(x) for x in (np.asarray(resid.mtype) != J.MSG.NONE).sum(1)]
        host = tsm._host_events8(window, counts)
        s, outs, plans, resid, rc = fn(s, tm._jnp_inbox(host), ticks, resid,
                                       jnp.asarray(route), jnp.asarray(rdelta))
        got.append((host, _np(s), _np(outs), _np(plans), _np(resid), np.asarray(rc)))
    return route, rdelta, got


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_superstep_matches_jax_mesh(jax_windows, n):
    route, rdelta, windows = jax_windows
    steps, G = 4, SKCFG.groups
    s0, _, _ = tsm._cluster_state8()
    states = K.shard_tree(_to_port(s0), n)
    routes = K.shard_tree(torch.from_numpy(route), n)
    rdeltas = K.shard_tree(torch.from_numpy(rdelta), n)
    resids = K.shard_tree(T.make_empty_inbox(SKCFG, device="cpu"), n)
    ticks = K.shard_tree(torch.zeros((G,), dtype=torch.int32), n)
    fn = K.make_sharded_multi_step_fn(SKCFG, steps, (CPU,) * n)
    for w, (host, js, jouts, jplans, jresid, jrc) in enumerate(windows):
        inboxes = K.shard_tree(state_from_numpy(host, "cpu"), n)
        states, outs, plans, resids, rcs = fn(states, inboxes, ticks, resids, routes, rdeltas)
        assert len(states) == n and states[0].term.shape == (G // n,)
        _assert_tree_equal(K.unshard_tree(states), js, ("state", n, w))
        _assert_tree_equal(K.unshard_tree(outs, axis=1), jouts, ("outs", n, w))
        _assert_tree_equal(K.unshard_tree(plans, axis=1), jplans, ("plans", n, w))
        _assert_tree_equal(K.unshard_tree(resids), jresid, ("resid", n, w))
        assert np.array_equal(K.unshard_tree(rcs).numpy(), jrc), (n, w)
    final = _np(K.unshard_tree(states))
    assert final["leader"][0] == 2 and final["term"][0] == 2
    assert final["committed"][1] >= 6 and final["committed"][3] >= 4
    # the padded tail lanes stayed inert
    assert final["term"][6] == 0 and final["term"][7] == 0
    assert final["committed"][6] == 0 and final["committed"][7] == 0


@pytest.mark.parametrize("seed", range(6))
def test_shard_route_matches_jax(seed, monkeypatch):
    from jax.experimental.shard_map import shard_map

    monkeypatch.setattr(tm, "KCFG", tsm.SKCFG)
    rng = random.Random(7000 + seed)
    G, P = SKCFG.groups, SKCFG.peers
    s, o_np, out = tm._random_state_and_output(rng)
    route, rdelta = random_route(rng, s, G, P)
    lane = PartitionSpec("groups")
    fn = shard_map(
        functools.partial(JK._shard_route, cfg=tsm.SKCFG, axis_name="groups",
                          n_shards=N_DEV),
        mesh=_mesh(), in_specs=(lane,) * 4, out_specs=(lane, lane), check_rep=False,
    )
    j_nxt, j_plan = jax.jit(fn)(s, out, jnp.asarray(route), jnp.asarray(rdelta))
    for n in (2, 4, 8):
        nxts, plans = K._shard_route(
            K.shard_tree(_to_port(s), n), K.shard_tree(_to_port(out), n),
            K.shard_tree(torch.from_numpy(route), n), K.shard_tree(torch.from_numpy(rdelta), n),
            SKCFG)
        _assert_tree_equal(K.unshard_tree(nxts), j_nxt, ("inbox", n, seed))
        _assert_tree_equal(K.unshard_tree(plans), j_plan, ("plan", n, seed))
    _, ref_masks = tm._ref_route(s, o_np, route, rdelta, tsm.SKCFG)
    Gl = G // N_DEV
    cross = sum(int(ref_masks[k][g, p]) for k in ("rep", "vote", "hb", "tn")
                for g in range(G) for p in range(P)
                if route[g, p] >= 0 and route[g, p] // Gl != g // Gl)
    assert cross > 0, "seed routed nothing across shards"


@pytest.mark.parametrize("ml", [1, 7, 24])
def test_ring_gather_reference_matches_all_gather(ml):
    from jax.experimental.shard_map import shard_map

    C = 11 + 2 * 3
    rng = np.random.default_rng(ml)
    x = rng.integers(-2**31, 2**31, size=(N_DEV * C, ml), dtype=np.int64).astype(np.int32)
    fn = shard_map(lambda a: jax.lax.all_gather(a, "groups", axis=0, tiled=False),
                   mesh=_mesh(), in_specs=PartitionSpec("groups"),
                   out_specs=PartitionSpec("groups"), check_rep=False)
    j = np.asarray(jax.jit(fn)(jnp.asarray(x))).reshape(N_DEV, N_DEV, C, ml)
    slabs = [torch.from_numpy(x[i * C:(i + 1) * C].copy()) for i in range(N_DEV)]
    got = K._gather_candidates(slabs)
    assert len(got) == N_DEV
    for i in range(N_DEV):
        assert got[i].dtype == torch.int32 and tuple(got[i].shape) == (N_DEV, C, ml)
        assert got[i].numpy().tobytes() == j[i].tobytes(), i


def test_shard_tree_round_trip_and_device_rule():
    rng = np.random.default_rng(3)
    st = {f: rng.integers(0, 9, size=(4, 8, 3)).astype(np.int32) for f in T.RoutePlan._fields}
    tree = T.RoutePlan(**{f: torch.from_numpy(v) for f, v in st.items()})
    for axis in (0, 1):
        parts = K.shard_tree(tree, 4, axis=axis)
        assert all(t.is_contiguous() for p in parts for t in p)
        assert parts[1].rep.shape[axis] == tree.rep.shape[axis] // 4
        _assert_tree_equal(K.unshard_tree(parts, axis=axis), tree, axis)
    # a block is a tensor of its own: writing it leaves the tree alone
    parts[0].rep.fill_(-1)
    _assert_tree_equal(tree, st, "source untouched")
    with pytest.raises(ValueError, match="equal shards"):
        K.shard_tree(tree, 3)
    # per-shard devices: block i on devices[i], one device per shard
    placed = K.shard_tree(tree, 2, devices=(CPU, CPU))
    assert all(t.device == CPU for p in placed for t in p)
    _assert_tree_equal(K.unshard_tree(placed), tree, "placed")
    with pytest.raises(ValueError, match="devices for"):
        K.shard_tree(tree, 4, devices=(CPU,))
    # shards of one device type; distinct cards are accepted, and built
    # only where each is visible and every pair reaches the other (no
    # card here: refused before any kernel is built)
    with pytest.raises(ValueError, match="one device type"):
        K.make_sharded_multi_step_fn(SKCFG, 4, (CPU, torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="visible"):
        K.make_sharded_multi_step_fn(SKCFG, 4, (torch.device("cuda", 0),
                                                 torch.device("cuda", 1)))
    # a call with another count of shards than the fn's is refused, and so
    # is a shard whose state lies elsewhere than its device
    fn = K.make_sharded_multi_step_fn(SKCFG, 4, (CPU, CPU))
    s2 = K.shard_tree(T.init_state(SKCFG, device="cpu"), 2)
    with pytest.raises(ValueError, match="every argument must hold 2"):
        fn(s2[:1], (), (), (), (), ())
    elsewhere = [type(s)(*(t.to("meta") for t in s)) for s in s2]
    with pytest.raises(ValueError, match="shard 0's state must live on cpu, not meta"):
        fn(elsewhere, *([(None, None)] * 5))
