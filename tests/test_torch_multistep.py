"""The port's K-step super-step and its router (plain versions, CPU) against
the JAX package's, exact on every field.

- route_step_output against the JAX route_step_output and against the
  per-element host-dispatch reference router of tests/test_multistep.py,
  on 8 seeded random (state, output, route, rdelta) draws;
- make_multi_step_fn against the JAX one on the 4-window scenario of
  tests/test_multistep.py at K=4: state, stacked outputs, stacked plans,
  residual and resid_count after every window;
- the counter plane summed over a K=8 super-step equals the JAX sum;
- a residual-only super-step finishes the election the residual carries;
- kernel_bench's config-6 scenario at 8 groups x 3 replicas and K=8, the
  port unsharded and as 4 lane blocks against the JAX super-step.

Inputs are made with numpy (or the JAX helpers, whose arrays convert
through numpy) and handed to both packages. All protocol state is i32,
bool or u32, so the tolerance is exact equality.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_multistep as tm
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy, state_to_numpy

KCFG = T.KernelConfig(**tm.KCFG._asdict())


def _np(tree):
    """A JAX tree or a port tree -> field name -> numpy array."""
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    if isinstance(tree[0], torch.Tensor):
        return state_to_numpy(tree)
    return {f: np.asarray(jax.device_get(getattr(tree, f))) for f in tree._fields}


def _assert_tree_equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.keys() == b.keys(), what
    for f in a:
        assert a[f].dtype == b[f].dtype, (what, f, a[f].dtype, b[f].dtype)
        assert a[f].shape == b[f].shape, (what, f, a[f].shape, b[f].shape)
        assert np.array_equal(a[f], b[f]), (what, f)


def _to_port(tree):
    return state_from_numpy(_np(tree), device="cpu")


def random_route(rng, s, G, P):
    """test_multistep's seeded route/rdelta draw (global lane indexes)."""
    route = np.full((G, P), -1, np.int32)
    rdelta = np.zeros((G, P), np.int32)
    self_slot = np.asarray(s.self_slot)
    for g in range(G):
        for p in range(P):
            if p == self_slot[g]:
                continue
            if rng.random() < 0.6:
                route[g, p] = rng.randrange(G)
                rdelta[g, p] = rng.choice([0, 0, 0, 2, -2, -40])
    return route, rdelta


@pytest.mark.parametrize("seed", range(8))
def test_route_matches_jax_and_reference(seed):
    rng = random.Random(4000 + seed)
    G, P = KCFG.groups, KCFG.peers
    s, o_np, out = tm._random_state_and_output(rng)
    route, rdelta = random_route(rng, s, G, P)
    j_nxt, j_plan = JK.route_step_output(s, out, jnp.asarray(route), jnp.asarray(rdelta),
                                         tm.KCFG)
    nxt, plan = K.route_step_output(_to_port(s), _to_port(out), torch.from_numpy(route),
                                    torch.from_numpy(rdelta), KCFG)
    assert isinstance(plan, T.RoutePlan)
    _assert_tree_equal(nxt, j_nxt, "inbox vs jax")
    _assert_tree_equal(plan, j_plan, "plan vs jax")
    ref_nxt, ref_masks = tm._ref_route(s, o_np, route, rdelta, tm.KCFG)
    _assert_tree_equal(nxt, ref_nxt, "inbox vs reference router")
    _assert_tree_equal(plan, ref_masks, "plan vs reference router")
    assert sum(int(m.sum()) for m in ref_masks.values()) > 0


def _port_cluster():
    s, route, rdelta = tm._cluster_state()
    return _to_port(s), torch.from_numpy(route), torch.from_numpy(rdelta), s, route, rdelta


def test_superstep_matches_jax_over_four_windows():
    steps, windows, G = 4, 4, KCFG.groups
    s, route, rdelta, js, jroute, jrdelta = _port_cluster()
    multi = K.make_multi_step_fn(KCFG, steps, donate=False)
    jmulti = JK.make_multi_step_fn(tm.KCFG, steps, donate=False)
    ticks = torch.zeros((G,), dtype=torch.int32)
    resid = T.make_empty_inbox(KCFG, device="cpu")
    jresid = J.make_empty_inbox(tm.KCFG)
    for window in range(windows):
        counts = [int(x) for x in (_np(resid)["mtype"] != T.MSG.NONE).sum(1)]
        host = tm._host_events(window, counts)
        s, outs, plans, resid, rc = multi(s, state_from_numpy(host, "cpu"), ticks, resid,
                                          route, rdelta)
        js, jouts, jplans, jresid, jrc = jmulti(js, tm._jnp_inbox(host), jnp.asarray(ticks),
                                               jresid, jnp.asarray(jroute),
                                               jnp.asarray(jrdelta))
        _assert_tree_equal(s, js, ("state", window))
        _assert_tree_equal(outs, jouts, ("outs", window))
        _assert_tree_equal(plans, jplans, ("plans", window))
        _assert_tree_equal(resid, jresid, ("resid", window))
        assert rc.dtype == torch.int32
        assert np.array_equal(rc.numpy(), np.asarray(jrc)), window
        assert tuple(outs.term.shape) == (steps, G)
        assert tuple(plans.resp.shape) == (steps, G, KCFG.inbox_depth)
    final = _np(s)
    assert final["leader"][0] == 2 and final["term"][0] == 2
    assert final["committed"][1] >= 6 and final["committed"][3] >= 4


def test_superstep_counters_exact_sum_at_k8():
    steps, G = 8, KCFG.groups
    s, route, rdelta, js, jroute, jrdelta = _port_cluster()
    multi = K.make_multi_step_fn(KCFG, steps, donate=False)
    jmulti = JK.make_multi_step_fn(tm.KCFG, steps, donate=False)
    ticks = torch.zeros((G,), dtype=torch.int32)
    resid = T.make_empty_inbox(KCFG, device="cpu")
    jresid = J.make_empty_inbox(tm.KCFG)
    tot, jtot = np.zeros((G, T.CTR.COUNT), np.uint64), np.zeros((G, T.CTR.COUNT), np.uint64)
    for window in range(3):
        counts = [int(x) for x in (_np(resid)["mtype"] != T.MSG.NONE).sum(1)]
        host = tm._host_events(window, counts)
        s, outs, _, resid, _ = multi(s, state_from_numpy(host, "cpu"), ticks, resid,
                                     route, rdelta)
        js, jouts, _, jresid, _ = jmulti(js, tm._jnp_inbox(host), jnp.asarray(ticks), jresid,
                                         jnp.asarray(jroute), jnp.asarray(jrdelta))
        ctr = outs.counters.numpy()
        assert ctr.shape == (steps, G, T.CTR.COUNT) and ctr.dtype == np.uint32
        tot += ctr.astype(np.uint64).sum(axis=0)
        jtot += np.asarray(jouts.counters).astype(np.uint64).sum(axis=0)
        assert np.array_equal(tot, jtot), window
    assert int(tot[0, T.CTR.ELECTIONS_WON]) >= 1
    assert int(tot[1, T.CTR.ELECTIONS_WON]) >= 1
    assert int(tot[:, T.CTR.COMMIT_ADVANCES].sum()) > 0


def test_residual_only_superstep_finishes_the_election():
    steps, G = 2, KCFG.groups
    s, route, rdelta, js, jroute, jrdelta = _port_cluster()
    multi = K.make_multi_step_fn(KCFG, steps)
    jmulti = JK.make_multi_step_fn(tm.KCFG, steps, donate=False)
    ticks = torch.zeros((G,), dtype=torch.int32)
    host = tm._empty_inbox_np(tm.KCFG)
    host["mtype"][0, 0] = T.MSG.ELECTION
    resid = T.make_empty_inbox(KCFG, device="cpu")
    jresid = J.make_empty_inbox(tm.KCFG)
    s, _, _, resid, rc = multi(s, state_from_numpy(host, "cpu"), ticks, resid, route, rdelta)
    js, _, _, jresid, _ = jmulti(js, tm._jnp_inbox(host), jnp.asarray(ticks), jresid,
                                 jnp.asarray(jroute), jnp.asarray(jrdelta))
    assert int(rc.sum()) > 0  # the vote responses are still in flight
    empty = tm._empty_inbox_np(tm.KCFG)
    for _ in range(3):
        s, _, _, resid, rc = multi(s, state_from_numpy(empty, "cpu"), ticks, resid,
                                   route, rdelta)
        js, _, _, jresid, _ = jmulti(js, tm._jnp_inbox(empty), jnp.asarray(ticks), jresid,
                                     jnp.asarray(jroute), jnp.asarray(jrdelta))
        _assert_tree_equal(s, js, "state")
        _assert_tree_equal(resid, jresid, "resid")
    assert int(s.leader[0]) == 1
    assert int(s.committed[0]) >= 1


def test_route_plan_and_stacked_trees_convert():
    rng = np.random.default_rng(5)
    plan = {f: rng.random((3, 6, 4)) < 0.5 for f in T.RoutePlan._fields}
    tp = state_from_numpy(plan, device="cpu")
    assert isinstance(tp, T.RoutePlan) and tp.rep.shape == (3, 6, 4)
    _assert_tree_equal(tp, plan, "plan round trip")


def test_config6_scenario_matches_jax_at_small_size():
    """kernel_bench's config-6 scenario (co-hosted replicas, an election,
    proposals, forwarded reads, a leader change and a transfer mid-window,
    compaction between super-steps) at 8 groups x 3 replicas and K=8: the
    port's super-step, unsharded and as 4 lane blocks, equals the JAX
    package's on every field after every window."""
    from dragonboat_tpu_torch import kernel_bench as kb

    groups, reps, steps, n = 8, 3, 8, 4
    cfg = kb.superstep_config(groups, reps)._replace(max_entries_per_msg=8, log_window=64)
    jcfg = J.KernelConfig(**cfg._asdict())
    s, route, rdelta = kb.superstep_cluster(groups, reps, cfg, device="cpu")
    js = J.RaftTensors(**{f: jnp.asarray(v) for f, v in _np(s).items()})
    ss = K.shard_tree(K.clone_state(s), n)
    multi = K.make_multi_step_fn(cfg, steps)
    smulti = K.make_sharded_multi_step_fn(cfg, steps, (torch.device("cpu"),) * n)
    jmulti = JK.make_multi_step_fn(jcfg, steps, donate=False)
    ticks = torch.ones((cfg.groups,), dtype=torch.int32)
    resid = T.make_empty_inbox(cfg, device="cpu")
    sresid = K.shard_tree(resid, n)
    jresid = J.make_empty_inbox(jcfg)
    leaders, rng = np.zeros(groups, np.int64), np.random.default_rng(6)
    rc = torch.zeros((cfg.groups,), dtype=torch.int32)
    reads = transfers = 0
    for w in range(8):
        ib, leaders = kb.host_window(w, rc, leaders, groups, reps, cfg, rng, device="cpu")
        s, outs, plans, resid, rc = multi(s, ib, ticks, resid, route, rdelta)
        ss, souts, splans, sresid, _ = smulti(ss, K.shard_tree(ib, n), K.shard_tree(ticks, n),
                                              sresid, K.shard_tree(route, n),
                                              K.shard_tree(rdelta, n))
        js, jouts, jplans, jresid, jrc = jmulti(
            js, J.Inbox(**{f: jnp.asarray(v) for f, v in _np(ib).items()}),
            jnp.asarray(ticks.numpy()), jresid, jnp.asarray(route.numpy()),
            jnp.asarray(rdelta.numpy()))
        for what, a, b in (("state", s, js), ("outs", outs, jouts), ("plans", plans, jplans),
                           ("resid", resid, jresid), ("sharded state", K.unshard_tree(ss), js),
                           ("sharded outs", K.unshard_tree(souts, axis=1), jouts),
                           ("sharded plans", K.unshard_tree(splans, axis=1), jplans)):
            _assert_tree_equal(a, b, (what, w))
        assert np.array_equal(rc.numpy(), np.asarray(jrc)), w
        reads += int(plans.rir.sum())
        transfers += int(plans.tn.sum())
        kb.compact(s)
        for x in ss:
            kb.compact(x)
        js = js._replace(marker_term=JK._term_at(js, js.applied), first_index=js.applied + 1)
    assert bool((s.role[torch.from_numpy(leaders)] == T.ROLE.LEADER).all())
    assert reads > 0 and transfers > 0
    assert int(s.committed[:groups].min()) > 8
