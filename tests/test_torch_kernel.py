"""The port's plain step_batch (CPU) against the JAX package's step_batch
(CPU), exact on every state field and StepOutput plane, dtypes equal.

States are captured from seeded JAX LoopbackCluster runs (dropped links,
isolation, proposals, reads, transfers; pre-vote, check-quorum and leases
with a margin; witnesses and observers), then perturbed (quiesce on some
lanes, single-voter lanes, full and overfull read queues, live leases) and
stepped with seeded random inboxes that reach the handlers' edge cases."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonboat_tpu.ops import state as J
from dragonboat_tpu.ops.kernel import make_step_fn as j_make_step_fn
from dragonboat_tpu.ops.loopback import LoopbackCluster as JCluster
from dragonboat_tpu_torch.kernel_bench import random_inbox
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy

G, W = 16, 32

# (P, E, cluster options, replicas)
CASES = [
    (4, 1, dict(check_quorum=True, witnesses=(2,)), 3),
    (4, 8, dict(check_quorum=True, prevote=True, lease_read=True, lease_margin=1), 3),
    # the 5-replica configs' peer count (BASELINE configs 3-5): an odd
    # peer count and its 3-of-5 quorum
    (5, 8, dict(check_quorum=True, prevote=True, lease_read=True, lease_margin=1), 5),
    (8, 1, dict(check_quorum=True, prevote=True, observers=(3,)), 4),
    (8, 8, dict(lease_read=True, lease_margin=2, witnesses=(4,)), 5),
]


def _cfg(P, E):
    return dict(groups=G, peers=P, log_window=W, inbox_depth=4,
                max_entries_per_msg=E, readindex_depth=4)


def _captured_states(P, E, opts, n, seed):
    """Seeded JAX cluster run; numpy copies of every replica's state every
    few rounds."""
    rng = np.random.default_rng(seed)
    c = JCluster(n_replicas=n, n_groups=G, cfg=J.KernelConfig(**_cfg(P, E)),
                 seed=seed + 1, **opts)
    got = []
    for r in range(48):
        roles = np.stack([np.asarray(st.role) for st in c.states])
        for g in range(G):
            for h in range(n):
                if roles[h, g] == J.ROLE.LEADER and rng.random() < 0.4:
                    c.propose(h, g, n=int(rng.integers(1, E + 1)),
                              cc_first=bool(E == 1 and rng.random() < 0.2))
                    c.read_index(h, g, ctx=int(rng.integers(1, 1 << 20)),
                                 ctx_high=int(rng.integers(0, 3)))
                    if r == 30 and g % 3 == 0:
                        c.transfer_leader(h, g, (h + 1) % n)
        if r == 20:
            c.isolated = {0}
        if r == 28:
            c.isolated = set()
            c.dropped_links = {(1, 2), (2, 0)}
        if r == 36:
            c.dropped_links = set()
        c.step(tick=bool(r % 3))
        if r % 8 == 7:
            got += [{f: np.asarray(getattr(st, f)).copy() for f in st._fields}
                    for st in c.states]
    return got


def _perturb(rng, st, R):
    """Lane-level edits that reach the kernel's rarer paths."""
    st = dict(st)
    lanes = rng.random(G)
    st["quiesce_on"] = lanes < 0.25
    st["quiesce_threshold"] = np.full(G, 2, np.int32)
    single = lanes > 0.8
    voting = st["voting"].copy()
    voting[single] = False
    voting[single, st["self_slot"][single]] = True
    st["voting"] = voting
    full = rng.random(G) < 0.3  # ri_count == R, e.g. on a single-voter lane
    st["ri_count"] = np.where(full, R, st["ri_count"]).astype(np.int32)
    st["ri_ctx"] = np.where(full[:, None], rng.integers(1, 9, (G, R)),
                            st["ri_ctx"]).astype(np.int32)
    over = rng.random(G) < 0.1  # past the queue end: INT_MIN gather
    st["ri_count"] = np.where(over, R + 1, st["ri_count"]).astype(np.int32)
    st["lease_on"] = rng.random(G) < 0.5
    st["clock_ok"] = rng.random(G) < 0.9
    st["hb_round_tick"] = np.where(rng.random(G) < 0.5, st["tick_count"],
                                   st["hb_round_tick"]).astype(np.int32)
    st["lease_until"] = (st["tick_count"] + rng.integers(-2, 15, G)).astype(np.int32)
    return st


def _jax_tree(kind, tree):
    return kind(**{k: jnp.asarray(v) for k, v in tree.items()})


def _assert_equal(jtree, ttree, what):
    for f in jtree._fields:
        a = np.asarray(getattr(jtree, f))
        b = getattr(ttree, f).numpy()
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f, a, b)


@pytest.mark.parametrize("P,E,opts,n", CASES, ids=[f"P{c[0]}-E{c[1]}" for c in CASES])
def test_step_batch_matches_jax(P, E, opts, n):
    seed = 100 * P + E
    rng = np.random.default_rng(seed)
    jcfg, tcfg = J.KernelConfig(**_cfg(P, E)), T.KernelConfig(**_cfg(P, E))
    jstep = j_make_step_fn(jcfg, donate=False)
    states = _captured_states(P, E, opts, n, seed)
    assert states
    cases = 0
    for i, st in enumerate(states):
        for perturbed in (False, True):
            s = _perturb(rng, st, tcfg.readindex_depth) if perturbed else st
            ib = random_inbox(rng, s, tcfg)
            ticks = rng.integers(0, 3, G).astype(np.int32)
            js, jo = jstep(_jax_tree(J.RaftTensors, s), _jax_tree(J.Inbox, ib),
                           jnp.asarray(ticks))
            ts_in = state_from_numpy(s, device="cpu")
            ts, to = K.step_batch(ts_in, state_from_numpy(ib, device="cpu"),
                                  torch.from_numpy(ticks), tcfg)
            _assert_equal(js, ts, f"state {i} perturbed={perturbed}")
            _assert_equal(jo, to, f"output {i} perturbed={perturbed}")
            # the plain version is pure: its input state is untouched
            for f in T.RaftTensors._fields:
                assert np.array_equal(getattr(ts_in, f).numpy(), s[f]), f
            cases += 1
    assert cases >= 2 * len(states)


def test_random_inbox_reaches_the_edge_cases():
    cfg = T.KernelConfig(**_cfg(8, 8))._replace(groups=256)
    st = {f: getattr(T.init_state(cfg, device="cpu"), f).numpy()
          for f in T.RaftTensors._fields}
    st["last_index"][:] = 40
    ib = random_inbox(np.random.default_rng(0), st, cfg)
    P, E = cfg.peers, cfg.max_entries_per_msg
    assert (ib["from_slot"] >= P).any() and (ib["from_slot"] < 0).any()
    assert (ib["n_entries"] == E).any()
    assert (ib["log_index"] > st["last_index"][:, None] + cfg.log_window).any()
    assert (ib["term"] == 0).any() and (ib["mtype"] == T.MSG.NONE).any()
    types = {v for k, v in vars(T.MSG).items() if k.isupper()}
    assert set(np.unique(ib["mtype"]).tolist()) == types


def test_make_step_fn_donate_semantics_on_cpu():
    cfg = T.KernelConfig(**_cfg(4, 1))
    s = T.init_state(cfg, device="cpu")
    s = T.configure_groups_uniform(s, self_slot=0, voting_slots=(0,))
    inbox = T.make_empty_inbox(cfg, device="cpu")
    inbox.mtype[:, 0] = T.MSG.ELECTION
    ticks = torch.zeros(G, dtype=torch.int32)
    for donate in (True, False):
        before = s.term.clone()
        ns, out = K.make_step_fn(cfg, donate=donate)(s, inbox, ticks)
        assert torch.equal(s.term, before)
        assert (ns.role == T.ROLE.LEADER).all() and (out.noop_appended == 1).all()
