"""The plain step's gated handler sections against the JAX package's
step_batch, exact on every state field and StepOutput plane.

`_handle_message` runs a handler section only when its message type acts
on some lane whose role handles it; a skipped section must leave every
field as its masked updates would with an all-False mask. The inboxes here
hold, per slot, one message type, two, or all of them (each type alone in
some slot, some slots empty on every lane), over states captured from
seeded JAX LoopbackCluster runs at P=3 and P=5 with witnesses, observers,
leases and pre-vote on, then perturbed as in test_torch_kernel.py."""
import functools
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonboat_tpu.ops import state as J
from dragonboat_tpu.ops.kernel import make_step_fn as j_make_step_fn
from dragonboat_tpu_torch.kernel_bench import random_inbox
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from test_torch_kernel import G, _assert_equal, _captured_states, _cfg, _jax_tree, _perturb

E = 4
LEASE = dict(check_quorum=True, prevote=True, lease_read=True, lease_margin=1)
# (P, cluster options, replicas)
CASES = {
    "P3-witness": (3, dict(LEASE, witnesses=(2,)), 3),
    "P3-observer": (3, dict(LEASE, observers=(2,)), 3),
    "P5-witness-observer": (5, dict(LEASE, witnesses=(4,), observers=(3,)), 5),
}
TYPES = [v for k, v in vars(T.MSG).items() if k.isupper() and v != T.MSG.NONE]


@functools.lru_cache(maxsize=None)
def _states(case):
    P, opts, n = CASES[case]
    return _captured_states(P, E, opts, n, seed=31 * P + n)


def _restrict(rng, ib, st, mode, i):
    """Per slot: one type (cycling through every type), two, or all; slot
    K-1 empty on every lane in every other state."""
    if mode == "all":
        return ib
    mtype = ib["mtype"].copy()
    Kd = mtype.shape[1]
    for k in range(Kd):
        if mode == "one":
            pick = [TYPES[(i * Kd + k) % len(TYPES)]]
        else:
            pick = list(rng.choice(TYPES, size=2, replace=False))
        mtype[:, k] = rng.choice(pick + [T.MSG.NONE], size=G)
    if i % 2 == 0:
        mtype[:, Kd - 1] = T.MSG.NONE
    tag = (rng.random(mtype.shape) < 0.3) & (mtype == T.MSG.HEARTBEAT_RESP)
    li = np.where(tag, st["hb_round_tick"][:, None], ib["log_index"]).astype(np.int32)
    return dict(ib, mtype=mtype.astype(np.int32), log_index=li)


@pytest.mark.parametrize("mode", ["one", "two", "all"])
@pytest.mark.parametrize("case", list(CASES))
def test_gated_sections_match_jax(case, mode):
    P, opts, n = CASES[case]
    cfg = _cfg(P, E)
    jcfg, tcfg = J.KernelConfig(**cfg), T.KernelConfig(**cfg)
    jstep = j_make_step_fn(jcfg, donate=False)
    rng = np.random.default_rng(zlib.crc32(f"{case}/{mode}".encode()))
    states = _states(case)
    assert states
    alone, roles = set(), set()
    for i, st in enumerate(states):
        for perturbed in (False, True):
            s = _perturb(rng, st, tcfg.readindex_depth) if perturbed else st
            ib = _restrict(rng, random_inbox(rng, s, tcfg), s, mode, i)
            ticks = rng.integers(0, 3, G).astype(np.int32)
            js, jo = jstep(_jax_tree(J.RaftTensors, s), _jax_tree(J.Inbox, ib),
                           jnp.asarray(ticks))
            ts, to = K.step_batch(state_from_numpy(s, device="cpu"),
                                  state_from_numpy(ib, device="cpu"),
                                  torch.from_numpy(ticks), tcfg)
            _assert_equal(js, ts, f"{case} {mode} state {i} perturbed={perturbed}")
            _assert_equal(jo, to, f"{case} {mode} output {i} perturbed={perturbed}")
            for k in range(ib["mtype"].shape[1]):
                kinds = set(np.unique(ib["mtype"][:, k]).tolist()) - {T.MSG.NONE}
                if len(kinds) == 1:
                    alone |= kinds
            roles |= set(np.unique(s["role"]).tolist())
    # the states hold the roles the gates key on
    assert {T.ROLE.LEADER, T.ROLE.FOLLOWER} <= roles
    assert (T.ROLE.WITNESS in roles) == ("witness" in case)
    assert (T.ROLE.OBSERVER in roles) == ("observer" in case)
    if mode == "one":
        assert alone == set(TYPES)
