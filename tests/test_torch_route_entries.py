"""The invariant the router's scatter relies on: in the router's candidate
columns, the entry rows past a candidate's n_entries are zero.

The scatter's write pass (`csrc/route.cu`, route_scatter_kernel) copies
only the first clip(n_entries, 0, E) entry terms and cc flags of a chosen
candidate and writes zeros past them without reading them. That is exact
because `_route_columns` masks a Replicate's entries with
e < n_entries (`e_live` in dragonboat_tpu/ops/kernel.py) and gives every
other kind n_entries = 0 and zero entries; the candidate record
(`_pack_record`, tests/test_torch_route_record.py) leaves those words out
for the same reason. Checked on the JAX package's
`_route_columns` and on the port's, for every column (candidates and
non-candidates alike), over tests/test_multistep.py's seeded draws.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_multistep as tm
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from test_torch_multistep import _to_port, random_route


def _assert_entries_past_n_are_zero(fields, efields, E):
    """Every column's entry rows at e >= clip(n_entries, 0, E) are zero;
    returns how many columns carry live entries."""
    n = np.clip(np.asarray(fields[9]).astype(np.int64), 0, E)
    terms, cc = np.asarray(efields[0]), np.asarray(efields[1])
    past = np.arange(E)[None, :] >= n[:, None]
    assert terms.shape == cc.shape == past.shape
    assert not terms[past].any(), "an entry term past n_entries is not zero"
    assert not cc[past].any(), "an entry cc flag past n_entries is set"
    return int(((terms != 0) & ~past).any(axis=1).sum())


def _draw(seed):
    rng = random.Random(4000 + seed)
    s, _, out = tm._random_state_and_output(rng)
    route, rdelta = random_route(rng, s, tm.KCFG.groups, tm.KCFG.peers)
    return s, out, route, rdelta


@pytest.mark.parametrize("seed", range(8))
def test_jax_route_columns_zero_entries_past_n(seed):
    s, out, route, rdelta = _draw(seed)
    _, fields, efields = JK._route_columns(s, out, jnp.asarray(route), jnp.asarray(rdelta),
                                           tm.KCFG)
    _assert_entries_past_n_are_zero(fields, efields, tm.KCFG.max_entries_per_msg)


@pytest.mark.parametrize("seed", range(8))
def test_port_route_columns_zero_entries_past_n(seed):
    s, out, route, rdelta = _draw(seed)
    cfg = T.KernelConfig(**tm.KCFG._asdict())
    dest, fields, efields = K._route_columns(_to_port(s), _to_port(out), torch.from_numpy(route),
                                             torch.from_numpy(rdelta), cfg)
    _assert_entries_past_n_are_zero(fields, efields, cfg.max_entries_per_msg)


def test_the_draws_carry_live_entries():
    """Not vacuous: over the draws, routed Replicates carry nonzero entry
    terms below n_entries, and some columns have n_entries < E."""
    live, short = 0, 0
    E = tm.KCFG.max_entries_per_msg
    for seed in range(8):
        s, out, route, rdelta = _draw(seed)
        dest, fields, efields = JK._route_columns(s, out, jnp.asarray(route),
                                                  jnp.asarray(rdelta), tm.KCFG)
        live += _assert_entries_past_n_are_zero(fields, efields, E)
        n = np.asarray(fields[9])
        short += int(((np.asarray(dest) >= 0) & (n > 0) & (n < E)).sum())
    assert live > 0 and short > 0
