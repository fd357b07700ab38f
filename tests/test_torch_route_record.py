"""The candidate record, the card path's exchange format, against the
reference's (11 + 2E, Ml) candidate slab, bit for bit.

`csrc/route.cu`'s columns kernel writes a record (`kernel._pack_record` is
its plain version) in place of the slab that the JAX package's
`_shard_route` packs and exchanges: the slab's 11 header rows, then an entry
run per Replicate candidate only. `_widen_record` turns a record back into
the slab. Over tests/test_multistep.py's seeded draws (and
kernel_bench.random_route_case's, whose runs wrap the ring), unsharded and
at 2 and 4 lane blocks, with E in {5, 8, 64}: the record widens to the
slab packed from the port's columns and to the slab packed, as
`_shard_route` packs it, from the JAX package's `_route_columns`.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_multistep as tm
import test_shard_multistep as tsm
from dragonboat_tpu.ops import kernel as JK
from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.ops import kernel as K
from dragonboat_tpu_torch.ops import state as T
from test_torch_multistep import _to_port, random_route

ES = [5, 8, 64]


def _jcfg(E):
    """tests/test_shard_multistep.py's 8-lane shape at E entries per
    message, with a ring wide enough for test_multistep's draw."""
    return tsm.SKCFG._replace(max_entries_per_msg=E, log_window=max(32, 2 * E))


def _jax_slab(dest, fields, efields):
    """The slab as the JAX package's _shard_route packs it."""
    cols = [dest] + [f.astype(jnp.int32) for f in fields]
    return np.asarray(jnp.concatenate([jnp.stack(cols)] +
                                      [ef.astype(jnp.int32).T for ef in efields]))


def _blocks(tree, n, i):
    Gl = tree[0].shape[0] // n
    return type(tree)(*(a[i * Gl:(i + 1) * Gl] for a in tree))


def _torch_cols(cols):
    dest, fields, efields = cols
    t = lambda a: torch.from_numpy(np.array(a))
    return t(dest), tuple(t(f) for f in fields), tuple(t(e) for e in efields)


def _multistep_draw(seed, E, monkeypatch):
    jcfg = _jcfg(E)
    monkeypatch.setattr(tm, "KCFG", jcfg)
    rng = random.Random(6000 + 31 * seed + E)
    s, _, out = tm._random_state_and_output(rng)
    route, rdelta = random_route(rng, s, jcfg.groups, jcfg.peers)
    return jcfg, s, out, route, rdelta


def _case_draw(seed, E):
    """kernel_bench.random_route_case at the same shape: prev indexes from
    -3 to W and n_entries up to E + 1, so runs wrap the ring."""
    from dragonboat_tpu_torch.kernel_bench import random_route_case

    jcfg = _jcfg(E)
    st, out, route, rdelta = random_route_case(np.random.default_rng(600 + 7 * seed + E),
                                               T.KernelConfig(**jcfg._asdict()))
    s = J.RaftTensors(**{f: jnp.asarray(st[f]) for f in J.RaftTensors._fields})
    o = J.StepOutput(**{f: jnp.asarray(out[f]) for f in J.StepOutput._fields})
    return jcfg, s, o, route, rdelta


def _check_record(jcfg, s, out, route, rdelta, n):
    """Per lane block: the record of the port's columns and the record of
    the JAX columns both widen to the JAX package's slab, and the two
    records are equal. Returns the JAX columns of the blocks."""
    cfg = T.KernelConfig(**jcfg._asdict())
    Gl = jcfg.groups // n
    got = []
    for i in range(n):
        js, jo = _blocks(s, n, i), _blocks(out, n, i)
        jr, jd = route[i * Gl:(i + 1) * Gl], rdelta[i * Gl:(i + 1) * Gl]
        jcols = JK._route_columns(js, jo, jnp.asarray(jr), jnp.asarray(jd), jcfg)
        slab = _jax_slab(*jcols)
        pcols = K._route_columns(_to_port(js), _to_port(jo), torch.from_numpy(jr),
                                 torch.from_numpy(jd), cfg)
        rec = K._pack_record(*pcols, cfg)
        assert rec.dtype == torch.int32 and tuple(rec.shape) == (K.record_words(Gl, cfg),)
        jrec = K._pack_record(*_torch_cols(jcols), cfg)
        assert torch.equal(rec, jrec), (n, i)
        for r in (rec, jrec):
            wide = K._widen_record(r, Gl, cfg)
            assert wide.dtype == torch.int32
            assert wide.numpy().tobytes() == slab.tobytes(), (n, i)
        got.append(jcols)
    return got


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("E", ES)
@pytest.mark.parametrize("seed", range(3))
def test_record_widens_to_the_jax_slab(seed, E, n, monkeypatch):
    _check_record(*_multistep_draw(seed, E, monkeypatch), n)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("E", ES)
def test_record_widens_to_the_jax_slab_on_wrapping_runs(E, n):
    _check_record(*_case_draw(E % 3, E), n)


def test_the_draws_are_not_vacuous(monkeypatch):
    """Over the draws the record leaves out words that are not zero in no
    case: unwanted Replicates carry n_entries > 0 (their runs are all
    zero), wanted ones carry live entries with set cc flags, some runs
    wrap the ring, and some n_entries exceed E or are short of it."""
    unwanted = wrapped = cc_set = short = over = 0
    draws = [_multistep_draw(seed, E, monkeypatch) for seed in range(3) for E in ES]
    draws += [_case_draw(E % 3, E) for E in ES]
    for jcfg, s, out, route, rdelta in draws:
        E, W, P = jcfg.max_entries_per_msg, jcfg.log_window, jcfg.peers
        (dest, fields, efields), = _check_record(jcfg, s, out, route, rdelta, 1)
        G = jcfg.groups
        rep_dest = np.asarray(dest)[:G * P]
        n_ent = np.asarray(fields[9])[:G * P]
        unwanted += int(((rep_dest < 0) & (n_ent > 0)).sum())
        live = (rep_dest >= 0) & (n_ent > 0)
        cc_set += int(np.asarray(efields[1])[:G * P][live].any(axis=1).sum())
        short += int((live & (n_ent < E)).sum())
        over += int((live & (n_ent > E)).sum())
        first = np.asarray(out.send_prev_index).reshape(-1).astype(np.int64) + 1
        last = first + np.clip(n_ent, 0, E) - 1
        wrapped += int((live & (first // W != last // W)).sum())
    assert unwanted > 0 and cc_set > 0 and short > 0 and over > 0 and wrapped > 0


def test_widen_refuses_a_record_of_the_wrong_length():
    cfg = T.KernelConfig(**_jcfg(8)._asdict())
    rec = torch.zeros((K.record_words(2, cfg) + 1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        K._widen_record(rec, 2, cfg)
