"""The router kernels' per-candidate and per-lane code, built as host C++,
against the port's plain router, exact on every field.

`csrc/route.cu` compiles as plain C++ too (its `RT_DEV` functions are
`static inline` without nvcc, and the atomicMin becomes a plain compare),
so g++ builds a small library whose host loops run the columns code for
every thread of every block of a columns launch (entry runs, then each
kind's header columns), the scatter's insert pass for every gathered
candidate position and its write pass for every (lane, slot) and thread of
the slot, with the same parameter structs `ops/cuda.py` fills for the card.
Every shard's record the columns code writes equals `kernel._pack_record`
of the plain columns, word for word, and the scatter reads those records
as the card path gathers them. The
insert pass runs over the candidates in reverse order, or in a seeded
shuffled order, which shows that the cascading atomicMin lists do not
depend on arrival order; after the write pass the scratch is free again.
The launch itself, and the same comparison on the card, are in
`chip_smoke.py`.

Draws: tests/test_multistep.py's seeded random (state, output) generator
with seeded routes that cross shards; the unsharded router and the
sharded one (n = 2 and 4 lane blocks) against route_step_output_reference.
"""
import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import test_multistep as tm
import test_shard_multistep as tsm
from dragonboat_tpu_torch.ops import cuda, kernel as K
from dragonboat_tpu_torch.ops import state as T
from test_torch_multistep import _assert_tree_equal, _to_port, random_route

_HOST_MAIN = r"""
#include <stdlib.h>
#include "route.cu"

extern "C" int route_columns_host_params_size() { return (int)sizeof(RouteColumnsParams); }
extern "C" int route_scatter_host_params_size() { return (int)sizeof(RouteScatterParams); }

// every thread of every block of a columns launch of bt-thread blocks
extern "C" void route_columns_host(const RouteColumnsParams* p, int bt) {
  const int blocks = columns_blocks(*p, bt);
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < bt; ++t) columns_thread(*p, b, t, bt);
}

// the insert pass over the gathered positions in the given order (reverse
// order when `order` is null), then the write pass slot by slot, each slot
// read once, freed, and written by its RT_SLOT_THREADS threads in turn
extern "C" void route_scatter_host(const RouteScatterParams* p, const int* order) {
  const int total = p->n * p->M;
  for (int x = 0; x < total; ++x) scatter_insert(*p, order ? order[x] : total - 1 - x);
  const int slots = p->n * p->Gl * p->K;
  for (int q = 0; q < slots; ++q) {
    const int c = p->slots[q];
    p->slots[q] = RT_EMPTY;
    for (int t = 0; t < RT_SLOT_THREADS; ++t) scatter_write(*p, c, q, t, RT_SLOT_THREADS);
  }
}
"""

SENTINEL = -1431655766


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the host build of the router needs it")
    d = tmp_path_factory.mktemp("route_host")
    src, lib = d / "host.cpp", d / "route_host.so"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda.CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.route_columns_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    so.route_scatter_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for fn in ("route_columns_host", "route_scatter_host"):
        getattr(so, fn).restype = None
    assert so.route_columns_host_params_size() == ctypes.sizeof(cuda.RouteColumnsParams)
    assert so.route_scatter_host_params_size() == ctypes.sizeof(cuda.RouteScatterParams)
    return so


def _filled(tree):
    """Sentinel-filled buffers: an element the kernels forget shows up."""
    for t in tree:
        if t.dtype == torch.bool:
            t.fill_(True)
        else:
            t.fill_(SENTINEL)
    return tree


def _host_route(so, states, outs, routes, rdeltas, cfg, order_seed=None, bt=256):
    """The columns code per shard (blocks of `bt` threads), the plain
    gather of the records, the scatter's two passes per shard (the insert
    in reverse order, or shuffled by `order_seed`); returns (per-shard
    Inbox, per-shard RoutePlan, records). Checks that each record is
    _pack_record of the shard's plain columns and that each shard's scratch
    is free again afterwards."""
    n = len(states)
    Gl, P = states[0].member.shape
    K_, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    Ml = Gl * cuda.candidates_per_lane(cfg)
    records = [torch.full((K.record_words(Gl, cfg),), SENTINEL, dtype=torch.int32)
               for _ in range(n)]
    plans = [_filled(cuda._alloc_plan(Gl, P, K_, R, "cpu")) for _ in range(n)]
    nxts = [_filled(cuda._alloc_inbox(Gl, K_, E, "cpu")) for _ in range(n)]
    for i in range(n):
        p = cuda._columns_params(states[i], outs[i], routes[i], rdeltas[i], records[i],
                                 plans[i], cfg)
        so.route_columns_host(ctypes.byref(p), bt)
        cols = K._route_columns(states[i], outs[i], routes[i], rdeltas[i], cfg)
        assert torch.equal(records[i], K._pack_record(*cols, cfg)), ("record", i)
    gathered = K.ring_gather_reference(records)
    for i in range(n):
        slots = cuda.alloc_slots(n * Gl, K_, "cpu")
        p = cuda._scatter_params(gathered[i], slots, n, i, Gl, P, nxts[i], plans[i], cfg)
        order = None
        if order_seed is not None:
            perm = np.random.default_rng(order_seed + i).permutation(n * Ml)
            order = torch.from_numpy(perm.astype(np.int32))
        so.route_scatter_host(ctypes.byref(p), None if order is None else order.data_ptr())
        assert bool((slots == cuda.ROUTE_EMPTY).all()), "the write pass left a slot taken"
    return nxts, plans, records


def _draw(seed, kcfg, monkeypatch):
    monkeypatch.setattr(tm, "KCFG", kcfg)
    rng = random.Random(9000 + seed)
    s, _, out = tm._random_state_and_output(rng)
    route, rdelta = random_route(rng, s, kcfg.groups, kcfg.peers)
    return _to_port(s), _to_port(out), torch.from_numpy(route), torch.from_numpy(rdelta)


@pytest.mark.parametrize("seed", range(8))
def test_router_code_matches_plain_router(host_lib, seed, monkeypatch):
    cfg = T.KernelConfig(**tm.KCFG._asdict())
    s, out, route, rdelta = _draw(seed, tm.KCFG, monkeypatch)
    nxts, plans, records = _host_route(host_lib, [s], [out], [route], [rdelta], cfg)
    ref_nxt, ref_plan = K.route_step_output_reference(s, out, route, rdelta, cfg)
    _assert_tree_equal(nxts[0], ref_nxt, ("inbox", seed))
    _assert_tree_equal(plans[0], ref_plan, ("plan", seed))
    # the columns code writes the plain version's record exactly, and the
    # record widens to the reference's slab
    cols = K._route_columns(s, out, route, rdelta, cfg)
    assert torch.equal(records[0], K._pack_record(*cols, cfg)), seed
    assert torch.equal(K._widen_record(records[0], cfg.groups, cfg), K._pack_slab(*cols)), seed
    assert int(sum(int(p.sum()) for p in ref_plan)) > 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_sharded_router_code_matches_plain_router(host_lib, n, seed, monkeypatch):
    cfg = T.KernelConfig(**tsm.SKCFG._asdict())
    s, out, route, rdelta = _draw(seed, tsm.SKCFG, monkeypatch)
    nxts, plans, _ = _host_route(host_lib, K.shard_tree(s, n), K.shard_tree(out, n),
                                 K.shard_tree(route, n), K.shard_tree(rdelta, n), cfg)
    ref_nxt, ref_plan = K.route_step_output_reference(s, out, route, rdelta, cfg)
    _assert_tree_equal(K.unshard_tree(nxts), ref_nxt, ("inbox", n, seed))
    _assert_tree_equal(K.unshard_tree(plans), ref_plan, ("plan", n, seed))


def test_router_overflow_keeps_the_first_k_arrivals(host_lib):
    """Every lane sends to lane 0 on every kind: lane 0's inbox takes the
    first K candidates in kind-major, row-major order and nothing else."""
    cfg = T.KernelConfig(groups=4, peers=4, log_window=8, inbox_depth=3,
                         max_entries_per_msg=2, readindex_depth=2)
    G, P = cfg.groups, cfg.peers
    s = T.init_state(cfg, device="cpu")
    out = cuda.empty_output(cfg, "cpu")
    for t in out:
        t.zero_()
    out.send_flags.fill_(T.SEND_REPLICATE | T.SEND_HEARTBEAT)
    route = torch.zeros((G, P), dtype=torch.int32)
    rdelta = torch.zeros((G, P), dtype=torch.int32)
    nxts, plans, _ = _host_route(host_lib, [s], [out], [route], [rdelta], cfg)
    ref_nxt, ref_plan = K.route_step_output_reference(s, out, route, rdelta, cfg)
    _assert_tree_equal(nxts[0], ref_nxt, "inbox")
    _assert_tree_equal(plans[0], ref_plan, "plan")
    assert int(plans[0].rep.sum()) == 3 and bool(plans[0].rep[0, :3].all())
    assert int(plans[0].hb.sum()) == 0


@pytest.mark.parametrize("n", [1, 2, 5])
def test_router_code_across_scatter_blocks(host_lib, n):
    """A 160-lane draw from kernel_bench.random_route_case: shard blocks of
    160 / n lanes, routes to any lane, below-window rejects and out-of-range
    read origins."""
    from dragonboat_tpu_torch.kernel_bench import random_route_case
    from dragonboat_tpu_torch.ops.convert import state_from_numpy

    cfg = T.KernelConfig(groups=160, peers=4, log_window=16, inbox_depth=3,
                         max_entries_per_msg=5, readindex_depth=2)
    st, out, route, rdelta = random_route_case(np.random.default_rng(40 + n), cfg)
    s, o = state_from_numpy(st, "cpu"), state_from_numpy(out, "cpu")
    route, rdelta = torch.from_numpy(route), torch.from_numpy(rdelta)
    nxts, plans, _ = _host_route(host_lib, K.shard_tree(s, n), K.shard_tree(o, n),
                                 K.shard_tree(route, n), K.shard_tree(rdelta, n), cfg)
    ref_nxt, ref_plan = K.route_step_output_reference(s, o, route, rdelta, cfg)
    _assert_tree_equal(K.unshard_tree(nxts), ref_nxt, ("inbox", n))
    _assert_tree_equal(K.unshard_tree(plans), ref_plan, ("plan", n))
    # the draw fills some lanes past K and routes every kind
    assert all(int(p.sum()) > 0 for p in ref_plan)
    assert int((ref_nxt.mtype != T.MSG.NONE).sum(1).max()) == cfg.inbox_depth


@pytest.mark.parametrize("order", ["reverse", "shuffled"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_router_insert_order_does_not_matter(host_lib, n, order):
    """The insert pass over the candidates in reverse order and in a seeded
    shuffled order gives the plain router's inbox and plan, unsharded and
    sharded, on a draw where lanes receive more than K candidates."""
    _check_insert_order(host_lib, n, order, 5)


@pytest.mark.parametrize("E", [8, 16])
@pytest.mark.parametrize("n", [1, 2])
def test_router_code_with_wide_entry_rows(host_lib, n, E):
    """E a multiple of 8: the write pass stores four entry terms and eight
    cc flags at a time (config 6 has E = 64); Replicates with fewer live
    entries than a store covers are zero-filled past n_entries."""
    _check_insert_order(host_lib, n, "shuffled", E)


def _check_insert_order(host_lib, n, order, E):
    from dragonboat_tpu_torch.kernel_bench import random_route_case
    from dragonboat_tpu_torch.ops.convert import state_from_numpy

    cfg = T.KernelConfig(groups=96, peers=4, log_window=16, inbox_depth=3,
                         max_entries_per_msg=E, readindex_depth=2)
    st, out, route, rdelta = random_route_case(np.random.default_rng(70 + n), cfg)
    s, o = state_from_numpy(st, "cpu"), state_from_numpy(out, "cpu")
    route, rdelta = torch.from_numpy(route), torch.from_numpy(rdelta)
    seed = None if order == "reverse" else 500 + n
    nxts, plans, _ = _host_route(host_lib, K.shard_tree(s, n), K.shard_tree(o, n),
                                 K.shard_tree(route, n), K.shard_tree(rdelta, n), cfg, seed)
    ref_nxt, ref_plan = K.route_step_output_reference(s, o, route, rdelta, cfg)
    _assert_tree_equal(K.unshard_tree(nxts), ref_nxt, ("inbox", n, order))
    _assert_tree_equal(K.unshard_tree(plans), ref_plan, ("plan", n, order))
    dest = K._route_columns(s, o, route, rdelta, cfg)[0]
    assert int(torch.bincount(dest[dest >= 0]).max()) > cfg.inbox_depth


@pytest.mark.parametrize("seed", range(4))
def test_router_code_with_shuffled_inserts(host_lib, seed, monkeypatch):
    """tests/test_multistep.py's draws with the insert pass shuffled."""
    cfg = T.KernelConfig(**tm.KCFG._asdict())
    s, out, route, rdelta = _draw(seed, tm.KCFG, monkeypatch)
    nxts, plans, _ = _host_route(host_lib, [s], [out], [route], [rdelta], cfg, 900 + seed)
    ref_nxt, ref_plan = K.route_step_output_reference(s, out, route, rdelta, cfg)
    _assert_tree_equal(nxts[0], ref_nxt, ("inbox", seed))
    _assert_tree_equal(plans[0], ref_plan, ("plan", seed))


@pytest.mark.parametrize("bt", [32, 48])
def test_columns_code_at_other_block_sizes(host_lib, bt):
    """The columns launch's block ranges at blocks of 32 and 48 threads (an
    entry run's threads then straddle two blocks): the same record, inbox
    and plan as the plain router, on a draw with wide entry runs (E=16)."""
    from dragonboat_tpu_torch.kernel_bench import random_route_case
    from dragonboat_tpu_torch.ops.convert import state_from_numpy

    cfg = T.KernelConfig(groups=24, peers=4, log_window=32, inbox_depth=3,
                         max_entries_per_msg=16, readindex_depth=2)
    st, out, route, rdelta = random_route_case(np.random.default_rng(90 + bt), cfg)
    s, o = state_from_numpy(st, "cpu"), state_from_numpy(out, "cpu")
    route, rdelta = torch.from_numpy(route), torch.from_numpy(rdelta)
    nxts, plans, _ = _host_route(host_lib, [s], [o], [route], [rdelta], cfg, bt=bt)
    ref_nxt, ref_plan = K.route_step_output_reference(s, o, route, rdelta, cfg)
    _assert_tree_equal(nxts[0], ref_nxt, ("inbox", bt))
    _assert_tree_equal(plans[0], ref_plan, ("plan", bt))


def test_router_params_refuse_a_record_of_the_wrong_length():
    """The columns and scatter wrappers check the record's length (and the
    gathered stack's shape) before any launch."""
    from dragonboat_tpu_torch.kernel_bench import random_route_case
    from dragonboat_tpu_torch.ops.convert import state_from_numpy

    cfg = T.KernelConfig(groups=8, peers=4, log_window=16, inbox_depth=3,
                         max_entries_per_msg=5, readindex_depth=2)
    G, P, K_, R, E = 8, 4, 3, 2, 5
    st, out, route, rdelta = random_route_case(np.random.default_rng(3), cfg)
    s, o = state_from_numpy(st, "cpu"), state_from_numpy(out, "cpu")
    route, rdelta = torch.from_numpy(route), torch.from_numpy(rdelta)
    L = K.record_words(G, cfg)
    plan, nxt = cuda._alloc_plan(G, P, K_, R, "cpu"), cuda._alloc_inbox(G, K_, E, "cpu")
    cuda._columns_params(s, o, route, rdelta, torch.zeros(L, dtype=torch.int32), plan, cfg)
    for bad in (torch.zeros(L - 1, dtype=torch.int32), torch.zeros((11 + 2 * E, G * 22),
                                                                   dtype=torch.int32)):
        with pytest.raises(ValueError, match="record"):
            cuda._columns_params(s, o, route, rdelta, bad, plan, cfg)
    slots = cuda.alloc_slots(2 * G, K_, "cpu")
    cuda._scatter_params(torch.zeros((2, L), dtype=torch.int32), slots, 2, 0, G, P, nxt, plan,
                         cfg)
    for bad in (torch.zeros((2, L + 1), dtype=torch.int32), torch.zeros(L, dtype=torch.int32),
                torch.zeros(2 * L, dtype=torch.int32)):
        with pytest.raises(ValueError, match="gathered"):
            cuda._scatter_params(bad, slots, 2, 0, G, P, nxt, plan, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda.route_columns_cuda(s, o, route, rdelta, cfg)
