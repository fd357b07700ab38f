"""The router kernels' per-candidate and per-lane code, built as host C++,
against the port's plain router, exact on every field.

`csrc/route.cu` compiles as plain C++ too (its `RT_DEV` functions are
`static inline` without nvcc, and the shared-memory atomicMin becomes a
plain compare), so g++ builds a small library whose host loops run the
columns code for every candidate and the scatter code block by block, with
the same parameter structs `ops/cuda.py` fills for the card. The scatter's
insertion runs over the candidates in reverse order, which shows that the
cascading atomicMin lists do not depend on arrival order. The launch
itself, and the same comparison on the card, are in `chip_smoke.py`.

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

extern "C" void route_columns_host(const RouteColumnsParams* p) {
  for (int c = 0; c < p->M; ++c) route_candidate(*p, c);
}

extern "C" void route_scatter_host(const RouteScatterParams* p) {
  const int G = p->n * p->Gl, D = RT_LANES_PER_BLOCK, DK = D * p->K;
  int* slots = (int*)malloc(sizeof(int) * DK);
  long long* cols = (long long*)malloc(sizeof(long long) * DK);
  for (int d0 = 0; d0 < G; d0 += D) {
    for (int q = 0; q < DK; ++q) slots[q] = RT_EMPTY;
    for (int i = p->n * p->M - 1; i >= 0; --i)
      scatter_insert(*p, slots, d0, D, i, dest_at(*p, i));
    for (int q = 0; q < DK; ++q) cols[q] = scatter_write(*p, slots, d0, q);
    for (int x = 0; x < DK * p->E; ++x) scatter_entry(*p, cols, d0, x);
  }
  free(cols);
  free(slots);
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
    for fn in ("route_columns_host", "route_scatter_host"):
        getattr(so, fn).argtypes = [ctypes.c_void_p]
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


def _host_route(so, states, outs, routes, rdeltas, cfg):
    """The columns code per shard, the plain gather, the scatter code per
    shard; returns (per-shard Inbox, per-shard RoutePlan, slabs)."""
    n = len(states)
    Gl, P = states[0].member.shape
    K_, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    Ml = Gl * cuda.candidates_per_lane(cfg)
    slabs = [torch.full((cuda.slab_rows(cfg), Ml), SENTINEL, dtype=torch.int32)
             for _ in range(n)]
    plans = [_filled(cuda._alloc_plan(Gl, P, K_, R, "cpu")) for _ in range(n)]
    nxts = [_filled(cuda._alloc_inbox(Gl, K_, E, "cpu")) for _ in range(n)]
    for i in range(n):
        p = cuda._columns_params(states[i], outs[i], routes[i], rdeltas[i], slabs[i],
                                 plans[i], cfg)
        so.route_columns_host(ctypes.byref(p))
    gathered = K.ring_gather_reference(slabs)
    for i in range(n):
        p = cuda._scatter_params(gathered[i], n, i, Gl, P, nxts[i], plans[i], cfg)
        so.route_scatter_host(ctypes.byref(p))
    return nxts, plans, slabs


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
    nxts, plans, slabs = _host_route(host_lib, [s], [out], [route], [rdelta], cfg)
    ref_nxt, ref_plan = K.route_step_output_reference(s, out, route, rdelta, cfg)
    _assert_tree_equal(nxts[0], ref_nxt, ("inbox", seed))
    _assert_tree_equal(plans[0], ref_plan, ("plan", seed))
    # the columns code writes the plain version's slab exactly
    ref_slab = K._pack_slab(*K._route_columns(s, out, route, rdelta, cfg))
    assert torch.equal(slabs[0], ref_slab), seed
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
    """A 160-lane draw from kernel_bench.random_route_case: several scatter
    blocks of RT_LANES_PER_BLOCK lanes, shard blocks that straddle them,
    routes to any lane, below-window rejects and out-of-range read origins."""
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
