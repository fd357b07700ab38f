"""The engine's window rebase in the port against the JAX package, on the
CPU, with inputs made from a seed with numpy:

- `ops/state.py:rebase` against `dragonboat_tpu.ops.state.rebase` at P 3
  and 5 and W 16 and 256, with per-lane deltas that are multiples of W,
  0 included;
- the residual inbox's rebase (`engine/vector.py:rebase_resid`, and
  `rebase_lanes`, the engine's call) against the JAX engine's own: a K=8
  NodeHost of each package with the rebase threshold lowered, the JAX
  engine's state and residual inbox kept around the first `_do_rebase`
  that found parked rows, and the port's plain versions run on what the
  JAX engine had before, every plane bit-equal to what it had after;
- `csrc/rebase.cu`'s per-block code built as host C++ (g++; skipped
  without it) over every block and thread of a launch, on the struct
  `ops/cuda.py` fills for the card, against both plain versions: seeded
  states and residual inboxes of every message type, P 3-8, K 0 (no
  residual inbox), 4 and 8, a ragged last block, rows off their 16-byte
  boundaries, and the two engines' own rebases;
- a CUDA-typed call that raises, and never runs a plain version, where no
  kernel can build;
- a K=1 and a K=8 port engine that rebase on the CPU in the same scenario
  as the JAX engine, with the same verdicts.
The kernel itself runs on the card in chip_smoke.py's phases 3 and 13."""
import ctypes
import importlib
import shutil
import subprocess
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.engine import vector as TV
from dragonboat_tpu_torch.ops import cuda
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from test_torch_engine_activate import assert_same, seeded_tree

INDEX_PLANES = cuda.REBASE_SCALARS + cuda.REBASE_ROWS


def seeded(seed, P, W, K=4, groups=70):
    """A seeded state and residual inbox of the given shapes (numpy
    planes), every message type in the inbox, index values around the
    deltas so that the floors bite."""
    cfg = J.KernelConfig(groups=groups, peers=P, log_window=W, inbox_depth=K,
                         max_entries_per_msg=4, readindex_depth=4)
    rng = np.random.default_rng(seed)
    st = seeded_tree(J.init_state(cfg), rng)
    for f in INDEX_PLANES:
        st[f] = rng.integers(-3, 5 * W, st[f].shape).astype(np.int32)
    ib = seeded_tree(J.make_empty_inbox(cfg), rng)
    ib["mtype"] = rng.integers(-1, 28, ib["mtype"].shape).astype(np.int32)
    for f in ("log_index", "commit", "hint"):
        ib[f] = rng.integers(-3, 5 * W, ib[f].shape).astype(np.int32)
    delta = (rng.integers(0, 4, groups) * W).astype(np.int32)
    delta[:3] = 0
    return cfg, rng, st, ib, delta


def jax_resid_rebase(r, delta):
    """dragonboat_tpu/engine/vector.py:_do_rebase's residual shift, as the
    JAX engine writes it inline."""
    d = jnp.asarray(delta)[:, None]
    mt = r.mtype
    idx_t = ((mt == J.MSG.REPLICATE) | (mt == J.MSG.REPLICATE_RESP)
             | (mt == J.MSG.READ_INDEX_RESP) | (mt == J.MSG.REQUEST_VOTE))
    commit_t = (mt == J.MSG.REPLICATE) | (mt == J.MSG.HEARTBEAT)
    hint_t = mt == J.MSG.REPLICATE_RESP
    return r._replace(
        log_index=jnp.where(idx_t, r.log_index - d, r.log_index),
        commit=jnp.where(commit_t, jnp.maximum(r.commit - d, 0), r.commit),
        hint=jnp.where(hint_t, jnp.maximum(r.hint - d, 0), r.hint))


@pytest.mark.parametrize("P,W", [(3, 16), (3, 256), (5, 16), (5, 256)])
def test_rebase_matches_jax(P, W):
    cfg, _rng, st, ib, delta = seeded(P * 10 + W, P, W)
    want = J.rebase(J.RaftTensors(**{f: jnp.asarray(a) for f, a in st.items()}), delta)
    assert_same(want, T.rebase(state_from_numpy(st, device="cpu"), torch.from_numpy(delta)))
    # the engine's call on the CPU: the same new tree, the residual inbox
    # shifted in place as the JAX engine shifts it
    jr = jax_resid_rebase(J.Inbox(**{f: jnp.asarray(a) for f, a in ib.items()}), delta)
    ts, tr = state_from_numpy(st, device="cpu"), state_from_numpy(ib, device="cpu")
    TV.REBASES.update(calls=0, with_resid=0)
    assert_same(want, TV.rebase_lanes(ts, torch.from_numpy(delta), tr))
    assert_same(jr, tr)
    assert TV.REBASES == {"calls": 1, "with_resid": 1}


# ------------------------------------------------- both engines, rebasing

ENGINE_GROUPS, ENGINE_W, ENGINE_THRESHOLD = 4, 16, 32
# proposals a group commits, in waves: the first rebase (past 32) falls
# early in the third wave, so at K=8 the leader still has a wave's worth to
# replicate through the last inner step when the rebase runs
ENGINE_WAVES = (10, 20, 20, 20, 20, 10)
ENGINE_ENTRIES = sum(ENGINE_WAVES)
MEMBERS = {1: "rb:1", 2: "rb:2", 3: "rb:3"}


def _planes(tree):
    if tree is None:
        return None
    return {f: np.array(getattr(tree, f)) for f in tree._fields}


def rebase_scenario(pkg, steps_per_sync):
    """ENGINE_GROUPS groups x 3 replicas on one shared core of `pkg`'s
    vector engine (W=16, inbox 8, one entry a message, so that at K=8 a
    hot group's replication runs through the last inner step and parks
    rows in the residual inbox), the rebase threshold lowered to 32. Each
    group commits ENGINE_ENTRIES proposals in ENGINE_WAVES, then one more
    after the last rebase. Returns the verdicts, the rebases that
    moved a base, those that found parked rows, and the engine's state and
    residual inbox before and after the first of those (numpy planes) with
    its delta."""
    C = importlib.import_module(pkg + ".config")
    NH = importlib.import_module(pkg + ".nodehost")
    SM = importlib.import_module(pkg + ".statemachine")
    LB = importlib.import_module(pkg + ".transport.loopback")
    V = importlib.import_module(pkg + ".engine.vector")
    port = pkg == "dragonboat_tpu_torch"
    got = {"rebases": 0, "parked": 0, "first": None, "first_parked": None}
    deltas = []

    def shards(engine):
        # (state, residual inbox) of the engine's one lane block; the
        # residual inbox only where K > 1
        if engine._multi <= 1:
            resid = None
        else:
            resid = engine._shards[0].resid if port else engine._resid
        return (engine._shards[0].state if port else engine._state), resid

    orig_do, orig_call = V.VectorEngine._do_rebase, getattr(V, "rebase_lanes" if port else "rebase")

    def do_rebase(self):
        parked = self._multi > 1 and bool(self._m_resid.any())
        n = len(deltas)
        keep = got["first"] is None or (parked and got["first_parked"] is None)
        before = [_planes(t) for t in shards(self)] if keep else None
        orig_do(self)
        if len(deltas) > n:
            got["rebases"] += 1
            got["parked"] += parked
            if before is not None:
                kept = (before, deltas[-1], [_planes(t) for t in shards(self)])
                got["first"] = got["first"] or kept
                if parked and got["first_parked"] is None:
                    got["first_parked"] = kept

    def call(state, delta, *rest):
        deltas.append(np.array(delta))
        return orig_call(state, delta, *rest)

    class KV(SM.IStateMachine):
        def __init__(self, cluster_id, node_id):
            self.cluster_id, self.data = cluster_id, {}
            replicas.append(self)

        def update(self, cmd):
            k, v = cmd.decode().split("=", 1)
            self.data[k] = v
            return SM.Result(value=len(self.data))

        def lookup(self, q):
            return self.data.get(q)

        def save_snapshot(self, w, files, done):
            pass

        def recover_from_snapshot(self, r, files, done):
            pass

    replicas = []
    saved = V._REBASE_THRESHOLD
    V._REBASE_THRESHOLD = ENGINE_THRESHOLD
    V.VectorEngine._do_rebase = do_rebase
    setattr(V, "rebase_lanes" if port else "rebase", call)
    reg = LB._Registry()
    kw = dict(kind="vector", max_groups=3 * ENGINE_GROUPS, max_peers=4, log_window=ENGINE_W,
              inbox_depth=8, max_entries_per_msg=1, steps_per_sync=steps_per_sync,
              share_scope=f"rebase-{pkg}-{id(reg)}")
    if port:
        kw["device"] = "cpu"
    hosts = {}
    try:
        for nid, addr in MEMBERS.items():
            hosts[nid] = NH.NodeHost(C.NodeHostConfig(
                deployment_id=3, rtt_millisecond=50, raft_address=addr,
                raft_rpc_factory=lambda listen: LB.loopback_factory(listen, reg),
                engine=C.EngineConfig(**kw)))
        for nid, nh in hosts.items():
            nh.start_clusters([(dict(MEMBERS), False, KV, C.Config(
                cluster_id=c, node_id=nid, election_rtt=10, heartbeat_rtt=2))
                for c in range(1, ENGINE_GROUPS + 1)])

        def leader(c):
            for nid, nh in hosts.items():
                lid, ok = nh.get_leader_id(c)
                if ok and lid == nid:
                    return nh
            return None

        deadline = time.monotonic() + 60
        while any(leader(c) is None for c in range(1, ENGINE_GROUPS + 1)):
            assert time.monotonic() < deadline, "groups never elected"
            time.sleep(0.05)
        failed = []

        def propose(c, keys):
            nh = leader(c) or hosts[1]
            rss = nh.propose_batch(nh.get_noop_session(c), [f"{k}=v".encode() for k in keys],
                                   20.0)
            failed.extend((c, k) for k, rs in zip(keys, rss) if not rs.wait(21.0).completed)

        def client(c):
            j = 0
            for n in ENGINE_WAVES:
                propose(c, [f"k{x}" for x in range(j, j + n)])
                j += n

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(1, ENGINE_GROUPS + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rebased = got["rebases"]
        for c in range(1, ENGINE_GROUPS + 1):
            propose(c, ["last"])
        want = {f"k{x}": "v" for x in range(ENGINE_ENTRIES)} | {"last": "v"}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            by_group = {}
            for sm in replicas:
                # the factory's type probe keeps no data
                if sm.data:
                    by_group.setdefault(sm.cluster_id, []).append(dict(sm.data))
            converged = (len(by_group) == ENGINE_GROUPS and all(
                len(v) == 3 and all(d == want for d in v) for v in by_group.values()))
            if converged:
                break
            time.sleep(0.1)
        got["verdicts"] = {
            "rebased_more_than_once": rebased >= 2,
            "a_rebase_found_parked_rows": got["parked"] > 0 if steps_per_sync > 1 else None,
            "committed_after_the_last_rebase": rebased > 0 and not failed,
            "replicas_converged": converged,
        }
        return got
    finally:
        for nh in hosts.values():
            nh.stop()
        V._REBASE_THRESHOLD = saved
        V.VectorEngine._do_rebase = orig_do
        setattr(V, "rebase_lanes" if port else "rebase", orig_call)


@pytest.fixture(scope="module")
def engine_runs():
    """Both packages' runs at K=1 and K=8, once for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {(pkg, k): rebase_scenario(pkg, k)
                for k in (1, 8) for pkg in ("dragonboat_tpu", "dragonboat_tpu_torch")}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("k", [1, 8], ids=["k1", "k8"])
def test_port_engine_rebases_with_the_jax_engine_verdicts(engine_runs, k):
    ref, port = engine_runs[("dragonboat_tpu", k)], engine_runs[("dragonboat_tpu_torch", k)]
    assert port["verdicts"] == ref["verdicts"], (port["verdicts"], ref["verdicts"])
    assert all(v is not False for v in port["verdicts"].values()), port["verdicts"]


def test_resid_rebase_matches_the_jax_engine(engine_runs):
    """The port's plain versions on the JAX engine's state and residual
    inbox just before its first rebase with parked rows, against what the
    JAX engine had just after it."""
    (st, ib), delta, (want_st, want_ib) = engine_runs[("dragonboat_tpu", 8)]["first_parked"]
    assert (ib["mtype"] != J.MSG.NONE).any() and delta.any()
    tr = state_from_numpy(ib, device="cpu")
    TV.rebase_resid(tr, torch.from_numpy(delta))
    for f, a in want_ib.items():
        assert np.array_equal(getattr(tr, f).numpy(), a), f
    ts, tr = state_from_numpy(st, device="cpu"), state_from_numpy(ib, device="cpu")
    ts = TV.rebase_lanes(ts, torch.from_numpy(delta), tr)
    for want, got in ((want_st, ts), (want_ib, tr)):
        for f, a in want.items():
            assert np.array_equal(getattr(got, f).numpy(), a), f


# ------------------------------------------------ the kernel on the host

_HOST_MAIN = r"""
#include "rebase.cu"

extern "C" int rebase_host_params_size() { return (int)sizeof(RebaseParams); }

// every thread of every block of a launch of `threads`-thread blocks
extern "C" void rebase_host(const RebaseParams* p, int threads) {
  const int64_t blocks = (p->G + RB_LANES - 1) / RB_LANES;
  for (int64_t b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) rebase_block(*p, b, t, threads);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the host build of the rebase kernel needs it")
    d = tmp_path_factory.mktemp("rebase_host")
    src, lib = d / "host.cpp", d / "rebase_host.so"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda.CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.rebase_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert so.rebase_host_params_size() == ctypes.sizeof(cuda.RebaseParams)
    return so


def offset_copy(t):
    """A contiguous copy of `t` one element into a buffer of its own: every
    row off its 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v


def run_host(host_lib, st, ib, delta, threads, shifted=False):
    """The kernel's blocks on the host over copies of the numpy planes;
    returns the state and the residual inbox (None where ib is None)."""
    copy = offset_copy if shifted else torch.clone
    ts = state_from_numpy(st, device="cpu")
    ts = type(ts)(*(copy(t) for t in ts))
    tr = None
    if ib is not None:
        tr = state_from_numpy(ib, device="cpu")
        tr = type(tr)(*(copy(t) for t in tr))
    d = copy(torch.from_numpy(delta))
    p = cuda.rebase_params(ts, d, tr)
    host_lib.rebase_host(ctypes.byref(p), threads)
    del d  # alive until the blocks ran: the struct holds its address only
    return ts, tr


@pytest.mark.parametrize("threads", [352, 64])
@pytest.mark.parametrize("P,K,shifted", [(3, 0, False), (4, 4, False), (5, 8, False),
                                         (8, 8, False), (4, 4, True), (5, 8, True)])
def test_kernel_blocks_on_the_host_match_the_plain_versions(host_lib, threads, P, K, shifted):
    cfg, _rng, st, ib, delta = seeded(P * 100 + K + shifted, P, 16, K=max(K, 1))
    want = J.rebase(J.RaftTensors(**{f: jnp.asarray(a) for f, a in st.items()}), delta)
    jr = jax_resid_rebase(J.Inbox(**{f: jnp.asarray(a) for f, a in ib.items()}), delta)
    ts, tr = run_host(host_lib, st, ib if K else None, delta, threads, shifted)
    assert cfg.groups % 32 and ts.match.shape[1] == P
    assert_same(want, ts)
    if K:
        assert_same(jr, tr)
        # and the port's plain versions, on the same inputs
        pr = state_from_numpy(ib, device="cpu")
        TV.rebase_resid(pr, torch.from_numpy(delta))
        for f in pr._fields:
            assert torch.equal(getattr(pr, f), getattr(tr, f)), f


@pytest.mark.parametrize("k", [1, 8], ids=["k1", "k8"])
def test_kernel_on_the_host_repeats_the_engines_rebases(host_lib, engine_runs, k):
    """Each engine's first rebase and, at K=8, its first that found parked
    rows (K=1 keeps no residual inbox), once more on the host from the
    state before it: every plane as the engine left it."""
    for pkg in ("dragonboat_tpu", "dragonboat_tpu_torch"):
        run = engine_runs[(pkg, k)]
        assert (run["first_parked"] is None) == (k == 1)
        for got in filter(None, (run["first"], run["first_parked"])):
            (st, ib), delta, (want_st, want_ib) = got
            ts, tr = run_host(host_lib, st, ib, delta, 352)
            assert (tr is None) == (k == 1)
            for want, have in ((want_st, ts), (want_ib, tr)):
                for f, a in (want or {}).items():
                    assert np.array_equal(getattr(have, f).numpy(), a), (pkg, f)


def test_cuda_call_raises_and_never_runs_the_plain_version(monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("a plain version ran for a CUDA-typed call")

    def broken_loader(src):
        raise RuntimeError(f"nvcc failed on {src}")

    monkeypatch.setattr(TV, "rebase", plain)
    monkeypatch.setattr(TV, "rebase_resid", plain)
    monkeypatch.setattr(cuda, "_lib", broken_loader)

    class Plane:
        device = torch.device("cuda", 0)

    s = types.SimpleNamespace(term=Plane())
    TV.REBASES.update(calls=0, with_resid=0)
    launches = cuda.LAUNCHES["rebase"]
    for resid in (None, types.SimpleNamespace()):
        with pytest.raises(RuntimeError, match="nvcc failed on"):
            TV.rebase_lanes(s, torch.zeros(4, dtype=torch.int32), resid)
    assert TV.REBASES == {"calls": 2, "with_resid": 1}
    assert cuda.LAUNCHES["rebase"] == launches


def test_rebase_params_refuse_what_the_kernel_does_not_take():
    cfg = T.KernelConfig(groups=4, peers=3, log_window=16, inbox_depth=4,
                         max_entries_per_msg=8, readindex_depth=4)
    s = T.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="delta"):
        cuda.rebase_params(s, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="delta"):
        cuda.rebase_params(s, torch.zeros(5, dtype=torch.int32))
    wide = T.make_empty_inbox(T.KernelConfig(groups=4, peers=3, log_window=16, inbox_depth=9,
                                             max_entries_per_msg=8, readindex_depth=4),
                              device="cpu")
    with pytest.raises(ValueError, match="at most 8"):
        cuda.rebase_params(s, torch.zeros(4, dtype=torch.int32), wide)


def test_chip_smoke_rebase_phase_on_cpu(monkeypatch):
    """chip_smoke.py's phase-3 rebase check rehearsed on the CPU at small
    shapes: its seeded states, residual inbox and deltas through the
    engine's call against the plain versions (the kernel runs only on the
    card)."""
    import chip_smoke
    from dragonboat_tpu_torch import kernel_bench as kb

    monkeypatch.setattr(chip_smoke, "REBASE_CASES",
                        ((64, 4, 256, 0), (100, 5, 32, 0), (64, 4, 256, 4), (40, 3, 16, 8)))
    r = chip_smoke.phase_rebase(cuda, kb, "cpu", device="cpu")
    assert r["cases"] == 4 and r["mismatched_fields"] == [] and r["max_abs_err"] == 0
    assert r["timed"] == {}
