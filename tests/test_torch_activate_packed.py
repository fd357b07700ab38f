"""Lane activation through its packed buffer (the port's
`engine.vector.pack_activation` and `activate_packed`, the layout of
`ops/cuda.py:activation_layout`, the kernel `csrc/activate.cu`) against the
JAX package's jitted `_make_activate_fn(cfg, n)`, on seeded states as
tests/test_torch_engine_activate.py builds them, every plane bit-equal:

- the packed path (the engine's packing, then `activate_packed` on the CPU,
  which reads the buffer through the layout) at buckets 1, 4, 16 and 64,
  padded by repeating the last lane, P in {3, 5}, W in {16, 32}, R 4;
- the layout's round trip: a packed buffer unpacks to the values it was
  packed from;
- the kernel's per-block code built as host C++ (g++; skipped without it)
  over every block and thread of a launch (each block's tile of lane rows
  loaded first, as its shared memory is on the card), with the parameter
  struct `ops/cuda.py` fills for the card, against
  `activate_packed_reference`: P 3-5, W 16-256, ragged last tiles, padding,
  scattered and consecutive rows, rows outside the state, and planes off
  their 16-byte boundaries;
- the engine's CPU bring-up of 3 x 16 groups through NodeHost: every batch
  the engine writes equals, plane for plane, what `activate_lanes_reference`
  writes for the same lanes and values on a copy of the state before it;
- on a CUDA-typed call, with the library loader made to fail, the wrappers
  raise and never run a plain version.
The kernel itself runs on the card in chip_smoke.py's phase 3."""
import copy
import ctypes
import shutil
import subprocess
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonboat_tpu.engine import vector as JV
from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.engine import vector as TV
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.ops import cuda
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from dragonboat_tpu_torch.ops.state import KernelConfig, init_state
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.transport.loopback import _Registry, loopback_factory
from test_torch_engine_activate import assert_same, seeded_tree


def seeded(seed, P, W, groups=80):
    cfg = J.KernelConfig(groups=groups, peers=P, log_window=W, inbox_depth=4,
                         max_entries_per_msg=8, readindex_depth=4)
    rng = np.random.default_rng(seed)
    arrays = seeded_tree(J.init_state(cfg), rng)
    return cfg, rng, arrays


def lane_values(rng, n, P, W):
    """n lanes' bring-up values as the engine's _compute_activation gives
    them: one dict per lane."""
    out = []
    for _ in range(n):
        v = {}
        for key, dt in cuda.ACT_COLUMNS:
            v[key] = bool(rng.random() < 0.5) if dt == torch.bool else int(rng.integers(0, 500))
        for key, dt in cuda.ACT_ROWS:
            w = W if key.startswith("log_") else P
            v[key] = (rng.random(w) < 0.5 if dt == torch.bool
                      else rng.integers(0, 500, w).astype(np.int32))
        out.append(v)
    return out


def padded_columns(rows, vals, bucket):
    """The batch as the JAX package's engine pads it: the rows and one
    array per value, the last lane repeated."""
    pad = bucket - len(vals)
    gi = np.asarray(rows + [rows[-1]] * pad, np.int32)
    cols = {}
    for key, dt in cuda.ACT_COLUMNS + cuda.ACT_ROWS:
        a = np.stack([np.asarray(x[key]) for x in vals]).astype(
            bool if dt == torch.bool else np.int32)
        cols[key] = np.concatenate([a, np.repeat(a[-1:], pad, 0)]) if pad else a
    return gi, cols


CASES = [(b, n, P, W) for P, W in ((3, 16), (5, 32), (3, 32), (5, 16))
         for b, n in ((1, 1), (4, 3), (16, 11), (64, 64), (64, 37))]


@pytest.mark.parametrize("bucket,n,P,W", CASES)
def test_packed_path_matches_jax(bucket, n, P, W):
    cfg, rng, arrays = seeded(bucket * 7 + n + P * W, P, W)
    rows = rng.choice(cfg.groups, n, replace=False).tolist()
    vals = lane_values(rng, n, P, W)
    gi, cols = padded_columns(rows, vals, bucket)
    js = J.RaftTensors(**{f: jnp.asarray(a) for f, a in arrays.items()})
    jout = JV._make_activate_fn(cfg, bucket)(
        js, jnp.asarray(gi), {k: jnp.asarray(a) for k, a in cols.items()})
    ts = state_from_numpy(arrays, device="cpu")
    host = TV.pack_activation(rows, vals, bucket, P, W)
    TV.ACTIVATIONS.clear()
    assert TV.activate_packed(ts, host, bucket) is ts
    assert TV.ACTIVATIONS == {bucket: 1}
    assert_same(jout, ts)


@pytest.mark.parametrize("bucket,n,P,W", CASES[:10])
def test_layout_round_trip(bucket, n, P, W):
    rng = np.random.default_rng(n * 31 + P)
    rows = rng.choice(1000, n, replace=False).tolist()
    vals = lane_values(rng, n, P, W)
    gi, cols = padded_columns(rows, vals, bucket)
    host = TV.pack_activation(rows, vals, bucket, P, W)
    got_rows, got = TV.unpack_activation(host, bucket, P, W)
    assert got_rows.dtype == torch.int32 and np.array_equal(got_rows.numpy(), gi)
    assert set(got) == set(cols)
    for k, a in cols.items():
        b = got[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape and np.array_equal(a, b), k
    # the layout's planes are 16-byte aligned and disjoint, in order
    spans, size = cuda.packed_spans(cuda.activation_layout(bucket, P, W))
    ends = [o + nb for *_x, o, nb in spans]
    assert all(o % 16 == 0 for *_x, o, _nb in spans) and ends[-1] <= size
    assert all(spans[i + 1][3] >= ends[i] for i in range(len(spans) - 1))


_HOST_MAIN = r"""
#include "activate.cu"

extern "C" int activate_host_params_size() { return (int)sizeof(ActivateParams); }
extern "C" int activate_host_tile() { return AC_TILE; }

// every block of a launch of `threads`-thread blocks: its first AC_TILE
// threads load the tile (the kernel's shared memory), then every thread
extern "C" void activate_host(const ActivateParams* p, int threads) {
  const int64_t blocks = (p->n + AC_TILE - 1) / AC_TILE;
  for (int64_t b = 0; b < blocks; ++b) {
    ActTile tile;
    for (int t = 0; t < AC_TILE; ++t) activate_tile_row(*p, b, t, tile);
    for (int t = 0; t < threads; ++t) activate_block(*p, b, t, threads, tile);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the host build of the activation kernel needs it")
    d = tmp_path_factory.mktemp("activate_host")
    src, lib = d / "host.cpp", d / "activate_host.so"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda.CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.activate_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert so.activate_host_params_size() == ctypes.sizeof(cuda.ActivateParams)
    assert so.activate_host_tile() == cuda.ACT_TILE
    return so


@pytest.mark.parametrize("threads", [256, 96, 384])
@pytest.mark.parametrize("bucket,n,P,W,G", [(1, 1, 3, 16, 80), (16, 11, 5, 32, 80),
                                            (64, 50, 4, 64, 80), (256, 200, 5, 256, 300)])
def test_kernel_blocks_on_the_host_match_the_plain_version(host_lib, threads, bucket, n, P,
                                                            W, G):
    _cfg, rng, arrays = seeded(G + n + threads, P, W, groups=G)
    rows = rng.choice(G, n, replace=False).tolist()
    vals = lane_values(rng, n, P, W)
    host = TV.pack_activation(rows, vals, bucket, P, W)
    want = TV.activate_packed_reference(state_from_numpy(arrays, device="cpu"), host,
                                        bucket)
    got = state_from_numpy(arrays, device="cpu")
    params = cuda.activate_params(got, host, bucket)
    # every plane but the two [W] planes is a scalar or row plane, ordered
    # by width (the scalars first); the [W] rows are W elements a lane
    assert params.n_small == len(cuda.ACT_SET) + len(cuda.ACT_ZERO) + 3 - 2
    widths = [params.small[q].width for q in range(params.n_small)]
    assert widths == sorted(widths) and widths[0] == 1 and max(widths) == max(P, 4)
    assert [params.window[q].row_bytes for q in (0, 1)] == [4 * W, W]
    host_lib.activate_host(ctypes.byref(params), threads)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def offset_view(t, k):
    """A contiguous copy of `t` that starts k elements into a buffer of its
    own: k=1 puts every row off its 16-, 8- and 4-byte boundaries."""
    flat = torch.empty(t.numel() + k, dtype=t.dtype)
    v = flat[k:].view(t.shape)
    v.copy_(t)
    return v


# the tile decomposition: P 4 and 5; W 16, 32 and 256; a bucket whose last
# tile is ragged (bucket % ACT_TILE != 0), with padding rows; lane rows
# scattered or consecutive (a bring-up's); rows outside [0, G) in the
# middle of the batch; and planes off their 16-byte boundaries
TILE_CASES = [(P, W, rows, bad, shifted) for P in (4, 5) for W in (16, 32, 256)
              for rows, bad, shifted in (("scattered", False, False),
                                         ("consecutive", False, False),
                                         ("scattered", True, False))] + [
    (4, 16, "consecutive", False, True), (5, 32, "scattered", True, True),
    (4, 256, "scattered", False, True)]


@pytest.mark.parametrize("P,W,order,out_of_range,shifted", TILE_CASES)
def test_kernel_tiles_on_the_host_match_the_plain_version(host_lib, P, W, order, out_of_range,
                                                           shifted):
    G, n, bucket = 120, 21, 29
    assert bucket % cuda.ACT_TILE and -(-bucket // cuda.ACT_TILE) == 4
    _cfg, rng, arrays = seeded(P * 1000 + W + 7 * out_of_range + 3 * shifted, P, W, groups=G)
    if order == "consecutive":
        start = int(rng.integers(0, G - n))
        rows = list(range(start, start + n))
    else:
        rows = rng.choice(G, n, replace=False).tolist()
    vals = lane_values(rng, n, P, W)
    host = TV.pack_activation(rows, vals, bucket, P, W)
    keep = list(range(n))
    if out_of_range:
        # rows 3 and 11 are made -1 and G in the buffer: they write nothing
        packed_rows = TV.unpack_activation(host, bucket, P, W)[0]
        packed_rows[3], packed_rows[11] = -1, G
        keep = [i for i in keep if i not in (3, 11)]
    want = state_from_numpy(arrays, device="cpu")
    TV.activate_packed_reference(
        want, TV.pack_activation([rows[i] for i in keep], [vals[i] for i in keep], len(keep),
                                 P, W), len(keep))
    got = state_from_numpy(arrays, device="cpu")
    assert torch.equal(TV.unpack_activation(host, bucket, P, W)[0][n:],
                       torch.full((bucket - n,), rows[-1], dtype=torch.int32))
    for threads in (384, 256, 96):
        work = type(got)(*(offset_view(t, 1) if shifted else t.clone() for t in got))
        host_lib.activate_host(ctypes.byref(cuda.activate_params(work, host, bucket)), threads)
        for f in work._fields:
            assert torch.equal(getattr(work, f), getattr(want, f)), (threads, f)


def test_kernel_skips_rows_outside_the_state(host_lib):
    """A lane row outside [0, G) writes nothing (JAX's scatter drops it)."""
    _cfg, rng, arrays = seeded(5, 3, 16, groups=8)
    vals = lane_values(rng, 2, 3, 16)
    host = TV.pack_activation([2, 8], vals, 4, 3, 16)
    TV.unpack_activation(host, 4, 3, 16)[0][2:] = -1
    got = state_from_numpy(arrays, device="cpu")
    host_lib.activate_host(ctypes.byref(cuda.activate_params(got, host, 4)), 64)
    want = state_from_numpy(arrays, device="cpu")
    one = TV.pack_activation([2], vals[:1], 1, 3, 16)
    TV.activate_packed_reference(want, one, 1)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_activate_params_refuse_a_window_that_is_not_a_power_of_two():
    cfg = KernelConfig(groups=4, peers=3, log_window=24, inbox_depth=4,
                       max_entries_per_msg=8, readindex_depth=4)
    s = init_state(cfg, device="cpu")
    vals = lane_values(np.random.default_rng(1), 1, 3, 24)
    with pytest.raises(ValueError, match="power of two"):
        cuda.activate_params(s, TV.pack_activation([0], vals, 1, 3, 24), 1)


class Counter(IStateMachine):
    def __init__(self, *a):
        self.n = 0

    def update(self, data):
        self.n += 1
        return Result(value=self.n)

    def lookup(self, q):
        return self.n

    def save_snapshot(self, w, fc, done):
        w.write(b"\0")

    def recover_from_snapshot(self, r, fc, done):
        r.read()

    def close(self):
        pass


def test_engine_bring_up_matches_the_plain_activation(tmp_path, monkeypatch):
    """3 hosts x 16 groups on one core, each host starting its groups in one
    start_clusters call: every batch the engine writes through the packed
    buffer equals the plain activation of the same lanes and values on a
    copy of the shard's state just before it."""
    compared = []
    original = TV.VectorEngine._activate_rows

    def held(self, sh, rows, vals):
        before = copy.deepcopy(sh.state)
        gi, cols = padded_columns(rows, vals, TV.activation_bucket(len(vals), sh.hi - sh.lo))
        want = TV.activate_lanes_reference(
            before, torch.from_numpy(gi), {k: torch.from_numpy(a) for k, a in cols.items()})
        original(self, sh, rows, vals)
        compared.append((len(rows), [f for f in want._fields
                                     if not torch.equal(getattr(want, f),
                                                        getattr(sh.state, f))]))

    monkeypatch.setattr(TV.VectorEngine, "_activate_rows", held)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reg = _Registry()
    addrs = {i: f"ap{i}:1" for i in (1, 2, 3)}
    hosts = {}
    try:
        for i in addrs:
            hosts[i] = NodeHost(NodeHostConfig(
                deployment_id=23, rtt_millisecond=50, raft_address=addrs[i],
                nodehost_dir=str(tmp_path / f"nh{i}"),
                raft_rpc_factory=lambda l: loopback_factory(l, reg),
                engine=EngineConfig(kind="vector", max_groups=48, max_peers=4, log_window=32,
                                    device="cpu", share_scope="activate-packed")))
        for i, nh in hosts.items():
            nh.start_clusters([(dict(addrs), False, lambda c, nid: Counter(),
                                Config(cluster_id=c, node_id=i, election_rtt=10,
                                       heartbeat_rtt=2)) for c in range(1, 17)])
        deadline = time.time() + 90
        while time.time() < deadline and not all(
                hosts[1].get_leader_id(c)[1] for c in range(1, 17)):
            time.sleep(0.05)
        assert all(hosts[1].get_leader_id(c)[1] for c in range(1, 17))
    finally:
        for nh in hosts.values():
            nh.stop()
        torch.set_num_threads(threads)
    assert sum(n for n, _ in compared) == 48, compared
    assert [bad for _, bad in compared if bad] == []


def _fake_cuda_state(P=3, W=16):
    """A stand-in state whose planes claim the card: enough for the
    wrappers to take their CUDA branch on this box."""
    class Plane:
        device = torch.device("cuda", 0)

    s = types.SimpleNamespace(term=Plane(), member=torch.zeros((4, P), dtype=torch.bool),
                              log_term=torch.zeros((4, W), dtype=torch.int32))
    return s


def test_cuda_call_raises_and_never_runs_the_plain_version(monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA-typed call")

    def broken_loader(src):
        raise RuntimeError(f"nvcc failed on {src}")

    monkeypatch.setattr(TV, "activate_lanes_reference", plain)
    monkeypatch.setattr(TV, "activate_packed_reference", plain)
    monkeypatch.setattr(cuda, "_lib", broken_loader)
    s = _fake_cuda_state()
    host = TV.pack_activation([0], lane_values(np.random.default_rng(0), 1, 3, 16), 1, 3, 16)
    with pytest.raises(RuntimeError, match="nvcc failed on"):
        TV.activate_packed(s, host, 1)
    # activate_lanes packs on the state's device, then goes through
    # activate_packed: its buffer is made on the host here (this box has no
    # card) so the call reaches the loader
    rows, v = TV.unpack_activation(host, 1, 3, 16)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: empty(*a, **kw))
    with pytest.raises(RuntimeError, match="nvcc failed on"):
        TV.activate_lanes(s, rows, v)


def test_engine_state_after_activation_is_not_the_init_state():
    """The packed path writes: a sanity check that a one-lane batch moves
    every plane it owns away from init_state's values where the values
    differ."""
    cfg = KernelConfig(groups=4, peers=3, log_window=16, inbox_depth=4,
                         max_entries_per_msg=8, readindex_depth=4)
    s = init_state(cfg, device="cpu")
    vals = lane_values(np.random.default_rng(3), 1, 3, 16)
    vals[0].update(term=7, first_index=5, next=9)
    TV.activate_packed(s, TV.pack_activation([2], vals, 1, 3, 16), 1)
    assert bool(s.active[2]) and int(s.term[2]) == 7 and int(s.first_index[2]) == 5
    assert s.next[2].tolist() == [9, 9, 9] and not bool(s.active[1])


def test_chip_smoke_activation_phase_on_cpu(monkeypatch):
    """chip_smoke.py's activation check rehearsed on the CPU at small
    shapes: its seeded states, batches and padding through the packed path
    and activate_lanes against the plain version (the kernel runs only on
    the card)."""
    import chip_smoke
    from dragonboat_tpu_torch import kernel_bench as kb

    monkeypatch.setattr(chip_smoke, "ACT_CASES", ((64, 4, 32, (1, 16, 64)), (100, 5, 16, (64, 256))))
    monkeypatch.setattr(chip_smoke, "ACT_HOST_LANES", 16)
    r = chip_smoke.phase_activation(cuda, kb, "cpu", device="cpu")
    assert r["cases"] == 5 and r["mismatched_fields"] == [] and r["max_abs_err"] == 0
    assert r["timed"] == {}
