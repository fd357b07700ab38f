"""The CUDA kernel's per-lane code, built as host C++, against the port's
plain step_batch, exact on every state field and StepOutput plane.

`csrc/step_batch.cu` compiles as plain C++ too (its `DB_DEV` functions are
`static inline` without nvcc), so g++ builds the kernel's block procedure
into a small shared library here: for each block of lanes, the staging of
the block's spans into a frame (a host buffer filled with garbage first),
`step_lane` for every lane against that frame, and the write-back, with
the same `StepParams` struct the card's launcher takes. The staging runs
as `nt` emulated threads one after another. This holds the kernel's logic,
its frame layout and its staging against the plain version on the CPU, at
the card's block size and at a small one that leaves a ragged last block;
the launch itself, and the same comparison on the card, are in
`chip_smoke.py`.

States come from the seeded JAX LoopbackCluster runs of
tests/test_torch_kernel.py (faults, pre-vote, check-quorum, leases,
witnesses, observers), perturbed, and stepped with seeded random inboxes.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.kernel_bench import random_inbox
from dragonboat_tpu_torch.ops import cuda, kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from test_torch_kernel import CASES, G, _captured_states, _cfg, _perturb

_HOST_MAIN = r"""
#include <stdlib.h>
#include "step_batch.cu"

extern "C" int step_batch_host_params_size() { return (int)sizeof(StepParams); }

// the kernel's block procedure over every block of `bl` lanes, the staging
// done by `nt` threads in turn
extern "C" void step_batch_host(const StepParams* p, int bl, int nt) {
  const size_t bytes = frame_bytes(p->P, p->K, p->R, bl);
  void* mem = aligned_alloc(16, (bytes + 15) & ~(size_t)15);
  for (int g0 = 0; g0 < p->G; g0 += bl) {
    memset(mem, 0xA5, bytes);  // a row the staging misses shows up
    const Frame F = frame_of(*p, mem, bl, g0);
    for (int t = 0; t < nt; ++t) stage_in(*p, F, t, nt);
    for (int l = 0; l < F.nl; ++l) step_lane(*p, F, l);
    for (int t = 0; t < nt; ++t) write_back(*p, F, t, nt);
  }
  free(mem);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel needs it")
    d = tmp_path_factory.mktemp("step_batch_host")
    src, lib = d / "host.cpp", d / "step_batch_host.so"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", cuda.CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.step_batch_host.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    so.step_batch_host.restype = None
    so.step_batch_block_lanes.restype = ctypes.c_int
    assert so.step_batch_host_params_size() == ctypes.sizeof(cuda.StepParams)
    return so


def _run_host(so, s, inbox, ticks, cfg, fill, bl, nt):
    out = cuda.empty_output(cfg, "cpu")
    for t in out:  # an element the kernel forgets to write shows up
        if t.dtype == torch.bool:
            t.fill_(bool(fill))
        else:
            t.view(torch.int32).fill_(fill)
    params = cuda.make_params(s, inbox, ticks, out, cfg)
    so.step_batch_host(ctypes.byref(params), bl, nt)
    return s, out


def _check_lane_code(so, P, E, opts, n, bl, nt):
    seed = 100 * P + E
    rng = np.random.default_rng(seed + 7)
    cfg = T.KernelConfig(**_cfg(P, E))
    cases = 0
    for i, st in enumerate(_captured_states(P, E, opts, n, seed)):
        for perturbed in (False, True):
            s = _perturb(rng, st, cfg.readindex_depth) if perturbed else st
            ib = state_from_numpy(random_inbox(rng, s, cfg), device="cpu")
            ticks = torch.from_numpy(rng.integers(0, 3, G).astype(np.int32))
            ref_s, ref_o = K.step_batch_reference(state_from_numpy(s, "cpu"), ib, ticks, cfg)
            for fill in (-1431655766, 0):
                ker_s, ker_o = _run_host(so, state_from_numpy(s, "cpu"), ib,
                                         ticks, cfg, fill, bl, nt)
                for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
                    for f in a._fields:
                        x, y = getattr(a, f), getattr(b, f)
                        assert x.dtype == y.dtype, (what, f, i)
                        assert torch.equal(x, y), (what, f, i, perturbed, fill)
            cases += 1
    assert cases >= 2


@pytest.mark.parametrize("P,E,opts,n", CASES, ids=[f"P{c[0]}-E{c[1]}" for c in CASES])
def test_kernel_lane_code_matches_plain_version(host_lib, P, E, opts, n):
    """At the card's block size, staged by 8 warps' worth of threads."""
    bl = host_lib.step_batch_block_lanes()
    _check_lane_code(host_lib, P, E, opts, n, bl, 8 * bl)


@pytest.mark.parametrize("P,E,opts,n", CASES, ids=[f"P{c[0]}-E{c[1]}" for c in CASES])
def test_kernel_lane_code_at_a_small_block_size(host_lib, P, E, opts, n):
    """Blocks of 5 lanes staged by 3 threads: 16 lanes make three full
    blocks and a ragged one of a single lane."""
    _check_lane_code(host_lib, P, E, opts, n, 5, 3)


def test_kernel_lane_code_at_odd_widths(host_lib):
    """P = 3 peers, K = 3 inbox slots, R = 3 read slots: rows that are not
    whole 16-byte words (the element-wise row moves) and u8 rows that start
    off a 4-byte boundary. Twelve steps of seeded random inboxes from three
    lanes' configurations, held against the plain version after each, in
    blocks of 32 and of 5 lanes."""
    cfg = T.KernelConfig(groups=G, peers=3, log_window=16, inbox_depth=3,
                         max_entries_per_msg=5, readindex_depth=3)
    rng = np.random.default_rng(33)
    s = T.init_state(cfg, device="cpu")
    for g in range(G):
        T.configure_group(s, g, self_slot=g % 3, voting_slots=(0, 1, 2), election_timeout=4,
                          check_quorum=g % 2 == 0, prevote=g % 4 == 1)
    for step in range(12):
        npst = {f: getattr(s, f).numpy() for f in T.RaftTensors._fields}
        ib = state_from_numpy(random_inbox(rng, npst, cfg), device="cpu")
        ticks = torch.from_numpy(rng.integers(0, 3, G).astype(np.int32))
        ref_s, ref_o = K.step_batch_reference(K.clone_state(s), ib, ticks, cfg)
        for bl, nt in ((host_lib.step_batch_block_lanes(), 32), (5, 3)):
            ker_s, ker_o = _run_host(host_lib, K.clone_state(s), ib, ticks, cfg, 0, bl, nt)
            for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
                for f in a._fields:
                    assert torch.equal(getattr(a, f), getattr(b, f)), (what, f, step, bl)
        s = ref_s
    assert int(s.term.max()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_kernel_pending_appends_match_the_ring_writes(host_lib, seed):
    """The kernel keeps a leader's appends pending and writes them to the
    ring row once per step. Inboxes heavy in proposals (some with config
    changes, some with negative n_entries), elections, replicates, votes
    and responses whose log indexes reach past the log (so a leader reads
    the term of a ring slot its pending run maps to), on a ring of W = 8
    slots that fills and overflows, with
    single-voter lanes that lead at once and three-voter lanes that change
    terms: after each of 24 steps the ring and every other field equal the
    plain version's."""
    cfg = T.KernelConfig(groups=G, peers=3, log_window=8, inbox_depth=6,
                         max_entries_per_msg=5, readindex_depth=2)
    rng = np.random.default_rng(800 + seed)
    s = T.init_state(cfg, device="cpu")
    for g in range(G):
        voters = (g % 3,) if g % 2 else (0, 1, 2)
        T.configure_group(s, g, self_slot=g % 3, voting_slots=voters, election_timeout=3,
                          check_quorum=g % 4 == 0)
    kinds = np.array([T.MSG.PROPOSE] * 6 + [T.MSG.ELECTION, T.MSG.REPLICATE,
                                            T.MSG.REPLICATE_RESP, T.MSG.HEARTBEAT_RESP,
                                            T.MSG.REQUEST_VOTE_RESP, T.MSG.REQUEST_VOTE,
                                            T.MSG.HEARTBEAT, T.MSG.NONE], np.int32)
    leaders = overflow = cc = 0
    for step in range(24):
        npst = {f: getattr(s, f).numpy() for f in T.RaftTensors._fields}
        ib = random_inbox(rng, npst, cfg)
        shape = ib["mtype"].shape
        ib["mtype"] = rng.choice(kinds, size=shape).astype(np.int32)
        ib["term"] = np.where(ib["mtype"] == T.MSG.PROPOSE, 0, ib["term"]).astype(np.int32)
        ib["n_entries"] = rng.integers(-2, cfg.max_entries_per_msg + 1, size=shape).astype(np.int32)
        ib["entry_cc"] = rng.random(ib["entry_cc"].shape) < 0.05
        ib = state_from_numpy(ib, device="cpu")
        ticks = torch.from_numpy(rng.integers(0, 2, G).astype(np.int32))
        ref_s, ref_o = K.step_batch_reference(K.clone_state(s), ib, ticks, cfg)
        for bl, nt in ((host_lib.step_batch_block_lanes(), 32), (5, 3)):
            ker_s, ker_o = _run_host(host_lib, K.clone_state(s), ib, ticks, cfg, 0, bl, nt)
            for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
                for f in a._fields:
                    assert torch.equal(getattr(a, f), getattr(b, f)), (what, f, step, bl)
        s = ref_s
        leaders += int((s.role == T.ROLE.LEADER).sum())
        overflow += int((s.last_index - s.first_index + 1 > cfg.log_window).sum())
        cc += int(s.log_is_cc.sum())
    # the run reached what the test is about: leaders, overflowing windows
    # and config-change entries in the ring
    assert leaders > 0 and overflow > 0 and cc > 0, (leaders, overflow, cc)


@pytest.mark.parametrize("W", [64, 62])
def test_kernel_replicate_copies_wide_runs(host_lib, W):
    """Replicate-heavy inboxes with up to E = 40 entries a message: the
    copy into the ring stores 16-byte words of terms and 4-byte words of cc
    flags where the ring row allows (W = 62 puts the cc row off 4-byte
    alignment on every other lane). Sixteen steps, each held against the
    plain version."""
    cfg = T.KernelConfig(groups=G, peers=3, log_window=W, inbox_depth=4,
                         max_entries_per_msg=40, readindex_depth=2)
    rng = np.random.default_rng(900 + W)
    s = T.init_state(cfg, device="cpu")
    for g in range(G):
        T.configure_group(s, g, self_slot=g % 3, voting_slots=(0, 1, 2), election_timeout=40)
    kinds = np.array([T.MSG.REPLICATE] * 5 + [T.MSG.HEARTBEAT, T.MSG.PROPOSE, T.MSG.NONE],
                     np.int32)
    longest = 0
    for step in range(16):
        npst = {f: getattr(s, f).numpy() for f in T.RaftTensors._fields}
        ib = random_inbox(rng, npst, cfg)
        ib["mtype"] = rng.choice(kinds, size=ib["mtype"].shape).astype(np.int32)
        ib = state_from_numpy(ib, device="cpu")
        ticks = torch.zeros((G,), dtype=torch.int32)
        ref_s, ref_o = K.step_batch_reference(K.clone_state(s), ib, ticks, cfg)
        ker_s, ker_o = _run_host(host_lib, K.clone_state(s), ib, ticks, cfg, 0,
                                 host_lib.step_batch_block_lanes(), 32)
        for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (what, f, step)
        longest = max(longest, int((ref_s.last_index - s.last_index).max()))
        s = ref_s
    assert longest >= 32, longest  # some lane took a run of many whole words


def test_kernel_pending_run_seen_by_an_aliased_ring_read(host_lib):
    """A three-voter leader at term 3 with entries 1..5 in a ring of W = 8
    proposes 2 entries (pending, slots 6 and 7) and hears peer 1 acknowledge
    index 14: peer 1's next passes the log, the commit moves to 7, and the
    Replicate to peer 1 carries the term of index 14, which is ring slot 6,
    the slot the pending run covers and the ring row still holds stale."""
    cfg = T.KernelConfig(groups=2, peers=3, log_window=8, inbox_depth=2,
                         max_entries_per_msg=4, readindex_depth=2)
    s = T.init_state(cfg, device="cpu")
    for g in range(2):
        T.configure_group(s, g, self_slot=0, voting_slots=(0, 1, 2), election_timeout=50)
    s.role[:] = T.ROLE.LEADER
    s.term[:] = 3
    s.leader[:] = 1
    s.first_index[:] = 1
    s.last_index[:] = 5
    s.committed[:] = s.processed[:] = s.applied[:] = 4
    s.unsaved_from[:] = 6
    s.log_term[:] = 99  # stale slots
    s.log_term[:, 1:6] = 3
    s.match[:] = torch.tensor([5, 4, 0], dtype=torch.int32)
    s.next[:] = torch.tensor([6, 5, 1], dtype=torch.int32)
    s.rstate[:] = 1  # RETRY
    ib = T.make_empty_inbox(cfg, device="cpu")
    ib.mtype[:, 0] = T.MSG.PROPOSE
    ib.n_entries[:, 0] = 2
    ib.mtype[:, 1] = T.MSG.REPLICATE_RESP
    ib.from_slot[:, 1] = 1
    ib.term[:, 1] = 3
    ib.log_index[:, 1] = 14
    ticks = torch.zeros((2,), dtype=torch.int32)
    ref_s, ref_o = K.step_batch_reference(K.clone_state(s), ib, ticks, cfg)
    assert int(ref_s.committed[0]) == 7 and int(ref_o.send_prev_index[0, 1]) == 14
    assert int(ref_o.send_prev_term[0, 1]) == 3  # slot 6 as the proposal wrote it
    for bl, nt in ((host_lib.step_batch_block_lanes(), 32), (1, 1)):
        ker_s, ker_o = _run_host(host_lib, K.clone_state(s), ib, ticks, cfg, 0, bl, nt)
        for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (what, f, bl)


def test_frame_fits_the_launch_without_opting_in(host_lib):
    """The widest frame the wrapper admits stays under the 48 KB of dynamic
    shared memory a launch gets by default."""
    host_lib.step_batch_frame_bytes.restype = ctypes.c_longlong
    bl = host_lib.step_batch_block_lanes()
    widest = host_lib.step_batch_frame_bytes(cuda.PMAX, cuda.KMAX, cuda.RMAX, bl)
    assert widest == bl * ((11 * 8 + 7 * 4 + 9 * 8 + 8 + 4) * 4 + 7 * 8 + 8)  # 16-byte multiple
    assert widest <= 48 * 1024


def test_make_params_refuses_mixed_devices_and_layouts():
    cfg = T.KernelConfig(**_cfg(4, 1))
    s = T.init_state(cfg, device="cpu")
    ib = T.make_empty_inbox(cfg, device="cpu")
    ticks = torch.zeros(G, dtype=torch.int32)
    out = cuda.empty_output(cfg, "cpu")
    cuda.make_params(s, ib, ticks, out, cfg)
    with pytest.raises(ValueError, match="must be torch.int32"):
        cuda.make_params(s, ib, ticks.to(torch.int64), out, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        bad = s._replace(match=s.match.t().contiguous().t())
        cuda.make_params(bad, ib, ticks, out, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda.prepare_step(s, ib, ticks, cfg)


def test_step_bytes_counts_only_what_the_step_needs():
    from dragonboat_tpu_torch.kernel_bench import step_bytes

    cfg = T.KernelConfig(**_cfg(4, 8))
    Kd, E = cfg.inbox_depth, cfg.max_entries_per_msg
    s = T.init_state(cfg, device="cpu")
    ticks = torch.zeros(G, dtype=torch.int32)
    out = cuda.empty_output(cfg, "cpu")
    empty = T.make_empty_inbox(cfg, device="cpu")
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    state_b = nb(getattr(s, f) for f in T.RaftTensors._fields
                 if f not in ("log_term", "log_is_cc"))
    slot_b = nb(getattr(empty, f) for f in T.Inbox._fields
                if f not in ("entry_terms", "entry_cc"))
    base = slot_b + nb([ticks]) + state_b + nb(out) + 3 * 4 * G
    assert step_bytes(s, empty, ticks, out, s) == base

    def inbox(mtype, nent):
        return empty._replace(mtype=torch.full_like(empty.mtype, mtype),
                              n_entries=torch.full_like(empty.n_entries, nent))

    # entry planes: nothing for a heartbeat, the cc flags of a PROPOSE,
    # term + cc of a REPLICATE; n_entries past E reads E entries
    assert step_bytes(s, inbox(T.MSG.HEARTBEAT, E), ticks, out, s) == base
    assert step_bytes(s, inbox(T.MSG.PROPOSE, E), ticks, out, s) == base + G * Kd * E
    assert step_bytes(s, inbox(T.MSG.REPLICATE, E + 3), ticks, out, s) == base + 5 * G * Kd * E
    # state writes: only the elements that changed; appends write the ring
    after = s._replace(term=s.term.clone(), seed=s.seed.clone(),
                       last_index=s.last_index.clone())
    after.term[:3] += 1
    after.seed.view(torch.int32)[:2] ^= 1
    after.last_index[0] += 7
    assert step_bytes(s, empty, ticks, out, after) == base + 4 * 3 + 4 * 2 + 4 + 7 * 5


def test_router_and_gather_bytes_count_the_record():
    """The router's and the gather's byte bounds count the candidate
    record: its 11 header rows and one entry run per Replicate (E terms
    and ceil(E/4) cc words), and for the scatter 10 header words per
    accepted candidate plus 5 B per live entry of an accepted Replicate."""
    from dragonboat_tpu_torch import kernel_bench as kb

    cfg = T.KernelConfig(groups=6, peers=4, log_window=16, inbox_depth=3,
                         max_entries_per_msg=5, readindex_depth=2)
    Gc, P, Kd, R, E = 6, 4, 3, 2, 5
    Ml = Gc * (4 * P + Kd + R)
    L = 11 * Ml + Gc * P * (E + 2)
    assert K.entry_words(E) == 7 and K.entry_words(64) == 80
    assert K.record_words(Gc, cfg) == L
    out = cuda.empty_output(cfg, "cpu")
    for t in out:
        t.zero_()
    route = torch.full((Gc, P), -1, dtype=torch.int32)
    nb = lambda t: t.numel() * t.element_size()
    planes = sum(nb(getattr(out, f)) for f in cuda._COL_OUT) + 4 * Gc + 2 * nb(route)
    base = planes + 4 * L + Ml
    assert kb.route_columns_bytes(out, route, cfg) == base
    # 5 B per live ring entry of a wanted Replicate, n_entries clipped to E
    out.send_flags[0, 1] = T.SEND_REPLICATE
    out.send_n_entries[0, 1] = E + 3
    out.send_flags[1, 2] = T.SEND_REPLICATE | T.SEND_HEARTBEAT
    out.send_n_entries[1, 2] = 2
    out.send_n_entries[2, 0] = 4  # not a Replicate: no entries read
    route[0, 1], route[1, 2], route[2, 0] = 3, 4, 5
    assert kb.route_columns_bytes(out, route, cfg) == base + 5 * (E + 2)

    nxt = cuda._alloc_inbox(Gc, Kd, E, "cpu")
    for t in nxt:
        t.zero_()
    nxt.mtype.fill_(T.MSG.NONE)
    inbox_b = sum(nb(t) for t in nxt)
    assert kb.route_index_bytes(2, Ml) == 8 * Ml
    assert kb.route_scatter_bytes(2, Ml, 0, nxt, cfg) == 8 * Ml + inbox_b
    nxt.mtype[0, 0], nxt.n_entries[0, 0] = T.MSG.REPLICATE, E + 1
    nxt.mtype[1, 2], nxt.n_entries[1, 2] = T.MSG.REPLICATE, 3
    nxt.mtype[2, 1], nxt.n_entries[2, 1] = T.MSG.HEARTBEAT, 9
    assert kb.route_scatter_bytes(2, Ml, 3, nxt, cfg) == (
        8 * Ml + 40 * 3 + 5 * (E + 3) + inbox_b + 3)
    assert kb.route_scatter_bytes(2, Ml, 3, nxt, cfg, plan_bits=1) == (
        8 * Ml + 40 * 3 + 5 * (E + 3) + inbox_b + 1)
    assert kb.ring_gather_bytes(4, L) == 4 * 4 * L + 4 * 16 * L
