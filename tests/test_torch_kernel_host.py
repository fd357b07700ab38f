"""The CUDA kernel's per-lane code, built as host C++, against the port's
plain step_batch, exact on every state field and StepOutput plane.

`csrc/step_batch.cu` compiles as plain C++ too (its `DB_DEV` functions are
`static inline` without nvcc), so g++ builds `step_lane` into a small
shared library here and a host loop runs it over every lane with the same
`StepParams` struct the card's launcher takes. This holds the kernel's
logic against the plain version on the CPU; the launch itself, and the
same comparison on the card, are in `chip_smoke.py`.

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
#include "step_batch.cu"

extern "C" int step_batch_host_params_size() { return (int)sizeof(StepParams); }

extern "C" void step_batch_host(const StepParams* p) {
  for (int g = 0; g < p->G; ++g) step_lane(*p, g);
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
    so.step_batch_host.argtypes = [ctypes.c_void_p]
    so.step_batch_host.restype = None
    assert so.step_batch_host_params_size() == ctypes.sizeof(cuda.StepParams)
    return so


def _run_host(so, s, inbox, ticks, cfg, fill):
    out = cuda.empty_output(cfg, "cpu")
    for t in out:  # an element the kernel forgets to write shows up
        if t.dtype == torch.bool:
            t.fill_(bool(fill))
        else:
            t.view(torch.int32).fill_(fill)
    params = cuda.make_params(s, inbox, ticks, out, cfg)
    so.step_batch_host(ctypes.byref(params))
    return s, out


@pytest.mark.parametrize("P,E,opts,n", CASES, ids=[f"P{c[0]}-E{c[1]}" for c in CASES])
def test_kernel_lane_code_matches_plain_version(host_lib, P, E, opts, n):
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
                ker_s, ker_o = _run_host(host_lib, state_from_numpy(s, "cpu"), ib,
                                         ticks, cfg, fill)
                for what, a, b in (("state", ref_s, ker_s), ("out", ref_o, ker_o)):
                    for f in a._fields:
                        x, y = getattr(a, f), getattr(b, f)
                        assert x.dtype == y.dtype, (what, f, i)
                        assert torch.equal(x, y), (what, f, i, perturbed, fill)
            cases += 1
    assert cases >= 2


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
