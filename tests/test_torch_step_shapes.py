"""The step kernel's wrapper takes every shape from the tensors, as the
reference's step_batch does (G and P from s.member, K from inbox.mtype, R
from s.ri_ctx, W from s.log_term, E from inbox.entry_terms), so a lane
block of a larger fleet runs with the fleet's cfg — what the sharded
super-step does with each shard. Before the repair the wrapper read G, P,
K, R, W and E from cfg and refused such a block.

The host-built kernel (tests/test_torch_kernel_host.py) then steps lane
blocks of captured states with the fleet's cfg and equals the plain
version, and stacked (K, G, ...) output planes take step t's output in
their t-th slice.
"""
import ctypes

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.kernel_bench import random_inbox
from dragonboat_tpu_torch.ops import cuda, kernel as K
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy
from test_torch_kernel import _captured_states, _cfg
from test_torch_kernel_host import host_lib  # noqa: F401  (the g++-built kernel)

FLEET = T.KernelConfig(groups=8, peers=4, log_window=32, inbox_depth=4,
                       max_entries_per_msg=4, readindex_depth=4)


def _block(lanes):
    small = FLEET._replace(groups=lanes)
    return (T.init_state(small, device="cpu"), T.make_empty_inbox(small, device="cpu"),
            torch.zeros((lanes,), dtype=torch.int32), cuda.empty_output(small, "cpu"))


def test_make_params_takes_shapes_from_the_tensors():
    s, ib, ticks, out = _block(2)
    p = cuda.make_params(s, ib, ticks, out, FLEET)  # raised before the repair
    assert (p.G, p.P, p.W, p.K, p.E, p.R) == (2, 4, 32, 4, 4, 4)
    assert cuda.step_shapes(s, ib) == (2, 4, 32, 4, 4, 4)
    # tensors that disagree with each other are still refused
    with pytest.raises(ValueError, match="ticks must be"):
        cuda.make_params(s, ib, torch.zeros((8,), dtype=torch.int32), out, FLEET)
    with pytest.raises(ValueError, match=r"o_send_flags must be .*\(2, 4\)"):
        cuda.make_params(s, ib, ticks, cuda.empty_output(FLEET, "cpu"), FLEET)
    with pytest.raises(ValueError, match="in_entry_cc must be"):
        cuda.make_params(s, ib._replace(entry_cc=ib.entry_cc[:, :, :2].clone()), ticks,
                         out, FLEET)
    with pytest.raises(ValueError, match="inbox_depth <= 8"):
        big = T.make_empty_inbox(FLEET._replace(groups=2, inbox_depth=9), device="cpu")
        cuda.make_params(s, big, ticks, out, FLEET)


def test_stacked_output_slices_are_accepted():
    s, ib, ticks, _ = _block(2)
    outs = cuda._alloc_output(2, 4, 4, 4, "cpu", steps=3)
    assert tuple(outs.counters.shape) == (3, 2, T.CTR.COUNT)
    slice_t = T.StepOutput(*(x[2] for x in outs))
    p = cuda.make_params(s, ib, ticks, slice_t, FLEET)
    assert p.o_term == outs.term.data_ptr() + 2 * 2 * 4


@pytest.mark.parametrize("lanes", [2, 4])
def test_host_kernel_steps_a_lane_block_with_the_fleet_cfg(host_lib, lanes):  # noqa: F811
    P, E = 4, 8
    cfg = T.KernelConfig(**_cfg(P, E))  # the captured states' fleet: 16 lanes
    rng = np.random.default_rng(11)
    for st in _captured_states(P, E, dict(check_quorum=True), 3, 21)[:3]:
        block = {f: v[:lanes] for f, v in st.items()}
        ib = state_from_numpy(random_inbox(rng, block, cfg._replace(groups=lanes)), "cpu")
        ticks = torch.from_numpy(rng.integers(0, 3, lanes).astype(np.int32))
        ref_s, ref_o = K.step_batch_reference(state_from_numpy(block, "cpu"), ib, ticks, cfg)
        s = state_from_numpy(block, "cpu")
        out = cuda.empty_output(cfg._replace(groups=lanes), "cpu")
        # the kernel's block procedure at the card's block size, staged by
        # one warp's worth of threads
        bl = host_lib.step_batch_block_lanes()
        host_lib.step_batch_host(ctypes.byref(cuda.make_params(s, ib, ticks, out, cfg)), bl, bl)
        for a, b in ((ref_s, s), (ref_o, out)):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
