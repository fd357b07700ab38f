"""The port's tensor layout (dragonboat_tpu_torch.ops.state) against the JAX
package's: tables, init/configure/rebase field for field, the converter,
and the rule that an entry point without device= runs on the card only."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonboat_tpu.ops import state as J
from dragonboat_tpu_torch.ops import state as T
from dragonboat_tpu_torch.ops.convert import state_from_numpy, state_to_numpy

CFGS = [
    dict(groups=16, peers=4, log_window=32, inbox_depth=4, max_entries_per_msg=8,
         readindex_depth=4),
    dict(groups=5, peers=8, log_window=16, inbox_depth=8, max_entries_per_msg=1,
         readindex_depth=2),
]


def assert_tree_equal(jtree, ttree):
    assert tuple(ttree._fields) == tuple(jtree._fields)
    for f in jtree._fields:
        a = np.asarray(getattr(jtree, f))
        b = getattr(ttree, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["ROLE", "RSTATE", "MSG", "CTR"])
def test_tables_equal(name):
    j = {k: v for k, v in vars(getattr(J, name)).items() if k.isupper()}
    t = {k: v for k, v in vars(getattr(T, name)).items() if k.isupper()}
    assert j == t


def test_flags_and_names_equal():
    for k in ("SEND_REPLICATE", "SEND_HEARTBEAT", "SEND_VOTE_REQ",
              "SEND_TIMEOUT_NOW", "NEED_SNAPSHOT"):
        assert getattr(J, k) == getattr(T, k)
    assert J.CTR_NAMES == T.CTR_NAMES
    for kind in ("KernelConfig", "RaftTensors", "Inbox", "StepOutput"):
        assert getattr(J, kind)._fields == getattr(T, kind)._fields
    assert J.KernelConfig() == T.KernelConfig()


@pytest.mark.parametrize("cfg", CFGS, ids=["P4", "P8"])
def test_init_and_empty_inbox(cfg):
    assert_tree_equal(J.init_state(J.KernelConfig(**cfg)),
                      T.init_state(T.KernelConfig(**cfg), device="cpu"))
    assert_tree_equal(J.make_empty_inbox(J.KernelConfig(**cfg)),
                      T.make_empty_inbox(T.KernelConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("cfg", CFGS, ids=["P4", "P8"])
def test_configure_group(cfg):
    js = J.init_state(J.KernelConfig(**cfg))
    ts = T.init_state(T.KernelConfig(**cfg), device="cpu")
    P = cfg["peers"]
    calls = [
        dict(g=0, self_slot=1, voting_slots=[0, 1], observer_slots=[2],
             witness_slots=[3], election_timeout=7, heartbeat_timeout=2,
             check_quorum=True, prevote=True),
        dict(g=3, self_slot=3, voting_slots=[0, 1, 2], witness_slots=[3],
             is_witness=True, lease_read=True, lease_margin=2, election_timeout=13),
        dict(g=2, self_slot=2, voting_slots=[0, 1], observer_slots=[2],
             is_observer=True),
        dict(g=4, self_slot=0, voting_slots=[0], election_timeout=10),
    ]
    for c in calls:
        c = dict(c)
        c["observer_slots"] = [s for s in c.get("observer_slots", []) if s < P]
        js = J.configure_group(js, **c)
        ts = T.configure_group(ts, **c)
    assert_tree_equal(js, ts)


@pytest.mark.parametrize("cfg", CFGS, ids=["P4", "P8"])
@pytest.mark.parametrize("seed_offset", [0, 123456789])
def test_configure_groups_uniform(cfg, seed_offset):
    js = J.init_state(J.KernelConfig(**cfg))
    js = js._replace(seed=js.seed + np.uint32(seed_offset))
    ts = T.init_state(T.KernelConfig(**cfg), device="cpu")
    ts = ts._replace(seed=((ts.seed.to(torch.int64) + seed_offset) & 0xFFFFFFFF)
                     .to(torch.uint32))
    kw = dict(self_slot=1, voting_slots=(0, 1, 2), election_timeout=11,
              heartbeat_timeout=3, check_quorum=True, prevote=True,
              lease_read=True, lease_margin=1)
    assert_tree_equal(J.configure_groups_uniform(js, **kw),
                      T.configure_groups_uniform(ts, **kw))


def test_lane_seed_and_mix():
    rng = np.random.default_rng(7)
    for g in list(range(40)) + [2**20, 2**31 - 2]:
        assert T.lane_seed(g) == J.lane_seed(g)
    for a, b, c in rng.integers(-2**31, 2**32, size=(64, 3)).tolist():
        assert T._mix(a, b, c) == J._mix(a, b, c)
    a = rng.integers(0, 2**32, size=64)
    b = rng.integers(-2**31, 2**31, size=64)
    c = rng.integers(0, 8, size=64)
    got = T._mix_t(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got.tolist() == [J._mix(x, y, z) for x, y, z in zip(a, b, c)]


@pytest.mark.parametrize("cfg", CFGS, ids=["P4", "P8"])
def test_rebase(cfg):
    rng = np.random.default_rng(3)
    jcfg = J.KernelConfig(**cfg)
    js = J.init_state(jcfg)
    tree = {f: np.asarray(getattr(js, f)).copy() for f in js._fields}
    for f in ("first_index", "last_index", "committed", "processed", "applied",
              "unsaved_from", "match", "next", "snap_sent", "ri_index"):
        tree[f] = rng.integers(0, 200, size=tree[f].shape).astype(np.int32)
    delta = (rng.integers(0, 4, size=cfg["groups"]) * cfg["log_window"]).astype(np.int32)
    js = J.RaftTensors(**{k: jnp.asarray(v) for k, v in tree.items()})
    ts = state_from_numpy(tree, device="cpu")
    assert_tree_equal(J.rebase(js, delta), T.rebase(ts, delta))


def test_converter_round_trip_keeps_dtypes():
    cfg = J.KernelConfig(**CFGS[0])
    for jtree in (J.init_state(cfg), J.make_empty_inbox(cfg)):
        t = state_from_numpy(jtree, device="cpu")
        assert_tree_equal(jtree, t)
        back = state_to_numpy(t)
        for f in jtree._fields:
            a = np.asarray(getattr(jtree, f))
            assert back[f].dtype == a.dtype and np.array_equal(back[f], a)
    seed = state_from_numpy(J.init_state(cfg), device="cpu").seed
    assert seed.dtype == torch.uint32
    with pytest.raises(TypeError):
        state_from_numpy({"a": np.zeros(2)}, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    from dragonboat_tpu_torch.kernel_bench import bench_kernel
    from dragonboat_tpu_torch.ops.loopback import LoopbackCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.KernelConfig(**CFGS[0])
    for call in (
        lambda: T.init_state(cfg),
        lambda: T.make_empty_inbox(cfg),
        lambda: LoopbackCluster(n_groups=2),
        lambda: bench_kernel(16, 1, 1, 32),
        lambda: state_from_numpy(J.init_state(J.KernelConfig(**CFGS[0]))),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU is the only way onto it
    assert T.init_state(cfg, device="cpu").term.device.type == "cpu"
