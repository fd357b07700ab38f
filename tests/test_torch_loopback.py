"""The port's LoopbackCluster (plain step on the CPU) in lockstep with the
JAX package's, and four of tests/test_kernel.py's scenarios rerun on the
port."""
import numpy as np
import pytest

from dragonboat_tpu.ops.loopback import LoopbackCluster as JCluster
from dragonboat_tpu.ops.state import KernelConfig as JConfig
from dragonboat_tpu_torch.ops.loopback import LoopbackCluster as TCluster
from dragonboat_tpu_torch.ops.state import ROLE, KernelConfig as TConfig


def _assert_same(j, t, r):
    for h in range(j.n_replicas):
        for which, a_tree, b_tree in (("state", j.states[h], t.states[h]),
                                      ("output", j.last_outputs[h], t.last_outputs[h])):
            for f in a_tree._fields:
                a = np.asarray(getattr(a_tree, f))
                b = getattr(b_tree, f).numpy()
                assert a.dtype == b.dtype, (r, h, which, f)
                assert np.array_equal(a, b), (r, h, which, f, a, b)
        assert np.array_equal(j.counters[h], t.counters[h]), (r, h)
    assert j.ready_reads == t.ready_reads, r
    assert j.snapshot_requests == t.snapshot_requests, r


def test_lockstep_with_jax_under_faults():
    shape = dict(groups=6, peers=4, log_window=32, inbox_depth=4,
                 max_entries_per_msg=4, readindex_depth=4)
    kw = dict(n_replicas=3, n_groups=6, check_quorum=True, prevote=True,
              lease_read=True, lease_margin=1, seed=5)
    j = JCluster(cfg=JConfig(**shape), **kw)
    t = TCluster(cfg=TConfig(**shape), device="cpu", **kw)
    rng = np.random.default_rng(2024)
    both = (j, t)
    for r in range(100):
        if r % 10 == 4:  # seeded fault schedule: links, isolation, heal
            links = {(int(a), int(b)) for a, b in rng.integers(0, 3, (2, 2)) if a != b}
            for c in both:
                c.dropped_links = set(links)
        if r == 45:
            victim = int(rng.integers(0, 3))
            for c in both:
                c.isolated = {victim}
        if r == 60:
            for c in both:
                c.isolated = set()
        roles = np.stack([np.asarray(st.role) for st in j.states])
        for g in range(6):
            for h in range(3):
                if roles[h, g] != ROLE.LEADER:
                    continue
                if rng.random() < 0.3:
                    n = int(rng.integers(1, 5))
                    for c in both:
                        c.propose(h, g, n=n)
                if rng.random() < 0.3:
                    ctx = int(rng.integers(1, 1 << 20))
                    for c in both:
                        c.read_index(h, g, ctx=ctx, ctx_high=r)
                if r in (70, 85) and g % 2 == 0:
                    for c in both:
                        c.transfer_leader(h, g, (h + 1) % 3)
        tick = bool(rng.random() < 0.7)
        for c in both:
            c.step(tick=tick)
        _assert_same(j, t, r)
    assert any(t.ready_reads), "the schedule delivered no read"
    assert max(t.field("committed", g)[0] for g in range(6)) > 5


def make(n=3, groups=2, **kw):
    return TCluster(n_replicas=n, n_groups=groups, device="cpu", **kw)


def test_port_single_leader_emerges():
    c = make()
    c.run(30)
    for g in range(c.n_groups):
        roles = c.roles(g)
        assert roles.count(ROLE.LEADER) == 1, f"group {g}: {roles}"
        assert len(set(c.field("term", g))) == 1


def test_port_propose_commits_everywhere():
    c = make()
    c.run(30)
    lead = c.leader_of(0)
    c.propose(lead, 0, n=3)
    c.run(3)
    commits = c.field("committed", 0)
    lasts = c.field("last_index", 0)
    assert len(set(commits)) == 1
    assert commits[0] == lasts[0] == 4  # noop + 3 proposals
    t0 = c.ring_terms(0, 0, 1, 4)
    assert t0 == c.ring_terms(1, 0, 1, 4) == c.ring_terms(2, 0, 1, 4)


def test_port_readindex_quorum_roundtrip():
    c = make()
    c.run(30)
    lead = c.leader_of(0)
    c.read_index(lead, 0, ctx=4242)
    c.run(3)
    hits = [r for r in c.ready_reads[lead] if r[0] == 0 and r[1] == 4242]
    assert hits, f"no ready read: {c.ready_reads[lead]}"
    assert hits[0][2] == c.field("committed", 0)[lead]


def test_port_leader_transfer():
    c = make()
    c.run(30)
    lead = c.leader_of(0)
    target = [h for h in range(3) if h != lead][0]
    c.transfer_leader(lead, 0, target)
    c.run(8)
    assert c.leader_of(0) == target
    assert c.roles(0)[lead] != ROLE.LEADER


@pytest.mark.parametrize("bad", ["cuda", "cuda:0"])
def test_port_cluster_refuses_a_missing_card(monkeypatch, bad):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TCluster(n_replicas=3, n_groups=2, device=bad)
