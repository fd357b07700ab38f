"""A follower's host-side catch-up (ROADMAP §3 fault 6), through both
packages (tests/torch_catchup.py). The leader logged "peer N needs a
snapshot but none exists" while a group stranded; two ways lead there.

A catch-up Replicate lost on the way used to leave the catch-up waiting for
an ack that never came: after two election timeouts it fell to the
snapshot path, found no snapshot and waited out the snapshot feedback's
retry, six election timeouts for each lost message. The recipe: three
hosts on one core with a 32-entry log window, clients that resubmit
whenever a proposal times out, a seeded FaultPlane dropping 30% of
co-hosted messages and one host stalled (partitioned) for seeded windows
of 0.5-1.5 s over 8 s. The port resends from the follower's match after two
heartbeats with neither a send nor an ack (`VectorEngine._run_catchups`).

A follower below the window base (the second test) was never caught up at
all: the device keeps no match there, and the catch-up took that for the
base. The port takes the follower's progress below the base from its acks
and its rejects' hints (`_pack_wire`, `_below_window_reject`).

Both packages must have every group commit again within 30 s after the
storm with their replicas converged; the port must never take the
snapshot path without a snapshot (the reference's count is printed)."""
import pytest

import torch_catchup as C
from torch_twin import one_thread  # noqa: F401

PORT, REF = "dragonboat_tpu_torch", "dragonboat_tpu"


@pytest.mark.parametrize("seed", [1, 3])
def test_retry_storm_recovers_through_both_packages(tmp_path, seed):
    port = C.retry_storm(PORT, str(tmp_path / "port"), seed=seed, device="cpu")
    ref = C.retry_storm(REF, str(tmp_path / "ref"), seed=seed)
    print("reference:", ref["verdicts"], ref["catchup"], ref["longest_commit_gap_s"])
    print("port:", port["catchup"], port["longest_commit_gap_s"])
    for r in (port, ref):
        assert all(r["verdicts"].values()), r
        assert sum(r["committed_in_storm"].values()) > 0, r
    assert port["catchup"]["catchup_starts"] > 0, port
    assert port["catchup"]["no_snapshot"] == 0, port


def test_follower_below_a_rebased_window_through_both_packages(tmp_path, monkeypatch):
    """The fault's deterministic form: once a low rebase threshold has moved
    the leaders' window base past a new member's empty log (hosts on
    separate cores, K=1), the device keeps no match for it. The catch-up
    took that 0 for the base itself and sent from base+1, which the member
    rejected; it then fell to the snapshot path, found none and retried,
    forever. The port takes the follower's progress below the base from its
    acks and its rejects' hints, and catches it up from the host log. The
    JAX package reliably strands it at index 0 asking for a snapshot."""
    import importlib

    for pkg in (PORT, REF):
        monkeypatch.setattr(importlib.import_module(pkg + ".engine.vector"),
                            "_REBASE_THRESHOLD", 32)
    kw = dict(shared=False, steps=1)
    port = C.join_shared_core(PORT, str(tmp_path / "port"), device="cpu", **kw)
    ref = C.join_shared_core(REF, str(tmp_path / "ref"), catch_s=10.0, **kw)
    assert all(port["verdicts"].values()), port
    assert port["catchup"]["below_window_rejects"] >= port["joins"], port
    assert port["catchup"]["no_snapshot"] == 0, port
    for v in ("every_group_elected", "every_add_committed", "post_join_entry_committed"):
        assert ref["verdicts"][v], ref
    assert set(ref["joiner_applied"].values()) == {0}, ref
    assert ref["catchup"]["no_snapshot"] > 0, ref
