"""A replica that joins a shared K>1 core as an empty member (ROADMAP §3
fault 1), through both packages (tests/torch_catchup.py).

The router stamps each message with its sender's own slot. A replica that
joins with join=True knows no peer until it applies the membership, so a
device-routed Replicate reached it from a slot it had no node for: its
answer went nowhere and it stayed at index 0. The port routes a pair on the
device only where the destination keeps the sender at the slot the router
stamps (`VectorEngine._rebuild_routes`); until then the host path parks the
sender on a free slot for it, as it does for a join over separate cores.
The step kernel and the router are unchanged.

Every scenario here first commits more entries than the log window holds,
so the joiner is caught up from the leader's host log, or by a snapshot
where the log was compacted. The JAX package is held only to what it
reliably shows: elections, the adds and the post-join entry committed by
the three first replicas; its routing table is the one that names the
difference (routes to a slot the joiner does not keep)."""
import pytest

import torch_catchup as C
from torch_twin import one_thread  # noqa: F401

PORT, REF = "dragonboat_tpu_torch", "dragonboat_tpu"


@pytest.mark.parametrize("steps", [8, 1], ids=["k8", "k1"])
def test_join_over_a_shared_core_catches_up(tmp_path, steps):
    r = C.join_shared_core(PORT, str(tmp_path), steps=steps, device="cpu")
    assert all(r["verdicts"].values()), r
    assert r["replicas_with_post_join_entry"] == {1: 4, 2: 4}
    # the leaders' logs ran past the window: host-log catch-up, no snapshot
    assert r["catchup"]["catchup_starts"] >= r["joins"], r
    assert r["catchup"]["no_snapshot"] == 0 and r["catchup"]["misrouted"] == 0, r


def test_join_over_a_compacted_log_installs_a_snapshot(tmp_path):
    r = C.join_shared_core(PORT, str(tmp_path), snapshot_entries=16, device="cpu")
    assert all(r["verdicts"].values()), r
    assert r["catchup"]["snapshots_sent"] >= r["joins"], r
    assert r["catchup"]["misrouted"] == 0, r


def test_join_over_a_shared_core_through_both_packages(tmp_path):
    port = C.join_shared_core(PORT, str(tmp_path / "port"), device="cpu")
    ref = C.join_shared_core(REF, str(tmp_path / "ref"), catch_s=10.0)
    print("reference:", ref["verdicts"], ref["joiner_applied"], ref["catchup"])
    assert all(port["verdicts"].values()), port
    assert port["catchup"]["misrouted"] == 0
    for v in ("every_group_elected", "pre_entries_committed", "every_add_committed",
              "post_join_entry_committed"):
        assert ref["verdicts"][v], ref
    assert all(n >= 3 for n in ref["replicas_with_post_join_entry"].values()), ref
    # the reference routes the leaders' traffic to the joiners on the device
    assert ref["catchup"]["misrouted"] > 0, ref


def test_join_below_a_rebased_window_is_caught_up_from_the_host_log(tmp_path, monkeypatch):
    # a low rebase threshold moves the leaders' window base past the
    # joiner's empty log: its reject's hint lies below the base, so the
    # router leaves the reject to the host (`_route_columns`' below-window
    # mask, which `_mask_routed` does not clear) and the leader serves it
    # in `_below_window_reject`
    import dragonboat_tpu_torch.engine.vector as V

    monkeypatch.setattr(V, "_REBASE_THRESHOLD", 32)
    r = C.join_shared_core(PORT, str(tmp_path), device="cpu")
    assert all(r["verdicts"].values()), r
    assert r["catchup"]["below_window_rejects"] >= r["joins"], r
    assert r["catchup"]["no_snapshot"] == 0 and r["catchup"]["misrouted"] == 0, r
