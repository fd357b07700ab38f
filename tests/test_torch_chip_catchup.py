"""chip_smoke.py phase 13 rehearsed on the CPU, a scenario at a time: the
join of empty members over a shared K=8 core (8 groups x 3 here, 1,024 x 3
on the card; 8 joins and 300 entries first, past the 256-entry window),
the retry storm, a member caught up below a rebased window (also with its
inbox piled up), a snapshot install whose recovery waits while the step
appends (scalar and vector engine), and the reference bodies of the last
eleven test files that drive the vector engine. Every verdict holds, the
vector engines stepped the plain version, and no log reader raised a log
hole nor a save lacked its payload. The rehearsals of files with a slow
body are slow."""
import pytest

import chip_smoke
from dragonboat_tpu_torch.ops import cuda, kernel as K
from torch_twin import one_thread  # noqa: F401

SLOW = ("restart", "snapshot_files", "rate_limit", "storage", "chaos")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n, _ in chip_smoke.CATCHUP_SCENARIOS])
def test_phase_catchup_scenario_on_cpu(name, monkeypatch):
    monkeypatch.setattr(chip_smoke, "CATCHUP_SCENARIOS",
                        tuple(s for s in chip_smoke.CATCHUP_SCENARIOS if s[0] == name))
    out = chip_smoke.phase_catchup(cuda, K, "cpu", device="cpu", groups=8)
    r = out[name]
    assert r["verdicts"] and all(r["verdicts"].values()), (r["verdicts"], r.get("failed"))
    if name in chip_smoke.HOST_ONLY_SCENARIOS:
        assert r["plain_step_calls"] == 0 and r["launches"]["step_batch"] == 0
    else:
        assert r["plain_step_calls"] > 0 and r["launches"]["step_batch"] == 0
    assert out["log_holes"] == 0 and out["missing_arena_saves"] == 0
    if name == "join_shared_k8":
        assert out["joins_first_rejects"] == 8


def test_teardown_cycles_on_cpu(tmp_path):
    """Phase 13's teardown check (ROADMAP §3 fault 13) rehearsed at 4 groups,
    one cycle of each shape: the card's memory is read only there."""
    out = chip_smoke.teardown_cycles("cpu", "cpu", groups=4, cycles=1, workdir=str(tmp_path))
    for name, *_x in chip_smoke.TEARDOWN_SHAPES:
        assert out[name]["verdicts"] == {"cycles_completed": True}
        assert out[name]["after"] == [None]
