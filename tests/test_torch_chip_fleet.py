"""chip_smoke.py phase 12 (the bodies of the reference's bulk bring-up,
observability, forensics, vector-scale and chaos-at-scale tests through the
port's NodeHost) rehearsed on the CPU: every scenario's verdicts hold and
its engines stepped the plain version. Each body runs at its test's shape;
the config-2-width bring-up runs at 8 groups x 3 here and the chaos body at
its test's 256 x 3 (both at 1,024 x 3 on the card). The rehearsals of the
reference's slow tests are slow too."""
import pytest

import chip_smoke
from dragonboat_tpu_torch.ops import cuda, kernel as K
from torch_twin import one_thread  # noqa: F401

SLOW = ("scale", "quiesce", "chaos_scale")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n, _ in chip_smoke.FLEET_SCENARIOS])
def test_phase_fleet_scenario_on_cpu(name, monkeypatch):
    monkeypatch.setattr(chip_smoke, "FLEET_SCENARIOS",
                        tuple(s for s in chip_smoke.FLEET_SCENARIOS if s[0] == name))
    out = chip_smoke.phase_fleet(cuda, K, "cpu", device="cpu", groups=8)
    r = out[name]
    assert r["verdicts"] and all(r["verdicts"].values()), (r["verdicts"], r.get("failed"))
    assert r["plain_step_calls"] > 0 and r["launches"]["step_batch"] == 0
