"""chip_smoke.py phase 11 (the reference's engine-level scenarios through
the port's NodeHost) rehearsed on the CPU at 8 groups: every scenario's
verdicts hold and its engines stepped the plain version; on the card the
same bodies run at 1,024 groups and launch the kernels. The reference
storm that phase 11 prints beside its own counts is held against the JAX
package's in tests/test_torch_prevote.py."""
import pytest

import chip_smoke
from dragonboat_tpu_torch.ops import cuda, kernel as K
from torch_twin import one_thread  # noqa: F401


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.SCENARIOS])
def test_phase_scenario_on_cpu(name, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SCENARIOS",
                        tuple(s for s in chip_smoke.SCENARIOS if s[0] == name))
    out = chip_smoke.phase_scenarios(cuda, K, "cpu", device="cpu", groups=8)
    r = out[name]
    assert r["verdicts"] and all(r["verdicts"].values()), r["verdicts"]
    assert r["plain_step_calls"] > 0 and r["launches"]["step_batch"] == 0
