"""The port's long-haul runner against the reference's, on the CPU.

A round's orchestration schedule (scenario choices, victims, windows,
crash and restart schedules: `_ORCH_SITES` of tools/longhaul.py) is drawn
from its seed alone, so one seed through both packages' `run_longhaul`
runs the same scenarios and prints the same schedule signature; the
verdicts judged are the same set. The scalar engine suffices: the
signature digests orchestration draws only, whatever engine steps the
groups.

The same property pins chip_smoke's phase 8: each of its runs on the card
must print, round by round, the signatures the JAX package's runner draws
for the run's seed, scenarios and round length (LONGHAUL_SIGNATURES)."""
import pytest

import chip_smoke
from dragonboat_tpu.tools import longhaul as ref_longhaul
from dragonboat_tpu_torch.tools import longhaul as port_longhaul

pytestmark = pytest.mark.longhaul


def _run(mod, tmp_path, name, **kw):
    opts = dict(budget_s=120.0, engine="scalar", out_dir=str(tmp_path / name), ring=False,
                preflight=False, triage=False)
    opts.update(kw)
    return mod.run_longhaul(mod.Options(**opts))


@pytest.mark.parametrize("seed", [0x516, 0x2B1])
def test_same_seed_same_schedule_in_both_packages(tmp_path, seed):
    ref = _run(ref_longhaul, tmp_path, "ref", seed=seed, rounds_max=1, round_s=3.0)
    port = _run(port_longhaul, tmp_path, "port", seed=seed, rounds_max=1, round_s=3.0)
    (r,), (p,) = ref["rounds"], port["rounds"]
    assert p.signature == r.signature
    assert p.scenarios == r.scenarios
    assert sorted(p.verdicts) == sorted(r.verdicts)


def test_port_options_add_only_the_device_and_tick():
    ref = {f.name: f.default for f in ref_longhaul.Options.__dataclass_fields__.values()}
    port = {f.name: f.default for f in port_longhaul.Options.__dataclass_fields__.values()}
    assert port.pop("device") == "cuda"
    assert port.pop("rtt_ms") == 5
    assert port == ref
    assert port_longhaul.SCENARIOS == ref_longhaul.SCENARIOS


@pytest.mark.parametrize("name,kw", chip_smoke.LONGHAUL_ROUNDS,
                         ids=[n for n, _ in chip_smoke.LONGHAUL_ROUNDS])
def test_chip_smoke_longhaul_signatures_are_the_references(tmp_path, name, kw):
    """Phase 8's constants: the JAX package's runner, scalar engine, the
    same seed, rotation, scenarios and round length."""
    kw = {k: v for k, v in kw.items() if k not in ("steps_per_sync", "shard_over_mesh")}
    report = _run(ref_longhaul, tmp_path, name, **kw)
    sigs = tuple(r.signature for r in report["rounds"])
    assert sigs == chip_smoke.LONGHAUL_SIGNATURES[name]
