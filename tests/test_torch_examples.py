"""Keep the port's examples honest: helloworld (the twin of
examples/helloworld.py) runs end to end on the port — real TCP, election,
proposals, follower read, transfer, outage, restart — here with its
engines on the CPU (`--device cpu`); chip_smoke.py runs it on the card."""
import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_helloworld_example(tmp_path):
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "dragonboat_tpu_torch.examples.helloworld",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=str(tmp_path),  # its data dir lands here, not in the repo
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "HELLOWORLD PASS" in proc.stdout
