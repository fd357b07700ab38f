"""Phase 5 of chip_smoke.py (the BASELINE ladder through NodeHost on the
card) from several checkouts in one call, in the order given, so that two
commits are compared on the same card:

    python3 engine_ab.py [--configs 1,6] [--out FILE] PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each DIR is the root of a checkout (for example `git archive` of a commit
unpacked into a directory that .gitignore lists). Each run is a process of
its own that imports that checkout's package and chip_smoke.py, builds its
kernels and runs chip_smoke.phase_engine for every config of its
E2E_CONFIGS (or those `--configs` names, in its order), with every gate
of that phase. Prints, per run, one line
`{"run": i, "dir": ..., "configs": {...}}` with each config's value/s,
commit latency, steps/s, device busy share and its three largest host
stages, then the card's name and power limit; with `--out` writes the
lines to FILE as well. Exits non-zero when a run failed."""

import json
import os
import subprocess
import sys

KEYS = ("value", "committed", "seconds", "commit_latency_p50_s", "commit_latency_p99_s",
        "engine_steps_per_s", "reads_per_sec", "out_of_seam_syncs", "kernel_builds")

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from dragonboat_tpu_torch.ops import cuda, kernel as K
cuda.build_kernels()
wanted, keys, out = %r, %r, {}
for c in [c for c in cs.E2E_CONFIGS if wanted is None or c in wanted]:
    r, _ = cs.phase_engine(cuda, K, c)
    stages = sorted((r.get("host_stage_window_s") or {}).items(), key=lambda kv: -kv[1])[:3]
    out[str(c)] = dict({k: r.get(k) for k in keys}, largest_stages=dict(stages),
                       device_busy_share=(r.get("busy") or {}).get("device_busy_share"))
print("ENGINE_AB " + json.dumps(out, default=str))
"""


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv) -> int:
    configs = out = None
    while argv[:1] in (["--configs"], ["--out"]):
        if argv[0] == "--configs":
            configs = tuple(int(c) for c in argv[1].split(","))
        else:
            out = argv[1]
        argv = argv[2:]
    dirs = argv
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    run = RUN % (configs, KEYS)
    rc = 0
    with open(out or os.devnull, "w") as f:
        for i, d in enumerate(dirs):
            p = subprocess.run([sys.executable, "-c", run], cwd=d, capture_output=True,
                               text=True)
            got = [ln for ln in p.stdout.splitlines() if ln.startswith("ENGINE_AB ")]
            line = {"run": i, "dir": d, "rc": p.returncode,
                    "configs": json.loads(got[-1][len("ENGINE_AB "):]) if got else None}
            if p.returncode or not got:
                rc = 1
                line["stderr_tail"] = p.stderr[-3000:]
            text = json.dumps(line)
            print(text, flush=True)
            f.write(text + "\n")
        card = card_line()
        print(f"card: {card}")
        f.write(json.dumps({"card": card}) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
