"""Count the collection errors of the tier-1 suite from an empty
native/build, as the tier-1 command collects it (six xdist workers):

    python3 collect_check.py DIR [ROUNDS]

DIR is the root of a checkout (for example `git archive` of a commit
unpacked into a directory that .gitignore lists); ROUNDS defaults to 10.
Each round removes DIR/native/build, then runs `pytest tests/
--collect-only -n 6` in DIR on the CPU, and prints the round's error count
(from pytest's summary line) and the files it names as failing to
collect; the last line is one JSON object with the totals. The reference's
tests build native/ at import, so from an empty build directory the six
workers race on the same build."""

import json
import os
import re
import shutil
import subprocess
import sys


def one_round(root: str):
    shutil.rmtree(os.path.join(root, "native", "build"), ignore_errors=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "xdist", "-n", "6"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    out = p.stdout + p.stderr
    m = re.search(r"(\d+) errors?\b", out.splitlines()[-1] if out.strip() else "")
    files = sorted(set(re.findall(r"^ERROR (tests/\S+)", out, re.M)))
    return (int(m.group(1)) if m else 0), files


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    root, rounds = argv[0], int(argv[1]) if len(argv) > 1 else 10
    total, per = 0, []
    for r in range(rounds):
        n, files = one_round(root)
        total += n
        per.append(n)
        print(f"round {r}: {n} collection errors {files}", flush=True)
    print(json.dumps({"dir": root, "rounds": rounds, "workers": 6,
                      "errors_per_round": per, "errors": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
