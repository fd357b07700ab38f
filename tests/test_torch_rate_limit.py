"""Twin of tests/test_rate_limit.py on the PyTorch port (CPU engines).

Every test of the reference file runs here with its names bound to the port
(`torch_twin.port_copy`): the rate limiter's local and follower limits and
their ageing out, the in-memory log's byte accounting, the scalar core's
follower reports, and a NodeHost refusing a burst with ErrSystemBusy and
accepting work again on either engine (slow). When that body fails, the
harness prints the in-memory log size the burst reached beside the limit
(`torch_twin.in_mem_log_watch`).

The test below drives both packages' rate limiters with one seeded
sequence of operations and holds every decision equal."""
import importlib
import random

import pytest

from torch_twin import in_mem_log_watch, one_thread, port_copy, reference_tests, reporting  # noqa: F401

R = port_copy("test_rate_limit")
globals().update(reference_tests(R))
# ROADMAP §3 fault 16: a failed burst prints the in-memory log size it
# reached beside max_in_mem_log_size
test_nodehost_rate_limit_e2e = reporting(R.test_nodehost_rate_limit_e2e, in_mem_log_watch)


def decisions(pkg, seed, n=400):
    RL = importlib.import_module(pkg + ".core.rate").RateLimiter
    rng = random.Random(seed)
    rl = RL(rng.choice([0, 100, 4096]))
    out = []
    for _ in range(n):
        op = rng.choice(["set", "inc", "dec", "follower", "tick", "reset"])
        if op == "set":
            rl.set(rng.randrange(0, 5000))
        elif op == "inc":
            rl.increase(rng.randrange(0, 500))
        elif op == "dec":
            rl.decrease(rng.randrange(0, 500))
        elif op == "follower":
            rl.set_follower_state(rng.randrange(1, 6), rng.randrange(0, 8000))
        elif op == "tick":
            for _ in range(rng.randrange(1, RL.GC_TICK + 2)):
                rl.tick()
        else:
            rl.reset_follower_state()
        out.append((op, rl.enabled, rl.rate_limited(), rl.get()))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_limiter_decisions_match_reference(seed):
    ref = decisions("dragonboat_tpu", seed)
    port = decisions("dragonboat_tpu_torch", seed)
    assert port == ref
