"""Client-side retry with jittered exponential backoff under a deadline.

The server sheds with typed ErrOverloaded errors carrying retry-after
hints (admission.py); this is the matching client half: retry ONLY the
fail-fast overload/timeout family, back off exponentially with full
jitter, honor the server's hint as a floor, and — the part naive retry
loops always get wrong — propagate the caller's deadline so no retry
(or its backoff sleep) ever outlives the original timeout budget
(cf. dragonboat's timeout-ticked RequestStates: the deadline travels
with the request, requests.go:223-241).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from ..requests import ErrSystemBusy, ErrTimeout
from .admission import ErrOverloaded


def call_with_retries(
    fn: Callable[..., object],
    deadline_s: float,
    *,
    base_s: float = 0.01,
    factor: float = 2.0,
    max_backoff_s: float = 1.0,
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    session=None,
) -> object:
    """Run `fn(remaining_s)` until it succeeds or the deadline expires.

    `fn` receives the REMAINING time budget each attempt (pass it down
    as the per-try timeout so one slow attempt cannot eat the budget of
    the retries after it). Retries fire only on ErrSystemBusy-family
    errors (which includes every typed overload shed) — rejections,
    closed clusters etc. surface immediately. Backoff per attempt k is
    uniform(0, min(base * factor**k, max_backoff)) (full jitter: a
    thundering herd of shed clients must not re-arrive in lockstep),
    floored at the server's retry_after_s hint when one was given. A
    backoff that would cross the deadline raises ErrTimeout instead of
    sleeping — retries never outlive the caller's timeout.

    When `session` (a client.Session) is given, fn is called as
    `fn(remaining_s, session)` and every retry reuses the SAME session
    object — the series_id MUST NOT advance between attempts, so a
    retried proposal that already applied dedups to the RSM's cached
    result instead of double-applying as an accidental new series. An
    attempt that advanced the series (it completed) yet still raised a
    retryable error is refused rather than retried: re-proposing under
    the advanced series would be a fresh apply, exactly the double-apply
    this parameter exists to prevent.

    rng/clock/sleep are injectable for deterministic tests."""
    if deadline_s <= 0:
        raise ErrTimeout()
    rng = rng if rng is not None else random.Random()
    deadline = clock() + deadline_s
    attempt = 0
    series0 = session.series_id if session is not None else None
    while True:
        remaining = deadline - clock()
        if remaining <= 0:
            raise ErrTimeout()
        try:
            if session is not None:
                return fn(remaining, session)
            return fn(remaining)
        except ErrSystemBusy as e:
            if session is not None and session.series_id != series0:
                raise RuntimeError(
                    "session series advanced across a retryable failure; "
                    "retrying would double-apply under a new series"
                ) from e
            hint = float(getattr(e, "retry_after_s", 0.0) or 0.0)
            cap = min(base_s * (factor ** attempt), max_backoff_s)
            delay = max(rng.random() * cap, hint)
            if clock() + delay >= deadline:
                # the hint (or backoff) says the server won't take this
                # before the caller stops caring: give up now, not then
                raise ErrTimeout() from e
            sleep(delay)
            attempt += 1


__all__ = ["call_with_retries", "ErrOverloaded"]
