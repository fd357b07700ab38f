"""Perf attribution plane: step-phase spans, runtime device-sync audit,
and kernel-build accounting.

The engine step loop's wall time is the product this repo optimizes, and
Earlier work taught the same lesson three times: a regression that does not
fail a test quietly becomes the new baseline. This module makes the
attribution itself a first-class, always-exported plane:

  * ``PhasePlane`` — phase-scoped span histograms. The engines' stage
    profilers (``trace.Profiler``) ride the existing
    ``EngineConfig.profile_sample_ratio`` sampler; on sampled iterations
    every stage duration is ALSO observed into an
    ``engine_phase_seconds{engine=...,phase=...}`` histogram
    (events.Histogram, Prometheus exposition via
    ``NodeHost.write_health_metrics``), and at FULL sampling (ratio 1,
    the bench/debug opt-in) recorded as a ``phase_span`` event in the
    FlightRecorder so ``tools.timeline --spans`` renders them
    interleaved with causal-trace stages — sparse production sampling
    fills histograms only, never crowding the forensic ring. Unsampled
    iterations stay allocation- and event-free (the profiler's
    start/end no-op there).

  * ``SyncAudit`` — the runtime twin of the static ``device-sync`` rule
    family (analysis/rules_device.py). The blessed seam
    (``VectorEngine._fetch_output``) self-reports each consolidated
    transfer through ``note_seam_sync()`` (one integer add per step,
    always on). ``install()`` additionally wraps torch's host sync
    points process-wide (``Tensor.cpu``/``.item``/``.tolist``/``.numpy``
    on a tensor of the audited engine's device — the card by default,
    the CPU when ``install(device="cpu")`` — and
    ``torch.cuda.synchronize``) so any OTHER transfer is counted with
    call-site attribution — a stray sync introduced at runtime shows up
    in ``engine_device_syncs_*`` metrics.

  * ``CompileWatch`` — kernel-build accounting: a listener on
    ``ops/cuda.build_kernels`` counts every nvcc build (and its seconds),
    so a build inside a measured window is visible
    (``engine_compile_events_total``; the e2e harness folds the
    window's delta into its report).

  * ``HistorySampler`` — the diagnosis plane's TIME axis: a background
    thread that, every ``interval_s`` (default 250ms, entirely off the
    step loop), snapshots every zero-sync stat surface a host exports —
    lane stats (capped to the hottest K lanes), protocol counters,
    pressure, HBM census, leases, clock anomalies, WAL barrier
    latencies, serving/placement gauges — into a crash-persistent
    ``MmapRing`` (trace.py framing, bigger slots) next to the flight
    ring. Lifetime counters become windowed rates, and a SIGKILL leaves
    the last N seconds of fleet state on disk for ``tools.doctor`` to
    read back. Samples are flight-compatible events
    (``event=history_sample``) so ``tools.timeline`` merges a history
    ring like any other forensic artifact.

torch is imported lazily (inside ``install()``), so this module stays
importable, and its stat schemas readable, without touching a device.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from .events import Histogram, write_histogram_series, _labels
from .trace import _RING_MAGIC, MmapRing, flight_recorder, read_mmap_ring

# canonical step-phase vocabulary. The vector engine's step loop
# (VectorEngine._run_once + _decode) times every stage of a kernel step;
# bench.py zero-fills phase_breakdown over VECTOR_PHASES so the JSON
# schema is stable even for configs where a phase never ran.
VECTOR_PHASES = (
    "pack",       # host-event staging -> inbox planes (one scatter/plane)
    "dispatch",   # the one host->device copy + the step's launch
    "fetch",      # _fetch_output: THE consolidated device->host sync
    "place",      # decode phase 0: payloads at device-assigned indexes
    "send_rep",   # decode phase 1: Replicate sends (leave BEFORE fsync)
    "save",       # decode phase 2: batched fsync save wave
    "send_resp",  # decode phase 3: post-fsync sends (votes/acks/heartbeats)
    "apply",      # decode phase 4: committed entries -> RSM task queues
    "reads",      # decode phase 5: confirmed ReadIndex completions
    "maintain",   # decode phase 6: catchup/snapshot/compaction maintenance
    "deliver",    # bulk send/deliver seam (_dispatch_sends, sub-span of
                  # the send/apply/reads phases it runs inside)
)

# the scalar ExecEngine worker loop's stages (trace.STAGES order), timed
# by the same Profiler machinery so scalar/vector attribution reads on
# one scale in the exposition and the bench JSON
EXEC_PHASES = ("step", "fast_apply", "send", "save", "apply", "exec")

_PREFIX = "dragonboat_tpu"


class PhasePlane:
    """Process-global phase-span sink: (engine, phase) -> Histogram plus
    a FlightRecorder ``phase_span`` breadcrumb per sampled span.

    Fed exclusively from trace.Profiler's SAMPLED branch (attach via
    ``Profiler.attach_phase_plane``); the ``sampling`` argument mirrors
    the caller's gate so the off path stays event-free and the lint's
    telemetry rule can see the guard."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        # master switch for flight-recorder spans (timeline --spans);
        # disable for tests that assert exact recorder contents
        self.record_spans = True

    def on_phase(
        self,
        engine: str,
        phase: str,
        dt: float,
        sampling: bool,
        spans: bool = True,
    ) -> None:
        """`sampling` mirrors the calling profiler's 1-in-N gate (off
        path: nothing happens); `spans` is the producer's full-sampling
        gate (trace.Profiler sets it only at ratio 1, the bench/debug
        mode) — sparse production sampling fills histograms but must not
        crowd the forensic ring's bounded history with phase_span
        breadcrumbs."""
        if sampling:
            key = (engine, phase)
            with self._mu:
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = Histogram()
            h.observe(dt)
            if spans and self.record_spans:
                flight_recorder().record(
                    "phase_span", engine=engine, phase=phase,
                    dur=round(dt, 9),
                )

    def histogram(self, engine: str, phase: str) -> Optional[Histogram]:
        with self._mu:
            return self._hists.get((engine, phase))

    def total_observations(self) -> int:
        with self._mu:
            hists = list(self._hists.values())
        return sum(h.count for h in hists)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """(engine, phase) -> {count, sum_s, p50_s, p99_s} for tooling."""
        with self._mu:
            items = list(self._hists.items())
        out: Dict[str, Dict[str, float]] = {}
        for (engine, phase), h in items:
            out[f"{engine}/{phase}"] = {
                "count": float(h.count),
                "sum_s": round(h.sum, 6),
                "p50_s": round(h.quantile(0.5), 6),
                "p99_s": round(h.quantile(0.99), 6),
            }
        return out

    def reset(self) -> None:
        with self._mu:
            self._hists.clear()

    def write(self, w, prefix: str = _PREFIX) -> None:
        """Prometheus exposition: one ``engine_phase_seconds`` histogram
        family, series labelled {engine=...,phase=...}."""
        with self._mu:
            items = sorted(self._hists.items())
        if not items:
            return
        full = f"{prefix}_engine_phase_seconds"
        w.write(f"# TYPE {full} histogram\n")
        for (engine, phase), h in items:
            write_histogram_series(
                w, full, (("engine", engine), ("phase", phase)), h
            )


class SyncAudit:
    """Runtime device->host transfer accounting.

    The blessed seam (``VectorEngine._fetch_output``) self-reports via
    ``note_seam_sync()`` unconditionally — one integer add per engine
    step. ``install(device=...)`` wraps the torch calls that read a
    device tensor on the host — ``Tensor.cpu``, ``.item``, ``.tolist``
    and ``.numpy`` on a tensor of the audited engine's device type
    (``"cuda"`` unless the caller names another; an engine on
    ``device="cpu"`` is audited with ``device="cpu"``, as the JAX
    package's audit counts fetches on every backend), and
    ``torch.cuda.synchronize`` — so every such call NOT made from a
    blessed frame is counted under its call site
    (``file.py:line:function``). The seams themselves wait on a CUDA
    event (or, on the CPU, read the slot's numpy views), which is not
    wrapped. Per-call overhead is one device probe and one frame probe —
    noise next to the transfer itself."""

    # (path suffix, function name) pairs whose frames are the blessed
    # transfer seam. _fetch_output is the classic one-step seam; _fetch_super is the
    # multi-step engine's once-per-K-steps consolidated transfer.
    BLESSED = (
        ("engine/vector.py", "_fetch_output"),
        ("engine/vector.py", "_fetch_super"),
    )

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.seam = 0  # blessed-seam transfers (note_seam_sync)
        # protocol steps decoded (note_engine_steps): with the
        # multi-step engine one seam sync covers K of these, so
        # engine_steps / seam is the measured steps-per-sync ratio —
        # the honest denominator for "zero out-of-seam syncs per step"
        self.engine_steps = 0
        self._out: Dict[str, int] = {}
        self.installed = False
        # the device type whose tensors' host reads are counted
        self.device_type = "cuda"
        self._orig: Dict[str, object] = {}
        self._orig_sync = None

    # ------------------------------------------------------------- seam
    def note_seam(self) -> None:
        # GIL-atomic-enough: telemetry, not accounting
        self.seam += 1

    # ------------------------------------------------------------ wraps
    # the Tensor methods that copy a CUDA tensor to the host (and so wait
    # for the card)
    _TENSOR_SYNCS = ("cpu", "item", "tolist", "numpy")

    def install(self, device=None) -> "SyncAudit":
        """Wrap the sync points (idempotent). ``device`` names the audited
        engine's device (a ``torch.device`` or its name); a later call
        with another device retargets the audit."""
        import torch

        if device is not None:
            self.device_type = torch.device(device).type
        if self.installed:
            return self
        self._orig = {n: getattr(torch.Tensor, n) for n in self._TENSOR_SYNCS}
        self._orig_sync = orig_sync = torch.cuda.synchronize

        def wrap(orig):
            def method(t, *a, **k):
                if t.device.type == self.device_type:
                    self._note_frame(sys._getframe(1))
                return orig(t, *a, **k)

            method.__name__ = orig.__name__
            return method

        for n, orig in self._orig.items():
            setattr(torch.Tensor, n, wrap(orig))

        def synchronize(*a, **k):
            self._note_frame(sys._getframe(1))
            return orig_sync(*a, **k)

        torch.cuda.synchronize = synchronize
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        import torch

        for n, orig in self._orig.items():
            setattr(torch.Tensor, n, orig)
        torch.cuda.synchronize = self._orig_sync
        self._orig, self._orig_sync = {}, None
        self.installed = False
        self.device_type = "cuda"

    def _note_frame(self, frame) -> None:
        co = frame.f_code
        fname = co.co_filename.replace(os.sep, "/")
        for suffix, name in self.BLESSED:
            if co.co_name == name and fname.endswith(suffix):
                return  # the seam counts itself via note_seam()
        # package-internal sites keep their package-relative path so the
        # attribution names the offending module, not just a basename
        idx = fname.rfind("/dragonboat_tpu_torch/")
        rel = fname[idx + 1 :] if idx >= 0 else os.path.basename(fname)
        site = f"{rel}:{frame.f_lineno}:{co.co_name}"
        with self._mu:
            self._out[site] = self._out.get(site, 0) + 1

    # --------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        with self._mu:
            sites = dict(self._out)
        steps = self.engine_steps
        return {
            "in_seam": self.seam,
            "out_of_seam": sum(sites.values()),
            "engine_steps": steps,
            "steps_per_sync": round(steps / self.seam, 3) if self.seam else 0.0,
            "sites": sites,
        }

    def out_of_seam_in_package(self) -> Dict[str, int]:
        """Out-of-seam sites attributed to the package's own code only
        (test/bench harness sites excluded)."""
        with self._mu:
            return {
                s: n
                for s, n in self._out.items()
                if s.startswith("dragonboat_tpu_torch/")
            }

    def reset(self) -> None:
        with self._mu:
            self._out.clear()
        self.seam = 0
        self.engine_steps = 0


def diff_sync(before: dict, after: dict) -> dict:
    """Per-window delta of two SyncAudit.snapshot() dicts (bench folds
    the measurement window's delta, not process-lifetime totals)."""
    sites = {
        s: n - before.get("sites", {}).get(s, 0)
        for s, n in after.get("sites", {}).items()
        if n - before.get("sites", {}).get(s, 0) > 0
    }
    seam = after["in_seam"] - before["in_seam"]
    steps = after.get("engine_steps", 0) - before.get("engine_steps", 0)
    return {
        "in_seam": seam,
        "out_of_seam": after["out_of_seam"] - before["out_of_seam"],
        "engine_steps": steps,
        "steps_per_sync": round(steps / seam, 3) if seam > 0 else 0.0,
        "sites": sites,
    }


# the HBM census schema: ALWAYS-present bench-JSON / gauge keys (the
# ROADMAP paged-arena item's baseline). Zero-filled when no device
# engine ran (bring-up-failed path, scalar-only hosts).
CENSUS_KEYS = (
    "hbm_bytes_total",   # device-resident protocol-state bytes (all planes)
    "hbm_log_bytes",     # the dense per-lane log ring's share of the above
    "log_fill_p50",      # median per-lane logical fill of the W-slot ring
    "log_fill_p99",      # tail fill: the widest lane the dense ring is for
    "hbm_waste_ratio",   # 1 - logical/physical over the whole log plane
)


class DeviceCensus:
    """HBM census of one engine's device-resident state planes.

    Physical bytes are STATIC tensor metadata: the owning engine reports
    each plane's ``.nbytes`` (shape x dtype) once at allocation time via
    ``set_planes`` — shapes never change over an engine's life, so the
    census never touches the device to answer "how much HBM does the
    protocol state hold". Logical per-lane log fill is numpy arithmetic
    over the decode-maintained mirrors the engine passes to
    ``snapshot()`` (``_m_last`` / ``_m_devfirst`` / ``_m_active``) —
    also zero device syncs, by the same argument as ``lane_stats``.

    ``hbm_waste_ratio`` is the paged-arena item's headline: the dense
    ring allocates ``G x W`` slots (every lane pays the widest lane's
    budget); the ratio is the fraction of those slots holding no live
    log entry. Fill p50/p99 describe the raggedness a paged relayout
    would exploit.

    device-free like the rest of this module: numpy is imported inside
    ``snapshot()`` only (the callers that pass mirrors already loaded
    it), so readers that touch no device can import the class
    and its ``empty()`` schema without touching a backend."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._planes: Dict[str, int] = {}
        self._log_planes: Tuple[str, ...] = ()
        self._devices = 1
        self._log_window = 0
        self._host_staging_bytes = 0

    def set_planes(
        self,
        planes: Dict[str, int],
        log_planes: Tuple[str, ...] = (),
        devices: int = 1,
        log_window: int = 0,
        host_staging_bytes: int = 0,
    ) -> None:
        """Report the engine's device planes (plane name -> physical
        bytes). ``log_planes`` names the subset that is the per-lane log
        ring; ``host_staging_bytes`` is the host-side numpy staging the
        inbox pack path owns (reported for completeness, never counted
        as HBM)."""
        with self._mu:
            self._planes = dict(planes)
            self._log_planes = tuple(log_planes)
            self._devices = max(1, int(devices))
            self._log_window = int(log_window)
            self._host_staging_bytes = int(host_staging_bytes)

    def planes(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._planes)

    @staticmethod
    def empty() -> dict:
        """The zero-filled census schema: what a host with no device
        engine (or a bring-up-failed bench config) reports, so the JSON
        keys are ALWAYS present."""
        out = {
            "hbm_bytes_total": 0,
            "hbm_log_bytes": 0,
            "log_fill_p50": 0.0,
            "log_fill_p99": 0.0,
            "hbm_waste_ratio": 0.0,
        }
        out.update(
            hbm_bytes_per_device=0,
            host_staging_bytes=0,
            lanes_active=0,
            log_window=0,
            planes={},
        )
        return out

    def snapshot(self, last=None, devfirst=None, active=None) -> dict:
        """The census: physical bytes from the registered plane table,
        logical fill from the caller's numpy mirrors (device-unit last
        index, device-unit first live index, active mask). All three
        mirrors are optional — a caller with no lanes yet gets the
        physical half with zeroed fill stats."""
        import numpy as np

        with self._mu:
            planes = dict(self._planes)
            log_planes = self._log_planes
            devices = self._devices
            W = self._log_window
            host_staging = self._host_staging_bytes
        total = sum(planes.values())
        log_bytes = sum(planes.get(p, 0) for p in log_planes)
        out = self.empty()
        out["hbm_bytes_total"] = int(total)
        out["hbm_log_bytes"] = int(log_bytes)
        out["hbm_bytes_per_device"] = int(total // devices)
        out["host_staging_bytes"] = int(host_staging)
        out["log_window"] = int(W)
        out["planes"] = planes
        if last is None or active is None or W <= 0:
            return out
        # the mirrors belong to the engine's loop thread, which activates
        # lanes while this runs on a tick or sampler thread: fold private
        # copies, or a mask that gains True entries between numpy's count
        # of them (the output's size) and its copy loop (which drops the
        # GIL on large arrays) overruns the output buffer
        act = np.array(active, dtype=bool)
        n_act = int(act.sum())
        out["lanes_active"] = n_act
        lastv = np.array(last)
        first = (
            np.array(devfirst) if devfirst is not None
            else np.ones_like(lastv)
        )
        # logical slots a lane holds in the ring: indexes
        # [first, last] in device units, clipped to the window
        fill = np.clip(lastv - first + 1, 0, W)
        live = fill[act] / float(W) if n_act else np.zeros(0)
        if n_act:
            out["log_fill_p50"] = round(float(np.percentile(live, 50)), 6)
            out["log_fill_p99"] = round(float(np.percentile(live, 99)), 6)
        # waste over the DENSE allocation: every allocated lane (active
        # or not) pays W slots — that is exactly the dense-vs-ragged
        # accounting the paged-arena relayout would change
        total_slots = lastv.size * W
        logical = float(fill[act].sum()) if n_act else 0.0
        if total_slots:
            out["hbm_waste_ratio"] = round(1.0 - logical / total_slots, 6)
        return out


class CompileWatch:
    """Kernel-build accounting: a listener on ``ops/cuda.build_kernels``
    counts every nvcc build (and its seconds) in ``total`` and per source
    in ``per_function`` (``build:<source>``), and callables registered
    by their owners that expose ``_cache_size()`` report it per function.
    ``install()`` is idempotent and costs nothing per step: the listener
    runs only when a build runs."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.total = 0
        self.total_s = 0.0
        self._fns: Dict[str, list] = {}
        self._builds: Dict[str, int] = {}
        self.installed = False

    def install(self) -> "CompileWatch":
        if self.installed:
            return self
        from .ops import cuda

        def _on_build(src, duration):
            with self._mu:
                self.total += 1
                self.total_s += duration
                key = "build:" + src
                self._builds[key] = self._builds.get(key, 0) + 1

        cuda.BUILD_LISTENERS.append(_on_build)
        self.installed = True
        return self

    def register(self, name: str, fn):
        """Track a function's build cache under ``name``; returns ``fn``
        so call sites can wrap in place. Functions without a
        ``_cache_size`` probe (plain callables, such as the step
        functions) are ignored. Held by WEAK reference: the watch must
        never pin a dead engine's functions (falls back to a strong ref only for the
        rare non-weakrefable callable)."""
        if not hasattr(fn, "_cache_size"):
            return fn
        import weakref

        try:
            ref = weakref.ref(fn)
        except TypeError:
            ref = lambda _fn=fn: _fn  # noqa: E731 - constant closure
        with self._mu:
            refs = self._fns.setdefault(name, [])
            if all(r() is not fn for r in refs):
                refs.append(ref)
        return fn

    def per_function(self) -> Dict[str, int]:
        with self._mu:
            items = {k: list(v) for k, v in self._fns.items()}
            out: Dict[str, int] = dict(self._builds)
        dead: Dict[str, list] = {}
        for name, refs in sorted(items.items()):
            n = 0
            for r in refs:
                f = r()
                if f is None:
                    dead.setdefault(name, []).append(r)
                    continue
                try:
                    n += int(f._cache_size())
                except Exception:
                    pass  # a deleted executable must not break telemetry
            out[name] = n
        if dead:
            with self._mu:
                for name, gone in dead.items():
                    refs = self._fns.get(name)
                    if refs is None:
                        continue
                    self._fns[name] = [r for r in refs if r not in gone]
        return out

    def snapshot(self) -> dict:
        return {
            "total": self.total,
            "total_s": round(self.total_s, 4),
            "per_function": self.per_function(),
        }

    def reset_counts(self) -> None:
        with self._mu:
            self.total = 0
            self.total_s = 0.0


def diff_compiles(before: dict, after: dict) -> dict:
    """Measurement-window delta of two CompileWatch.snapshot() dicts:
    steady state builds nothing, so any positive delta is a fault."""
    per = {
        k: n - before.get("per_function", {}).get(k, 0)
        for k, n in after.get("per_function", {}).items()
        if n - before.get("per_function", {}).get(k, 0) > 0
    }
    return {
        "total": after["total"] - before["total"],
        "total_s": round(after["total_s"] - before["total_s"], 4),
        "per_function": per,
    }


# ---------------------------------------------------------------------------
# telemetry history ring (the diagnosis plane's time axis)
# ---------------------------------------------------------------------------

# every history sample is a flight-compatible event: it carries `t`
# (monotonic seconds) and `event`, so tools.timeline merges a history
# ring into a forensic timeline like any other swept artifact, and
# tools.doctor filters the samples back out by event name
HISTORY_EVENT = "history_sample"
HISTORY_SCHEMA = 1
# sampler defaults: 250ms cadence; ring sized so a 4-host fleet keeps
# ~60s of history (one slot per host per tick). Slots are 16x the flight
# ring's 512B because one sample is a whole host snapshot, not a
# breadcrumb — the capped lane table is what keeps it under one slot.
HISTORY_INTERVAL_S = 0.25
HISTORY_MAX_LANES = 16
HISTORY_RING_CAPACITY = 1024
HISTORY_RING_SLOT = 8192

# the counter columns a hot-lane row carries (joined per lane by the
# engines' hot_lane_stats): exactly the per-lane inputs of tools.top's
# heat formula plus the election-outcome pair tools.doctor's quorum
# rules difference — NOT all of CTR_NAMES, so K lane rows stay small
# enough that a full sample fits one history slot
HOT_LANE_COUNTERS = (
    "elections_started",
    "elections_won",
    "replicate_rejects",
    "commit_advances",
    "lease_fallback",
)

# the always-present sampler gauge schema (engine_history_* in the
# Prometheus exposition, `history` fold in the bench JSON): zero-filled
# when no sampler is attached so consumers never branch
HISTORY_STATS_KEYS = (
    "samples_total",
    "errors_total",
    "last_sample_seconds",
    "sample_cost_seconds_total",
    "interval_seconds",
)


def _capped_lanes(eng, max_lanes: int):
    """(rows, total_active) from the engine's capped hot-lane accessor,
    falling back to a full lane_stats fold for engines that predate it.
    Rows are stringified-cluster-id keyed (JSON object keys)."""
    hot = getattr(eng, "hot_lane_stats", None)
    if callable(hot):
        rows, total = hot(max_lanes)
    else:
        stats = eng.lane_stats()
        total = len(stats)
        hottest = sorted(
            stats.items(),
            key=lambda kv: kv[1].get("commit_gap", 0),
            reverse=True,
        )[: max(1, int(max_lanes))]
        rows = dict(hottest)
    out = {}
    for key, row in rows.items():
        if isinstance(key, tuple):  # core-level (host, cluster_id) key
            key = f"{key[0]}:{key[1]}"
        out[str(key)] = row
    return out, int(total)


def sample_host(nh, max_lanes: int = HISTORY_MAX_LANES) -> dict:
    """One bounded snapshot of a live NodeHost's zero-sync stat surfaces
    — the HistorySampler's unit of work, also usable synchronously
    (tools.doctor's in-process ``diagnose`` takes two of these and
    differences them).

    Zero-sync by construction: every source below reads decode-
    maintained numpy mirrors or plain host ints (lane_stats /
    counter_stats / pressure_stats / device_census / lease_stats
    contracts), the WAL barrier ledger, and the serving/placement
    planes' Python counters. Nothing here may touch the device — the
    ``-m perf`` audit in tests/test_profile.py pins it. Sources that
    fail (engine mid-teardown, no serving front) zero-fill and are named
    in the sample's ``errors`` list rather than raising."""
    d = {
        "event": HISTORY_EVENT,
        "schema": HISTORY_SCHEMA,
        "t": round(time.monotonic(), 6),
        "host": getattr(getattr(nh, "config", None), "raft_address", ""),
        "cluster": 0,  # host-level event (flight-recorder convention)
    }
    errors = []
    eng = getattr(nh, "engine", None)

    def _take(name, fn, default):
        try:
            d[name] = fn()
        except Exception:
            d[name] = default
            errors.append(name)

    if eng is not None:
        try:
            rows, total = _capped_lanes(eng, max_lanes)
            d["lanes"] = rows
            d["lanes_total"] = total
            d["lanes_dropped"] = max(0, total - len(rows))
        except Exception:
            d["lanes"], d["lanes_total"], d["lanes_dropped"] = {}, 0, 0
            errors.append("lanes")
        _take("counters", lambda: dict(eng.counter_stats()), {})
        _take("pressure", lambda: dict(eng.pressure_stats()), {})
        _take(
            "lease",
            lambda: dict(eng.lease_stats()),
            {"local": 0, "fallback": 0},
        )

        def _census_lite():
            c = eng.device_census()
            return {
                "hbm_bytes_total": int(c.get("hbm_bytes_total", 0)),
                "hbm_waste_ratio": float(c.get("hbm_waste_ratio", 0.0)),
                "lanes_active": int(c.get("lanes_active", 0)),
            }

        _take("census", _census_lite, {})

        def _fairness_gap():
            fairness = getattr(eng, "fairness_stats", None)
            if fairness is None:
                return 0.0
            return float(fairness().get("recent_max_gap_s", 0.0))

        _take("fairness_gap_s", _fairness_gap, 0.0)
    # host-level clock-fault ledger (tick worker's divergence detector)
    _take(
        "clock_anomalies",
        lambda: int(nh.clock_anomalies()),
        0,
    )
    # WAL durability-barrier ledger: ewma/last fsync-wave latency —
    # tools.doctor's wal_fsync_stall signal
    _take(
        "wal",
        lambda: {
            k: round(float(v), 6) if isinstance(v, float) else int(v)
            for k, v in nh.logdb.barrier_stats().items()
        },
        {},
    )

    # serving/placement planes: observe-only — `_serving`/`_placement`
    # are read lock-free exactly like NodeHost._export_health_gauges
    # does (the sampler must never instantiate a front on an idle host)
    def _serving_fold():
        front = getattr(nh, "_serving", None)
        if front is None:
            return {"admitted": 0, "shed": 0, "queue_depth": 0,
                    "saturation": 0.0}
        admitted = shed = 0
        for row in front.admission.counters().values():
            admitted += sum(row.get("admitted", {}).values())
            shed += sum(row.get("shed", {}).values())
        queue = sum(front.queue_depths().values())
        return {
            "admitted": int(admitted),
            "shed": int(shed),
            "queue_depth": int(queue),
            "saturation": round(float(front.monitor.score()), 6),
        }

    _take(
        "serving",
        _serving_fold,
        {"admitted": 0, "shed": 0, "queue_depth": 0, "saturation": 0.0},
    )

    def _migration_fold():
        plane = getattr(nh, "_placement", None)
        if plane is None:
            return {"started": 0, "completed": 0, "aborted": 0, "active": 0}
        c = plane.counters()
        return {
            "started": int(c.get("migrations_started", 0)),
            "completed": int(c.get("migrations_completed", 0)),
            "aborted": int(c.get("migrations_aborted", 0)),
            "active": int(c.get("active", 0)),
        }

    _take(
        "migrations",
        _migration_fold,
        {"started": 0, "completed": 0, "aborted": 0, "active": 0},
    )
    if errors:
        d["errors"] = errors
    return d


class HistorySampler:
    """Per-process background sampler feeding a crash-persistent history
    ring (the flight ring's MmapRing framing with history-sized slots).

    ``hosts`` is a mapping (key -> NodeHost) or a zero-arg callable
    returning one — the callable form is for fleets whose membership
    changes under the sampler (tools.longhaul crash/restart rounds).
    One slot is written per live host per tick; a host that dies between
    ticks simply stops appearing, and its final pre-crash samples are
    exactly what the ring exists to preserve.

    Entirely off the engines' step path: the thread wakes every
    ``interval_s``, reads the zero-sync surfaces (sample_host) and does
    one json.dumps + MmapRing.write per host. A pre-existing ring at
    ``path`` rotates to ``<path>.prev`` first — same preservation
    contract as FlightRecorder.attach_mmap. ``stop()`` takes one final
    sample so a graceful shutdown's last state is on disk too."""

    def __init__(
        self,
        path: str,
        hosts,
        interval_s: float = HISTORY_INTERVAL_S,
        capacity: int = HISTORY_RING_CAPACITY,
        slot_size: int = HISTORY_RING_SLOT,
        max_lanes: int = HISTORY_MAX_LANES,
    ) -> None:
        self.path = path
        self.interval_s = max(0.01, float(interval_s))
        self.max_lanes = int(max_lanes)
        self._hosts = hosts
        self._mu = threading.Lock()
        try:
            with open(path, "rb") as f:
                had_ring = f.read(len(_RING_MAGIC)) == _RING_MAGIC
            if had_ring:
                os.replace(path, path + ".prev")
        except OSError:
            pass  # no previous ring (or unreadable): nothing to preserve
        self._ring: Optional[MmapRing] = MmapRing(
            path, capacity=capacity, slot_size=slot_size
        )
        # plain-int telemetry (torn reads cost one stale gauge sample)
        self.samples_total = 0
        self.errors_total = 0
        self.last_sample_s = 0.0
        self.cost_s_total = 0.0
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- hosts
    def _host_map(self) -> dict:
        hosts = self._hosts
        if callable(hosts):
            try:
                hosts = hosts()
            except Exception:
                hosts = {}
        return dict(hosts or {})

    # ----------------------------------------------------------- sampling
    def sample_once(self) -> int:
        """Take one sample of every live host NOW (also the final-flush
        path); returns the number of slots written."""
        t0 = time.monotonic()
        with self._mu:
            ring = self._ring
        if ring is None:
            return 0
        wrote = 0
        for _key, nh in sorted(
            self._host_map().items(), key=lambda kv: str(kv[0])
        ):
            if nh is None:
                continue
            try:
                d = sample_host(nh, max_lanes=self.max_lanes)
                ring.write(
                    json.dumps(d, default=str, sort_keys=True).encode()
                )
                wrote += 1
            except Exception:
                # a host mid-crash must never kill the sampler; the gap
                # in its series is itself a diagnostic signal
                self.errors_total += 1
        dt = time.monotonic() - t0
        self.samples_total += wrote
        self.last_sample_s = dt
        self.cost_s_total += dt
        return wrote

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            self.sample_once()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "HistorySampler":
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        t = threading.Thread(
            target=self._run, name="history-sampler", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self, final_sample: bool = True) -> None:
        self._stop_ev.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        if final_sample:
            try:
                self.sample_once()
            except Exception:
                pass
        with self._mu:
            ring, self._ring = self._ring, None
        if ring is not None:
            ring.close()

    def flush(self) -> None:
        with self._mu:
            ring = self._ring
        if ring is not None:
            ring.flush()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The engine_history_* gauge schema (HISTORY_STATS_KEYS)."""
        return {
            "samples_total": int(self.samples_total),
            "errors_total": int(self.errors_total),
            "last_sample_seconds": round(self.last_sample_s, 6),
            "sample_cost_seconds_total": round(self.cost_s_total, 6),
            "interval_seconds": self.interval_s,
        }

    @staticmethod
    def empty_stats() -> dict:
        """Zero-filled stats schema for hosts with no sampler attached —
        gauges and bench JSON keys stay ALWAYS present."""
        return {
            "samples_total": 0,
            "errors_total": 0,
            "last_sample_seconds": 0.0,
            "sample_cost_seconds_total": 0.0,
            "interval_seconds": 0.0,
        }


def read_history(path: str):
    """Recover a (possibly SIGKILL'd) process's history ring: returns
    (meta, samples) with samples seal-ordered; non-sample events that
    share the ring (none today) are filtered out by event name."""
    meta, events = read_mmap_ring(path)
    return meta, [e for e in events if e.get("event") == HISTORY_EVENT]


# ---------------------------------------------------------------------------
# process-global singletons (like trace.flight_recorder: every engine and
# NodeHost in the process feeds one plane, and the exposition/bench folds
# read it without plumbing)
# ---------------------------------------------------------------------------

_phase_plane = PhasePlane()
_sync_audit = SyncAudit()
_compile_watch = CompileWatch()


def phase_plane() -> PhasePlane:
    return _phase_plane


def sync_audit() -> SyncAudit:
    return _sync_audit


def compile_watch() -> CompileWatch:
    return _compile_watch


def note_seam_sync() -> None:
    """The blessed ``_fetch_output``/``_fetch_super`` seams' self-report:
    one integer add per consolidated device->host transfer, always on."""
    _sync_audit.seam += 1


def note_engine_steps(n: int = 1) -> None:
    """Protocol-step accounting for the seam ratio: the decode path
    reports how many engine steps one fetch covered (1 on the classic
    path, K on a multi-step super-step) so ``engine_steps_per_sync``
    stays an honest per-step denominator at any K."""
    _sync_audit.engine_steps += n


def write_exposition(w, prefix: str = _PREFIX) -> None:
    """Append the attribution plane to a Prometheus text exposition:
    the ``engine_phase_seconds`` histograms plus per-function
    build-cache gauges (scalar device-sync/compile counters ride the
    NodeHost MetricsRegistry as ``engine_device_syncs_*`` /
    ``engine_compile_events_total``)."""
    _phase_plane.write(w, prefix)
    per_fn = _compile_watch.per_function()
    if per_fn:
        full = f"{prefix}_engine_compile_cache_entries"
        w.write(f"# TYPE {full} gauge\n")
        for name, n in sorted(per_fn.items()):
            w.write(f"{full}{_labels((('function', name),))} {n}\n")


__all__ = [
    "CENSUS_KEYS",
    "CompileWatch",
    "DeviceCensus",
    "EXEC_PHASES",
    "HISTORY_EVENT",
    "HISTORY_INTERVAL_S",
    "HISTORY_MAX_LANES",
    "HISTORY_STATS_KEYS",
    "HOT_LANE_COUNTERS",
    "HistorySampler",
    "PhasePlane",
    "SyncAudit",
    "VECTOR_PHASES",
    "compile_watch",
    "diff_compiles",
    "diff_sync",
    "note_engine_steps",
    "note_seam_sync",
    "phase_plane",
    "read_history",
    "sample_host",
    "sync_audit",
    "write_exposition",
]
