"""Build, bind and launch the hand-written Hopper kernels.

The CUDA sources under `dragonboat_tpu_torch/csrc/` are compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library per
source (plain C interface, loaded with ctypes), at first use, into
`build/torch_kernels/` at the repository root, keyed by a hash of the
source and the flags; the sources that need a build are compiled in
parallel, one nvcc each. A failed build raises with nvcc's output; nothing
falls back to another implementation.

Wrappers (each checks its tensors, fills the kernel's parameter struct,
launches on PyTorch's current stream and counts the launch in LAUNCHES):

- `step_batch_cuda`: `csrc/step_batch.cu`, one protocol step. Every shape
  comes from the tensors, as in the reference, so a lane block of a larger
  fleet runs with the fleet's cfg.
- `route_columns_cuda`: `csrc/route.cu`'s columns kernel, one lane block's
  candidate record (`kernel.record_words` words: the 11 header rows of
  every candidate, then an entry run per Replicate) and its plan bits
  zeroed.
- `route_step_output_cuda`: the router between inner steps: the columns
  kernel, then the scatter's two passes (the insert pass builds a K-deep
  candidate list per destination lane in a (G, K) scratch, the write pass
  writes the inbox and the plan from it and clears the scratch for its
  next use).
- `ring_gather_cuda`: `csrc/ring_gather.cu`, the candidate exchange between
  the lane blocks of a sharded super-step: every block's record to every
  block.
- `shard_route_cuda`: columns per shard, one gather, both scatter passes
  per shard.

`multi_step_cuda` and `sharded_multi_step_cuda` drive a whole super-step:
stacked outputs allocated once per call, step t's kernels writing slice t,
two preallocated inbox buffers in turn, parameter structs filled once per
call, and no host sync.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .kernel import candidates_per_lane, record_words
from .state import Inbox, KernelConfig, RaftTensors, RoutePlan, StepOutput, CTR, MSG

PMAX, RMAX = 8, 4
KMAX = 8
#: most lane blocks one gather launch takes (csrc/ring_gather.cu)
MAX_SHARDS = 16

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel; a wrapper adds one where it launches its kernel and
#: nowhere else
LAUNCHES: Dict[str, int] = {
    "step_batch": 0, "route_columns": 0, "route_index": 0, "route_scatter": 0,
    "ring_gather": 0,
}

#: a free slot of the scatter's per-lane candidate lists (csrc/route.cu)
ROUTE_EMPTY = 2**31 - 1

#: per source: what ptxas reported when its library was built (kept beside
#: the library, so a library built by an earlier process reports too)
PTXAS: Dict[str, str] = {}

_SOURCES = ("step_batch.cu", "route.cu", "ring_gather.cu")
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc")


def _target(src: str) -> str:
    with open(os.path.join(CSRC, src), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}-{h[:16]}.so")


def build_kernels() -> Dict[str, str]:
    """Compile every source that has no up-to-date library yet, one nvcc
    per source, all started together. Returns source -> library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {src: _target(src) for src in _SOURCES}
    procs = {}
    for src, tgt in targets.items():
        if not (os.path.exists(tgt) and os.path.exists(tgt + ".ptxas")):
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tgt, os.path.join(CSRC, src)]
            procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    failed = []
    for src, p in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {p.returncode}):\n{report}")
        else:
            with open(targets[src] + ".ptxas", "w") as f:
                f.write(report.strip())
    if failed:
        raise RuntimeError("\n".join(failed))
    for src, tgt in targets.items():
        with open(tgt + ".ptxas") as f:
            PTXAS[src] = f.read()
    return targets


_KERNELS = ("step_batch_kernel", "route_columns_kernel", "route_index_kernel",
            "route_scatter_kernel", "ring_gather_kernel")


def kernel_resources() -> Dict[str, Dict[str, int]]:
    """What ptxas reported for each kernel built in this process: kernel
    name -> registers, stack frame bytes, spill store and load bytes and
    static shared memory bytes (dynamic shared memory is set at launch)."""
    res: Dict[str, Dict[str, int]] = {}
    cur = None
    for report in PTXAS.values():
        for line in report.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                cur = next((k for k in _KERNELS if k in line), None)
                continue
            if cur is None:
                continue
            r = res.setdefault(cur, {"registers": 0, "stack_frame": 0, "spill_stores": 0,
                                     "spill_loads": 0, "smem": 0})
            for key, pat in (("stack_frame", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    r[key] = int(m.group(1))
    return res


def step_frame_bytes(P: int, K: int, R: int) -> int:
    """Dynamic shared memory of one step_batch block at (P, K, R)."""
    lib = _lib("step_batch.cu")
    lib.step_batch_frame_bytes.restype = ctypes.c_longlong
    return lib.step_batch_frame_bytes(P, K, R, lib.step_batch_block_lanes())


# ------------------------------------------------------- parameter structs

_PTR_FIELDS = (
    list(RaftTensors._fields)
    + ["in_" + f for f in Inbox._fields]
    + ["ticks"]
    + ["o_" + f for f in StepOutput._fields]
)


class StepParams(ctypes.Structure):
    """Mirror of `struct StepParams` in csrc/step_batch.cu: one pointer per
    tensor in the NamedTuples' field order, then the six shape ints."""

    _fields_ = [(name, ctypes.c_void_p) for name in _PTR_FIELDS] + [
        (n, ctypes.c_int32) for n in ("G", "P", "W", "K", "E", "R")
    ]


_COL_STATE = ("self_slot", "log_term", "log_is_cc")
_COL_OUT = (
    "send_flags", "send_prev_index", "send_prev_term", "send_n_entries",
    "send_commit", "send_hb_commit", "send_hint", "send_hint2",
    "vote_last_index", "vote_last_term", "resp_type", "resp_to", "resp_term",
    "resp_log_index", "resp_reject", "resp_hint", "resp_hint2", "ready_ctx",
    "ready_ctx2", "ready_index", "ready_count", "term", "role", "lease_round",
)
#: RouteColumnsParams' names of the _COL_OUT planes
_COL_OUT_NAMES = ["o_" + f if f in ("term", "role") else f for f in _COL_OUT]
_PLAN = ["plan_" + f for f in RoutePlan._fields]


class RouteColumnsParams(ctypes.Structure):
    """Mirror of `struct RouteColumnsParams` in csrc/route.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _COL_STATE]
        + [(f, ctypes.c_void_p) for f in _COL_OUT_NAMES]
        + [(f, ctypes.c_void_p) for f in ("route", "rdelta", "record", *_PLAN)]
        + [(n, ctypes.c_int32) for n in ("G", "P", "K", "R", "E", "W", "M")]
    )


class RouteScatterParams(ctypes.Structure):
    """Mirror of `struct RouteScatterParams` in csrc/route.cu."""

    _fields_ = (
        [("gathered", ctypes.c_void_p), ("slots", ctypes.c_void_p)]
        + [(f, ctypes.c_void_p) for f in Inbox._fields]
        + [(f, ctypes.c_void_p) for f in _PLAN]
        + [(n, ctypes.c_int32) for n in ("n", "Gl", "P", "K", "R", "E", "M", "my")]
    )


class RingGatherParams(ctypes.Structure):
    """Mirror of `struct RingGatherParams` in csrc/ring_gather.cu."""

    _fields_ = [
        ("src", ctypes.c_void_p * MAX_SHARDS),
        ("dst", ctypes.c_void_p * MAX_SHARDS),
        ("L", ctypes.c_int64),
        ("n", ctypes.c_int32),
    ]


# source -> (launch function, its parameter struct, the struct-size query)
_ENTRIES = {
    "step_batch.cu": (("step_batch_launch", StepParams, "step_batch_params_size"),),
    "route.cu": (
        ("route_columns_launch", RouteColumnsParams, "route_columns_params_size"),
        ("route_index_launch", RouteScatterParams, "route_scatter_params_size"),
        ("route_scatter_launch", RouteScatterParams, "route_scatter_params_size"),
    ),
    "ring_gather.cu": (("ring_gather_launch", RingGatherParams, "ring_gather_params_size"),),
}


def _lib(src: str) -> ctypes.CDLL:
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(build_kernels()[src])
            for fn, struct, size_fn in _ENTRIES[src]:
                getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, size_fn).restype = ctypes.c_int
                if getattr(lib, size_fn)() != ctypes.sizeof(struct):
                    raise RuntimeError(f"{src}'s {struct.__name__} does not match ops/cuda.py")
            _libs[src] = lib
        return _libs[src]


class _Launcher:
    """Launch functions of the built libraries, bound to the current stream
    of one device; each launch is checked and counted."""

    def __init__(self, device):
        with torch.cuda.device(device):
            self.stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        self.fns = {fn: getattr(_lib(src), fn)
                    for src, entries in _ENTRIES.items() for fn, _, _ in entries}

    def __call__(self, fn: str, params, counter: str) -> None:
        err = self.fns[fn](ctypes.byref(params), self.stream)
        if err != 0:
            raise RuntimeError(f"{fn} failed: cudaError {err}")
        LAUNCHES[counter] += 1

    def scatter(self, params) -> None:
        """The scatter's two passes, in stream order."""
        self("route_index_launch", params, "route_index")
        self("route_scatter_launch", params, "route_scatter")


def _on_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on a CUDA device, got {t.device}")
    return t.device


def _check(what: str, name: str, t, shape, dtype, dev) -> int:
    """Check one tensor; return its address."""
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"{what}: {name} must be a tensor on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: {name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    return t.data_ptr()


def _put(p, names, addrs) -> None:
    for name, a in zip(names, addrs):
        setattr(p, name, a)


def _copy(p):
    return type(p).from_buffer_copy(p)


# ------------------------------------------------------------- step_batch


@functools.lru_cache(maxsize=None)
def _expected(G: int, P: int, W: int, K: int, E: int, R: int):
    """name -> (shape, dtype) for every tensor the step kernel takes."""
    from .state import init_state, make_empty_inbox

    small = KernelConfig(groups=1, peers=P, log_window=W, inbox_depth=K,
                         max_entries_per_msg=E, readindex_depth=R)
    exp = {}
    s = init_state(small, device="cpu")
    for f in RaftTensors._fields:
        t = getattr(s, f)
        exp[f] = ((G,) + tuple(t.shape[1:]), t.dtype)
    ib = make_empty_inbox(small, device="cpu")
    for f in Inbox._fields:
        t = getattr(ib, f)
        exp["in_" + f] = ((G,) + tuple(t.shape[1:]), t.dtype)
    exp["ticks"] = ((G,), torch.int32)
    for f, shape, dt in _output_layout(G, P, K, R):
        exp["o_" + f] = (shape, dt)
    return exp


def _output_layout(G, P, K, R):
    b, i = torch.bool, torch.int32
    planes = {
        "resp_reject": ((G, K), b), "hard_changed": ((G,), b),
        "dropped_cc": ((G,), b), "log_full": ((G,), b), "quiesced": ((G,), b),
        "lease_ok": ((G,), b), "counters": ((G, CTR.COUNT), torch.uint32),
    }
    gp = {"send_flags", "send_prev_index", "send_prev_term", "send_n_entries",
          "send_commit", "send_hb_commit", "send_hint", "send_hint2", "match",
          "rstate"}
    gk = {"resp_type", "resp_to", "resp_term", "resp_log_index", "resp_hint",
          "resp_hint2", "prop_base", "rep_base"}
    gr = {"ready_ctx", "ready_ctx2", "ready_index"}
    for f in StepOutput._fields:
        if f in planes:
            shape, dt = planes[f]
        elif f in gp:
            shape, dt = (G, P), i
        elif f in gk:
            shape, dt = (G, K), i
        elif f in gr:
            shape, dt = (G, R), i
        else:
            shape, dt = (G,), i
        yield f, shape, dt


def step_shapes(s: RaftTensors, inbox: Inbox) -> Tuple[int, int, int, int, int, int]:
    """(G, P, W, K, E, R) of one step, taken from the tensors as the
    reference does: G and P from s.member, W from s.log_term, K from
    inbox.mtype, E from inbox.entry_terms, R from s.ri_ctx."""
    G, P = s.member.shape
    return (G, P, s.log_term.shape[1], inbox.mtype.shape[1],
            inbox.entry_terms.shape[2], s.ri_ctx.shape[1])


def empty_output(cfg: KernelConfig, device) -> StepOutput:
    """Uninitialised StepOutput buffers for `cfg` on `device`."""
    return _alloc_output(cfg.groups, cfg.peers, cfg.inbox_depth, cfg.readindex_depth, device)


def _alloc_output(G, P, K, R, device, steps=None) -> StepOutput:
    """StepOutput buffers, stacked over a leading step axis when `steps`
    is given."""
    lead = () if steps is None else (steps,)
    return StepOutput(*(
        torch.empty(lead + tuple(shape), dtype=dt, device=device)
        for _, shape, dt in _output_layout(G, P, K, R)
    ))


def make_params(s: RaftTensors, inbox: Inbox, ticks, out: StepOutput,
                cfg: Optional[KernelConfig] = None) -> StepParams:
    """Check every tensor (one device, dtype, shape, contiguity) and fill
    the kernel's parameter struct with their addresses. The shapes come
    from the tensors (step_shapes); `cfg` is not needed for them, so a lane
    block runs with the whole fleet's cfg. `out` may hold the t-th slices
    of stacked (K, G, ...) planes: those are contiguous."""
    G, P, W, K, E, R = step_shapes(s, inbox)
    if not (1 <= P <= PMAX and 1 <= R <= RMAX and 1 <= K <= KMAX):
        raise ValueError(
            f"step_batch kernel takes peers <= {PMAX}, readindex_depth <= {RMAX}, "
            f"inbox_depth <= {KMAX}; got P={P} R={R} K={K}"
        )
    if W < 1 or E < 1:
        raise ValueError("log_window and max_entries_per_msg must be >= 1")
    tensors = dict(zip(RaftTensors._fields, s))
    tensors.update(("in_" + f, t) for f, t in zip(Inbox._fields, inbox))
    tensors["ticks"] = ticks
    tensors.update(("o_" + f, t) for f, t in zip(StepOutput._fields, out))
    exp = _expected(G, P, W, K, E, R)
    dev = s.term.device
    p = StepParams()
    for name in _PTR_FIELDS:
        shape, dt = exp[name]
        setattr(p, name, _check("step_batch", name, tensors[name], shape, dt, dev))
    p.G, p.P, p.W, p.K, p.E, p.R = G, P, W, K, E, R
    return p


def prepare_step(
    s: RaftTensors, inbox: Inbox, ticks, cfg: Optional[KernelConfig] = None,
    out: Optional[StepOutput] = None,
) -> Tuple[StepParams, StepOutput]:
    """Check the tensors and fill the parameter struct for one launch of
    csrc/step_batch.cu (allocating `out` when None)."""
    _on_cuda(s.term, "step_batch kernel")
    if out is None:
        G, P, _, K, _, R = step_shapes(s, inbox)
        out = _alloc_output(G, P, K, R, s.term.device)
    return make_params(s, inbox, ticks, out, cfg), out


def launch_step(params: StepParams, device) -> None:
    """Launch csrc/step_batch.cu with prepared parameters on the current
    stream of `device`; raises when the launch is refused."""
    _Launcher(device)("step_batch_launch", params, "step_batch")


def step_batch_cuda(
    s: RaftTensors, inbox: Inbox, ticks, cfg: Optional[KernelConfig] = None,
    out: Optional[StepOutput] = None,
) -> Tuple[RaftTensors, StepOutput]:
    """One step for every lane on the card: the state tensors are updated in
    place and returned; `out` (preallocated StepOutput buffers) is filled,
    or allocated when None."""
    params, out = prepare_step(s, inbox, ticks, cfg, out)
    launch_step(params, s.term.device)
    return s, out


# ----------------------------------------------------------------- router


def _alloc_inbox(G, K, E, device) -> Inbox:
    i32, b = torch.int32, torch.bool
    shapes = [((G, K), i32)] * 6 + [((G, K), b)] + [((G, K), i32)] * 3 + [
        ((G, K, E), i32), ((G, K, E), b)]
    return Inbox(*(torch.empty(s, dtype=dt, device=device) for s, dt in shapes))


def alloc_slots(G: int, K: int, device) -> torch.Tensor:
    """The scatter's (G, K) per-lane candidate lists, every slot free; the
    write pass leaves them free again, so one scratch serves every call
    of a super-step."""
    return torch.full((G, K), ROUTE_EMPTY, dtype=torch.int32, device=device)


def _alloc_plan(G, P, K, R, device, steps=None) -> RoutePlan:
    lead = () if steps is None else (steps,)
    shapes = [(G, P)] * 4 + [(G, K), (G, R)]
    return RoutePlan(*(torch.empty(lead + s, dtype=torch.bool, device=device) for s in shapes))


def _alloc_record(G: int, cfg: KernelConfig, device) -> torch.Tensor:
    return torch.empty((record_words(G, cfg),), dtype=torch.int32, device=device)


def _columns_params(s: RaftTensors, out: StepOutput, route, rdelta, record,
                    plan: RoutePlan, cfg: KernelConfig) -> RouteColumnsParams:
    """Check the router's inputs for one lane block (tensors on any one
    device; the launchers take only the card's) and fill the columns
    kernel's struct."""
    what = "route_columns"
    G, P = s.member.shape
    W = s.log_term.shape[1]
    K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    dev = s.term.device
    i32, b = torch.int32, torch.bool
    p = RouteColumnsParams()
    p.self_slot = _check(what, "self_slot", s.self_slot, (G,), i32, dev)
    p.log_term = _check(what, "log_term", s.log_term, (G, W), i32, dev)
    p.log_is_cc = _check(what, "log_is_cc", s.log_is_cc, (G, W), b, dev)
    exp = dict((f, (shape, dt)) for f, shape, dt in _output_layout(G, P, K, R))
    for f, name in zip(_COL_OUT, _COL_OUT_NAMES):
        shape, dt = exp[f]
        setattr(p, name, _check(what, "out." + f, getattr(out, f), shape, dt, dev))
    p.route = _check(what, "route", route, (G, P), i32, dev)
    p.rdelta = _check(what, "rdelta", rdelta, (G, P), i32, dev)
    p.record = _check(what, "record", record, (record_words(G, cfg),), i32, dev)
    for f, t, shape in zip(_PLAN, plan, [(G, P)] * 4 + [(G, K), (G, R)]):
        setattr(p, f, _check(what, f, t, shape, b, dev))
    p.G, p.P, p.K, p.R, p.E, p.W = G, P, K, R, E, W
    p.M = G * candidates_per_lane(cfg)
    return p


def _scatter_params(gathered, slots, n: int, my: int, Gl: int, P: int, nxt: Inbox,
                    plan: RoutePlan, cfg: KernelConfig) -> RouteScatterParams:
    """Check one shard's scatter inputs and outputs and fill the struct of
    the scatter's two passes (`gathered` is the (n, L) stack of the n
    shards' records, for n = 1 also one record; `slots` the (n * Gl, K)
    scratch of alloc_slots)."""
    what = "route_scatter"
    K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    dev = gathered.device
    L = record_words(Gl, cfg)
    p = RouteScatterParams()
    p.gathered = _check(what, "gathered", gathered[None] if gathered.dim() == 1 else gathered,
                        (n, L), torch.int32, dev)
    p.slots = _check(what, "slots", slots, (n * Gl, K), torch.int32, dev)
    ref = _alloc_inbox(1, K, E, "cpu")
    for f, t, r in zip(Inbox._fields, nxt, ref):
        setattr(p, f, _check(what, "next." + f, t, (Gl,) + tuple(r.shape[1:]), r.dtype, dev))
    for f, t, shape in zip(_PLAN, plan, [(Gl, P)] * 4 + [(Gl, K), (Gl, R)]):
        setattr(p, f, _check(what, f, t, shape, torch.bool, dev))
    p.n, p.Gl, p.P, p.K, p.R, p.E, p.my = n, Gl, P, K, R, E, my
    p.M = Gl * candidates_per_lane(cfg)
    return p


def route_columns_cuda(
    s: RaftTensors, out: StepOutput, route, rdelta, cfg: KernelConfig,
    record: Optional[torch.Tensor] = None, plan: Optional[RoutePlan] = None,
) -> Tuple[torch.Tensor, RoutePlan]:
    """The columns kernel alone (csrc/route.cu) for one lane block: its
    candidate record, equal to kernel._pack_record of the plain columns,
    and its RoutePlan bits zeroed (both allocated when None)."""
    dev = _on_cuda(s.term, "route_columns")
    G, P = s.member.shape
    record = _alloc_record(G, cfg, dev) if record is None else record
    plan = _alloc_plan(G, P, cfg.inbox_depth, cfg.readindex_depth, dev) if plan is None else plan
    _Launcher(dev)("route_columns_launch", _columns_params(s, out, route, rdelta, record, plan,
                                                           cfg), "route_columns")
    return record, plan


def route_step_output_cuda(
    s: RaftTensors, out: StepOutput, route, rdelta, cfg: KernelConfig,
    nxt: Optional[Inbox] = None, plan: Optional[RoutePlan] = None,
) -> Tuple[Inbox, RoutePlan]:
    """The router on the card (csrc/route.cu): the columns kernel writes
    the candidate record; the scatter's insert and write passes read it as
    a gather of one shard and write the next Inbox and the RoutePlan
    (allocated when None)."""
    dev = _on_cuda(s.term, "route_step_output")
    G, P = s.member.shape
    K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    nxt = _alloc_inbox(G, K, E, dev) if nxt is None else nxt
    record, plan = route_columns_cuda(s, out, route, rdelta, cfg, plan=plan)
    _Launcher(dev).scatter(
        _scatter_params(record, alloc_slots(G, K, dev), 1, 0, G, P, nxt, plan, cfg))
    return nxt, plan


# --------------------------------------------------------- candidate gather


def _gather_params(records: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    n = len(records)
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"ring_gather takes 1 to {MAX_SHARDS} shards, got {n}")
    dev = records[0].device
    shape = tuple(records[0].shape)
    p = RingGatherParams()
    for i, (x, y) in enumerate(zip(records, outs)):
        p.src[i] = _check("ring_gather", f"record {i}", x, shape, torch.int32, dev)
        p.dst[i] = _check("ring_gather", f"out {i}", y, (n,) + shape, torch.int32, dev)
    p.L, p.n = records[0].numel(), n
    return p


def ring_gather_cuda(records: Sequence[torch.Tensor],
                     outs: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """All-gather of n equal-shape i32 tensors on one card
    (csrc/ring_gather.cu), the lane blocks' candidate records on the card
    path: every shard gets the (n, ...) stack, shard-major; `outs` are
    preallocated stacks or None."""
    dev = _on_cuda(records[0], "ring_gather")
    n = len(records)
    if outs is None:
        outs = [torch.empty((n,) + tuple(records[0].shape), dtype=torch.int32, device=dev)
                for _ in range(n)]
    p = _gather_params(records, outs)
    _Launcher(dev)("ring_gather_launch", p, "ring_gather")
    return list(outs)


def shard_route_cuda(states, outs, routes, rdeltas, cfg: KernelConfig):
    """The cross-shard router on the card: the columns kernel per shard,
    one gather launch of the records, the scatter's two passes per shard
    (each replaying the insert over every shard's candidates, and writing
    its own inbox rows and its own candidates' plan bits)."""
    n = len(states)
    dev = _on_cuda(states[0].term, "shard_route")
    Gl, P = states[0].member.shape
    K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
    records = [_alloc_record(Gl, cfg, dev) for _ in range(n)]
    gathered = [torch.empty((n, record_words(Gl, cfg)), dtype=torch.int32, device=dev)
                for _ in range(n)]
    nxts = [_alloc_inbox(Gl, K, E, dev) for _ in range(n)]
    plans = [_alloc_plan(Gl, P, K, R, dev) for _ in range(n)]
    cols = [_columns_params(*a, cfg) for a in zip(states, outs, routes, rdeltas, records, plans)]
    gp = _gather_params(records, gathered)
    scat = [_scatter_params(gathered[i], alloc_slots(n * Gl, K, dev), n, i, Gl, P, nxts[i],
                            plans[i], cfg) for i in range(n)]
    launch = _Launcher(dev)
    for p in cols:
        launch("route_columns_launch", p, "route_columns")
    launch("ring_gather_launch", gp, "ring_gather")
    for p in scat:
        launch.scatter(p)
    return nxts, plans


# ------------------------------------------------------------- super-steps


class _Block:
    """The buffers and per-step parameter structs of one lane block for one
    super-step call. Step t's kernel reads inbox buffer `cur(t)` and writes
    slice t of the stacked outputs; the router writes the next inbox into
    the other buffer, and the last inner step's router writes into the
    caller's residual, which is how the residual is updated in place."""

    def __init__(self, s, inbox, ticks, resid, route, rdelta, cfg, steps, n, my, gathered):
        from .kernel import merge_residual

        dev = s.term.device
        G, P = s.member.shape
        K, R, E = cfg.inbox_depth, cfg.readindex_depth, cfg.max_entries_per_msg
        for what, t in (("inbox", inbox), ("resid", resid)):
            if tuple(t.mtype.shape) != (G, K) or tuple(t.entry_terms.shape) != (G, K, E):
                raise ValueError(f"multi_step: {what} must be [{G}, {K}] x E={E}")
        self.s, self.resid = s, resid
        self.bufs = (merge_residual(resid, inbox), _alloc_inbox(G, K, E, dev))
        self.outs = _alloc_output(G, P, K, R, dev, steps)
        self.plans = _alloc_plan(G, P, K, R, dev, steps)
        self.record = _alloc_record(G, cfg, dev)
        self.slots = alloc_slots(n * G, K, dev)
        zeros = torch.zeros_like(ticks)
        at = lambda tree, t: type(tree)(*(x[t] for x in tree))
        # full checks once, on step 0's tensors; later steps differ only in
        # the addresses of the inbox buffers, the ticks and the step slices
        step0 = make_params(s, self.bufs[0], ticks, at(self.outs, 0), cfg)
        cols0 = _columns_params(s, at(self.outs, 0), route, rdelta, self.record,
                                at(self.plans, 0), cfg)
        g = self.record if gathered is None else gathered
        # the caller's residual is written in place by the last inner step
        scat0 = _scatter_params(g, self.slots, n, my, G, P, resid, at(self.plans, 0), cfg)
        # per step only addresses change: slice t of a stacked plane lies t
        # steps' bytes after slice 0, and the inbox buffers take turns
        rows = lambda tree: [(x.data_ptr(), x.stride(0) * x.element_size()) for x in tree]
        outs_at, plans_at = rows(self.outs), rows(self.plans)
        ptrs = {id(b): [x.data_ptr() for x in b] for b in (*self.bufs, resid)}
        in_names = ["in_" + f for f in Inbox._fields]
        o_names = ["o_" + f for f in StepOutput._fields]
        col_at = [StepOutput._fields.index(f) for f in _COL_OUT]
        self.step_p, self.cols_p, self.scat_p = [], [], []
        for t in range(steps):
            o_t = [base + t * sb for base, sb in outs_at]
            p_t = [base + t * sb for base, sb in plans_at]
            sp, cp, xp = _copy(step0), _copy(cols0), _copy(scat0)
            _put(sp, in_names, ptrs[id(self.cur(t, steps))])
            sp.ticks = (ticks if t == 0 else zeros).data_ptr()
            _put(sp, o_names, o_t)
            _put(cp, _COL_OUT_NAMES, [o_t[i] for i in col_at])
            _put(cp, _PLAN, p_t)
            _put(xp, Inbox._fields, ptrs[id(self.nxt(t, steps))])
            _put(xp, _PLAN, p_t)
            self.step_p.append(sp)
            self.cols_p.append(cp)
            self.scat_p.append(xp)
        self._keep = (ticks, zeros, route, rdelta, gathered)

    def nxt(self, t, steps):
        return self.resid if t == steps - 1 else self.bufs[(t + 1) % 2]

    def cur(self, t, steps):
        return self.bufs[0] if t == 0 else self.nxt(t - 1, steps)

    def result(self):
        from .kernel import resid_count

        return self.s, self.outs, self.plans, self.resid, resid_count(self.resid)


def multi_step_cuda(s, inbox, ticks, resid, route, rdelta, cfg: KernelConfig, steps: int):
    """The super-step on the card: per inner step one step_batch launch,
    one route_columns launch and the scatter's two launches (route_index,
    route_scatter; the scatter reads the record as a gather of one shard; no
    gather is launched)."""
    dev = _on_cuda(s.term, "multi_step")
    blk = _Block(s, inbox, ticks, resid, route, rdelta, cfg, steps, 1, 0, None)
    launch = _Launcher(dev)
    for t in range(steps):
        launch("step_batch_launch", blk.step_p[t], "step_batch")
        launch("route_columns_launch", blk.cols_p[t], "route_columns")
        launch.scatter(blk.scat_p[t])
    return blk.result()


def sharded_multi_step_cuda(states, inboxes, ticks, resids, routes, rdeltas,
                            cfg: KernelConfig, steps: int):
    """The sharded super-step on one card: per inner step n step_batch
    launches, n route_columns launches, one ring_gather launch covering all
    n destinations, and the scatter's two launches per shard."""
    n = len(states)
    dev = _on_cuda(states[0].term, "sharded_multi_step")
    Gl = states[0].member.shape[0]
    gathered = [torch.empty((n, record_words(Gl, cfg)), dtype=torch.int32, device=dev)
                for _ in range(n)]
    blks = [_Block(states[i], inboxes[i], ticks[i], resids[i], routes[i], rdeltas[i], cfg,
                   steps, n, i, gathered[i]) for i in range(n)]
    gp = _gather_params([b.record for b in blks], gathered)
    launch = _Launcher(dev)
    for t in range(steps):
        for b in blks:
            launch("step_batch_launch", b.step_p[t], "step_batch")
        for b in blks:
            launch("route_columns_launch", b.cols_p[t], "route_columns")
        launch("ring_gather_launch", gp, "ring_gather")
        for b in blks:
            launch.scatter(b.scat_p[t])
    res = [b.result() for b in blks]
    return tuple(tuple(r[k] for r in res) for k in range(5))
