"""Build, bind and launch the hand-written Hopper kernels.

The CUDA sources under `dragonboat_tpu_torch/csrc/` are compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library per
source (plain C interface, loaded with ctypes), at first use, into
`build/torch_kernels/` at the repository root, keyed by a hash of the
source and the flags. A failed build raises with nvcc's output; nothing
falls back to another implementation.

`step_batch_cuda` is the wrapper of `csrc/step_batch.cu`: it checks every
tensor, fills the kernel's parameter struct, launches on PyTorch's current
stream and counts the launch in LAUNCHES.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

from .state import Inbox, KernelConfig, RaftTensors, StepOutput, CTR

PMAX, RMAX = 8, 4
KMAX = 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel wrapper; a wrapper adds one where it launches its
#: kernel and nowhere else
LAUNCHES: Dict[str, int] = {"step_batch": 0}

#: per source built in this process: what ptxas reported
PTXAS: Dict[str, str] = {}

_SOURCES = ("step_batch.cu",)
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
    per source. Returns source -> library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {src: _target(src) for src in _SOURCES}
    for src, tgt in targets.items():
        if os.path.exists(tgt):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tgt, os.path.join(CSRC, src)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {p.returncode}):\n"
                               f"{p.stdout}{p.stderr}")
        PTXAS[src] = (p.stdout + p.stderr).strip()
    return targets


def _lib(src: str) -> ctypes.CDLL:
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(build_kernels()[src])
            lib.step_batch_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.step_batch_launch.restype = ctypes.c_int
            lib.step_batch_params_size.restype = ctypes.c_int
            if lib.step_batch_params_size() != ctypes.sizeof(StepParams):
                raise RuntimeError("step_batch.cu's StepParams does not match ops/cuda.py")
            _libs[src] = lib
        return _libs[src]


# ------------------------------------------------------------- parameters

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


@functools.lru_cache(maxsize=None)
def _expected(cfg: KernelConfig):
    """name -> (shape, dtype) for every tensor the kernel takes."""
    from .state import init_state, make_empty_inbox

    G, P, W, K, E, R = (cfg.groups, cfg.peers, cfg.log_window, cfg.inbox_depth,
                        cfg.max_entries_per_msg, cfg.readindex_depth)
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


def empty_output(cfg: KernelConfig, device) -> StepOutput:
    """Uninitialised StepOutput buffers for `cfg` on `device`."""
    G, P, K, R = cfg.groups, cfg.peers, cfg.inbox_depth, cfg.readindex_depth
    return StepOutput(*(
        torch.empty(shape, dtype=dt, device=device)
        for _, shape, dt in _output_layout(G, P, K, R)
    ))


def make_params(s: RaftTensors, inbox: Inbox, ticks, out: StepOutput,
                cfg: KernelConfig) -> StepParams:
    """Check every tensor (one device, dtype, shape, contiguity) and fill
    the kernel's parameter struct with their addresses."""
    G, P, K, R = cfg.groups, cfg.peers, cfg.inbox_depth, cfg.readindex_depth
    if not (1 <= P <= PMAX and 1 <= R <= RMAX and 1 <= K <= KMAX):
        raise ValueError(
            f"step_batch kernel takes peers <= {PMAX}, readindex_depth <= {RMAX}, "
            f"inbox_depth <= {KMAX}; got P={P} R={R} K={K}"
        )
    if cfg.log_window < 1 or cfg.max_entries_per_msg < 1:
        raise ValueError("log_window and max_entries_per_msg must be >= 1")
    tensors = dict(zip(RaftTensors._fields, s))
    tensors.update(("in_" + f, t) for f, t in zip(Inbox._fields, inbox))
    tensors["ticks"] = ticks
    tensors.update(("o_" + f, t) for f, t in zip(StepOutput._fields, out))
    exp = _expected(cfg)
    dev = s.term.device
    p = StepParams()
    for name in _PTR_FIELDS:
        t = tensors[name]
        shape, dt = exp[name]
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"step_batch: {name} must be a tensor on {dev}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"step_batch: {name} must be {dt} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"step_batch: {name} must be contiguous")
        setattr(p, name, t.data_ptr())
    p.G, p.P, p.W, p.K = G, P, cfg.log_window, K
    p.E, p.R = cfg.max_entries_per_msg, R
    return p


def prepare_step(
    s: RaftTensors, inbox: Inbox, ticks, cfg: KernelConfig,
    out: Optional[StepOutput] = None,
) -> Tuple[StepParams, StepOutput]:
    """Check the tensors and fill the parameter struct for one launch of
    csrc/step_batch.cu (allocating `out` when None)."""
    if s.term.device.type != "cuda":
        raise ValueError(f"step_batch kernel: tensors must be on a CUDA device, "
                         f"got {s.term.device}")
    if out is None:
        out = empty_output(cfg, s.term.device)
    return make_params(s, inbox, ticks, out, cfg), out


def launch_step(params: StepParams, device) -> None:
    """Launch csrc/step_batch.cu with prepared parameters on the current
    stream of `device`; raises when the launch is refused."""
    lib = _lib("step_batch.cu")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.step_batch_launch(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"step_batch kernel launch failed: cudaError {err}")
    LAUNCHES["step_batch"] += 1


def step_batch_cuda(
    s: RaftTensors, inbox: Inbox, ticks, cfg: KernelConfig,
    out: Optional[StepOutput] = None,
) -> Tuple[RaftTensors, StepOutput]:
    """One step for every lane on the card: the state tensors are updated in
    place and returned; `out` (preallocated StepOutput buffers) is filled,
    or allocated when None."""
    params, out = prepare_step(s, inbox, ticks, cfg, out)
    launch_step(params, s.term.device)
    return s, out
