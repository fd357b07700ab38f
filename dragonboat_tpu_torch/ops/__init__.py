"""Vectorized multi-group Raft protocol kernels (PyTorch + CUDA).

The whole fleet of groups is a struct-of-arrays over a (groups, peers)
layout, and one kernel launch advances all of them per step. On the card
the step is a hand-written CUDA kernel (`csrc/step_batch.cu`); on the CPU
it is the plain PyTorch version in `ops.kernel`.
"""
from .state import (
    KernelConfig,
    RaftTensors,
    Inbox,
    StepOutput,
    MSG,
    ROLE,
    RSTATE,
    init_state,
    make_empty_inbox,
)
from .kernel import step_batch, make_step_fn

__all__ = [
    "KernelConfig",
    "RaftTensors",
    "Inbox",
    "StepOutput",
    "MSG",
    "ROLE",
    "RSTATE",
    "init_state",
    "make_empty_inbox",
    "step_batch",
    "make_step_fn",
]
