"""dragonboat_tpu_torch: the device core of dragonboat-tpu in PyTorch.

Thousands of Raft groups run as lanes of one tensor state, and one kernel
launch advances all of them a protocol step. On an NVIDIA H100 the step is
a CUDA kernel written by hand for Hopper (`csrc/step_batch.cu`); on the CPU
the plain PyTorch version runs instead. Entry points take `device=` and
default to the card.

This package imports torch and numpy only, never jax and never the JAX
package `dragonboat_tpu`, which stays the reference it is tested against.
"""
from .ops import (
    KernelConfig,
    RaftTensors,
    Inbox,
    StepOutput,
    MSG,
    ROLE,
    RSTATE,
    init_state,
    make_empty_inbox,
    step_batch,
    make_step_fn,
)

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
