"""Carry kernel state across: numpy-readable trees <-> torch NamedTuples.

`state_from_numpy` accepts a NamedTuple or a dict whose leaves `np.asarray`
accepts (numpy arrays, or another framework's arrays, which convert through
their `__array__`), so a caller can hand the JAX package's pytrees over
without this package importing that framework. Dtypes are kept bit for bit:
bool stays bool, int32 stays int32, and the uint32 planes (`seed`,
`counters`) stay uint32. Shapes are kept as they are, so a stacked tree
with a leading step axis `(K, G, ...)` (the per-step StepOutput and
RoutePlan of a super-step) converts like a plain one.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Type, Union

import numpy as np
import torch

from .state import Inbox, RaftTensors, RoutePlan, StepOutput, resolve_device

_KINDS = (RaftTensors, Inbox, StepOutput, RoutePlan)
Tree = Union[RaftTensors, Inbox, StepOutput, RoutePlan]


def _kind_of(tree) -> Type[NamedTuple]:
    fields = tuple(tree.keys()) if isinstance(tree, Mapping) else tree._fields
    for kind in _KINDS:
        if fields == kind._fields:
            return kind
    raise TypeError(
        f"not a RaftTensors/Inbox/StepOutput/RoutePlan tree: {fields[:4]}...")


def state_from_numpy(tree: Union[Mapping, NamedTuple], device="cuda") -> Tree:
    """Build the port's NamedTuple (RaftTensors, Inbox, StepOutput or
    RoutePlan, told apart by the field names) from numpy-readable leaves,
    on `device`."""
    dev = resolve_device(device)
    kind = _kind_of(tree)
    get = tree.__getitem__ if isinstance(tree, Mapping) else tree.__getattribute__
    leaves = {}
    for name in kind._fields:
        a = np.ascontiguousarray(np.asarray(get(name)))
        leaves[name] = torch.from_numpy(a.copy()).to(dev)
    return kind(**leaves)


def state_to_numpy(tree: Tree) -> dict:
    """Field name -> numpy array (on the host), dtypes and shapes unchanged."""
    return {name: getattr(tree, name).cpu().numpy() for name in tree._fields}
