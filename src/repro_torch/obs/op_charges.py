"""Where work done outside the dispatcher is charged: the registry of
active op counters.

A kernel entry's meta route (``kernels/*/ops.py``) and the explicit row
moves of ``sharding/collectives.py`` charge their work to every counter
active here; ``launch.op_cost.OpCounter`` (the dry run's) registers
itself while it runs.  With no counter active a charge is a no-op, so the
serving path pays one empty loop.  A counter may also run a kernel's meta
route itself (``meta_call``): the dry run's runs it on each rank's blocks
where the arguments are ``DTensor``s.  Imports only the standard library.
"""
from __future__ import annotations

from typing import List, Optional

# the collective kinds a counter keeps (the HLO parser's, in the JAX package)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_ACTIVE: List[object] = []


def activate(counter) -> None:
    _ACTIVE.append(counter)


def deactivate(counter) -> None:
    _ACTIVE.remove(counter)


def charge_kernel(name: str, cost: dict) -> None:
    """Charge every active counter a kernel call's ``cost(...)`` (its meta
    route: nothing launches, nothing counts a launch)."""
    for c in _ACTIVE:
        c.kernel(name, cost)


def charge_collective(kind: str, n_bytes: int) -> None:
    """Charge every active counter ``n_bytes`` of a collective of ``kind``
    (one of ``KINDS``) moved outside DTensor."""
    for c in _ACTIVE:
        c.collective(kind, n_bytes)


def meta_call(fn, *args, kv_head_dim: Optional[int] = None, **kwargs):
    """A kernel entry's meta route, ``fn(*args, **kwargs)``: ``fn`` charges
    the kernel's cost and returns outputs of the right shapes.  The
    innermost active counter runs it instead (``counter.kernel_call``),
    which places ``DTensor`` arguments.  ``kv_head_dim`` marks an attention
    call: ``args[0]`` is q (rows at dim 0, heads at dim 2), ``args[1:3]`` K
    and V with their heads at that dim, and rows and heads are
    independent; without it the call reads its arguments whole."""
    if _ACTIVE:
        return _ACTIVE[-1].kernel_call(fn, args, kwargs, kv_head_dim)
    return fn(*args, **kwargs)
