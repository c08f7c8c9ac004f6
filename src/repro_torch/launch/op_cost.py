"""FLOP, byte and collective counting over meta tensors: the port's
counterpart of the JAX package's ``repro.launch.jaxpr_cost`` (and of the
roofline's ``parse_collectives``).

``estimate_fn_cost(fn, *args, **kwargs)`` runs ``fn`` once under
``OpCounter``, a ``TorchDispatchMode``, on meta tensors (nothing is
computed, nothing allocated) and returns ``{"flops", "bytes",
"matmul_flops", "kernels", "collectives", "peak_bytes"}``.  The JAX walker
reads a jaxpr and must multiply a ``scan`` body by its trip count and walk
a remat body again; the port's models loop over layers in Python and
``torch.utils.checkpoint`` recomputes under backward, so every trip and
every recompute reaches the dispatcher as it runs and is counted as it
runs, with no scan walker.

Cost model (``jaxpr_cost``'s, op for op):

  flops — matmuls exact: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``
          (what ``einsum``, ``matmul`` and ``linear`` decompose to) charge
          2·M·N·K·batch, kept apart as ``matmul_flops`` as well; every
          other op 1 an output element, except views, allocations, dtype
          conversions, copies, selects and the gather / scatter family
          (``_NO_FLOPS``' counterparts).
  bytes — the perfect-fusion HBM model: operand and output bytes for
          matmuls, data movement (``cat``, ``clone``, pads, flips) and
          reductions; 2x the output for a gather (``index_select``,
          ``index``, ``embedding``, ``gather``); 3x the updates for a
          scatter (``index_put_``, ``scatter``, ``index_add``); a write into
          a slice (``copy_`` into a view, ``index_copy_``, the KV cache's
          update) 2x the slice written, never the whole buffer, as
          ``dynamic_update_slice`` is charged; pure elementwise ops are
          fused (0).
  kernels — a kernel entry of ``kernels/*/ops.py`` given meta tensors
          returns outputs of the right shapes and charges its own
          ``cost(...)`` (``obs.op_charges.charge_kernel``): the bytes it
          reads and writes once and the operations it does, never its
          internal logits or state as traffic — ``_pallas_cost``'s
          counterpart.
  collectives — the output bytes of each ``_c10d_functional`` collective
          a DTensor redistribution issues (all-gather, all-reduce,
          reduce-scatter, all-to-all), by kind; ``sharding/collectives.py``'s
          explicit point-to-point moves add their bytes themselves
          (``obs.op_charges.charge_collective``).
  peak_bytes — the most bytes of tensors allocated inside the run that
          were alive at once (views and in-place results add nothing).

All quantities are of the program as called: on global shapes, divide by
the ranks for per-rank terms (the even-shard assumption ``jaxpr_cost``
makes); ``peak_bytes`` likewise is an estimate of one rank's temporaries
only after that division.

On ``DTensor`` arguments (the dry run's placed pass) an op is run by
DTensor with the counter pushed again, so the counter sees the local ops
and the collectives DTensor issues: per-rank work.  Three cases are taken
apart, and every other failure of an op propagates (the dry run then
records the combination as ``status: "error"``):

* an op DTensor has no sharding strategy for (its ``NotImplementedError``),
  and a ``view`` / ``reshape`` whose sharding DTensor cannot carry through
  (its propagation fails and asks for a redistribution first), get their
  inputs redistributed to ``Replicate`` (the all-gathers counted), run on
  the local tensors and come back replicated; counted by op in
  ``replicated_ops``.  So does any other in-place op into a plain tensor
  (DTensor refuses it), which the plain tensor, replicated under
  ``implicit_replication``, then holds whole.  The sweep of all 80
  combinations meets three: the MoE dispatch's ``scatter_add_`` into the
  zero buffer it makes (mixtral-8x22b and llama4-maverick, every shape),
  and two views of rwkv6-7b on the 512-rank mesh, its LoRA mix
  unflattening 320 columns into 5 groups over 16 ranks (decode) and its
  (B, S) rows flattened (prefill);
* a slice write (``copy_``, ``index_copy_``, ``index_put_``) into a plain
  tensor, or into a DTensor whose placement DTensor cannot keep in place,
  is each rank's write into its own block, with no collective, as XLA
  partitions a ``dynamic_update_slice``; counted in ``local_writes``.  The
  sweep meets a prefill's ``copy_`` into the cache or state the model
  makes (every prefill but hubert's, 32–128 a combination) and a decode
  step's ``index_put_`` into a KV cache sharded on its sequence or head
  axis (every decode with attention, 18–128);
* two ops DTensor gets wrong are prepared first: a ``gather`` along a
  sharded dim (a masked partial result DTensor cannot reduce after a
  view) and a ``view`` / ``reshape`` of a tensor sharded unevenly (DTensor
  computes the local shape as if even, e.g. zamba2's 80 heads over 32
  ranks) get that dim gathered whole first, as a partitioner would.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.obs import op_charges
from repro_torch.obs.op_charges import KINDS

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
# new tensors (live bytes, no FLOPs, no traffic)
_FACTORIES = {
    "empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "arange", "randn", "rand", "randint",
}
# no FLOPs, no traffic, no new bytes: fills, views, scalars
_ALLOC = _FACTORIES | {
    "scalar_tensor", "fill_", "zero_", "lift_fresh", "lift_fresh_copy", "detach", "alias", "_unsafe_view", "unbind",
    "split", "split_with_sizes", "chunk", "_local_scalar_dense", "normal_", "uniform_",
}
# no FLOPs (jaxpr_cost's _NO_FLOPS): conversion, selection, data movement
_NO_FLOPS = {
    "_to_copy", "to", "where", "masked_fill", "masked_fill_", "copy_", "clone", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "repeat", "index_select", "index", "gather", "embedding",
    "index_put", "index_put_", "index_copy", "index_copy_", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index_add", "index_add_", "contiguous", "_reshape_copy",
}
_GATHER = {"index_select", "index", "gather", "embedding"}
_SCATTER = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_"}
_SLICE_WRITE = {"copy_", "index_copy", "index_copy_"}
_MOVES = {"cat", "stack", "clone", "constant_pad_nd", "flip", "roll", "repeat", "sort", "topk", "contiguous",
          "_reshape_copy"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "cumsum", "cumprod", "var",
    "std", "prod", "any", "all", "norm", "linalg_vector_norm", "_softmax", "_log_softmax", "softmax",
    "log_softmax", "_softmax_backward_data", "_log_softmax_backward_data", "var_mean", "aminmax",
}
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_VIEWS = {"view", "_unsafe_view", "reshape"}
_NO_STRATEGY = "does not have a sharding strategy"
_VIEW_FAILED = "Sharding propagation failed"
_INPLACE_PLACEMENT = "in-place operations that require placement changes are not supported"


def tensors_of(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors_of(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors_of(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensors_of(getattr(x, f.name))


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


def _numel(x) -> int:
    return sum(t.numel() for t in tensors_of(x))


def matmul_flops(name: str, args) -> int:
    """2·M·N·K·batch of a matmul-family aten op's operands."""
    if name in ("mm", "bmm", "mv", "dot"):
        a, b = args[0], args[1]
    else:  # addmm, baddbmm, addmv: (input, a, b)
        a, b = args[1], args[2]
    if name in ("mv", "addmv", "dot"):
        return 2 * a.numel()
    batch = a.shape[0] if a.ndim == 3 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _uneven_gathered(x):
    """DTensor ``x`` with every dim it shards unevenly gathered whole."""
    from repro_torch.sharding.dtensor_calls import redistributed

    sizes = x.device_mesh.mesh.shape
    n = {}
    for j, p in enumerate(x.placements):
        if p.is_shard():
            n[p.dim] = n.get(p.dim, 1) * sizes[j]
    uneven = {d for d, k in n.items() if x.shape[d] % k}
    if not uneven:
        return x
    from torch.distributed.tensor import Replicate

    return redistributed(x, [Replicate() if p.is_shard() and p.dim in uneven else p for p in x.placements])


class OpCounter(TorchDispatchMode):
    """Counts every aten op that runs under it (see the module docstring);
    kernel entries and the explicit collectives charge it through
    ``obs.op_charges`` while it is active."""

    def __init__(self):
        super().__init__()
        self.replicated_ops: Dict[str, int] = {}
        self.local_writes: Dict[str, int] = {}
        self._inside = False
        self._depth = 0
        self.flops = 0
        self.bytes = 0
        self.matmul_flops = 0
        self.kernels: Dict[str, dict] = {}
        self.collectives: Dict[str, int] = {k: 0 for k in KINDS}
        self.live = 0
        self.peak_bytes = 0

    def __enter__(self):
        if self._depth == 0:
            op_charges.activate(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            op_charges.deactivate(self)
        return super().__exit__(*exc)

    def _dtensor_op(self, func, args, kwargs):
        """An op on ``DTensor`` arguments, run by DTensor with this counter
        pushed again, so the local ops and collectives it issues are
        counted; the cases the module docstring lists are taken apart."""
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.sharding.dtensor_calls import redistributed, replicated_call

        name = str(func.overloadpacket.__name__)
        self._inside = True
        try:
            with self:
                if name == "gather" and isinstance(args[0], DTensor):
                    x, dim = args[0], args[1] % args[0].ndim
                    keep = [Replicate() if p.is_shard() and p.dim == dim else p for p in x.placements]
                    args = (redistributed(x, keep),) + tuple(args[1:])
                elif name in _VIEWS and isinstance(args[0], DTensor):
                    args = (_uneven_gathered(args[0]),) + tuple(args[1:])
                if name in _SLICE_WRITE or name == "index_put_":
                    if not isinstance(args[0], DTensor):
                        return self._local_write(name, args[0])
                    try:
                        return func(*args, **kwargs)
                    except RuntimeError as e:
                        if _INPLACE_PLACEMENT not in str(e):
                            raise
                        return self._local_write(name, args[0])
                if name.endswith("_") and not isinstance(args[0], DTensor):
                    replicated_call(func, *args, **kwargs)  # writes args[0] in place
                    self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
                    return args[0]
                try:
                    return func(*args, **kwargs)
                except NotImplementedError as e:
                    if _NO_STRATEGY not in str(e):
                        raise
                except RuntimeError as e:
                    if name not in _VIEWS or _VIEW_FAILED not in str(e):
                        raise
                out = replicated_call(func, *args, **kwargs)
                self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
                return out
        finally:
            self._inside = False

    def _local_write(self, name: str, dst):
        """A slice write DTensor cannot place: each rank's own."""
        self.local_writes[name] = self.local_writes.get(name, 0) + 1
        return dst

    def kernel_call(self, fn, args, kwargs, kv_head_dim):
        """A kernel entry's meta route (``obs.op_charges.meta_call``): on
        each rank's blocks where an argument is a ``DTensor``."""
        from repro_torch.sharding.dtensor_calls import kernel_call

        return kernel_call(fn, args, kwargs, kv_head_dim)

    def _alloc(self, out) -> None:
        for t in tensors_of(out):
            n = t.untyped_storage().nbytes()
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t.untyped_storage(), self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if self._inside:
                return NotImplemented  # DTensor runs it; its local ops come back here
            return self._dtensor_op(func, args, kwargs or {})
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.collectives[kind] += _bytes(out)
            return out
        if getattr(func, "is_view", False) or name in _ALLOC:
            if name in _FACTORIES:
                self._alloc(out)
            return out
        inplace = name.endswith("_") or name in ("copy_",)
        if name in _MATMUL:
            f = matmul_flops(name, args)
            self.matmul_flops += f
            self.flops += f + (_numel(out) if name.startswith("add") else 0)
            self.bytes += _bytes(args) + _bytes(out)
        else:
            if name not in _NO_FLOPS:
                self.flops += _numel(out)
            if name in _SLICE_WRITE:
                self.bytes += 2 * _bytes(args[1] if name == "copy_" else args[3])  # the slice written
            elif name in _GATHER:
                self.bytes += 2 * _bytes(out)
            elif name in _SCATTER:
                upd = args[2] if len(args) > 2 else out
                self.bytes += 3 * _bytes(upd)
            elif name in _MOVES or name in _REDUCTIONS:
                self.bytes += _bytes(args) + _bytes(out)
        if not inplace:
            self._alloc(out)
        return out

    def kernel(self, name: str, cost: dict) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(cost["flops"])
        k["bytes"] += int(cost["bytes"])
        self.flops += int(cost["flops"])
        self.bytes += int(cost["bytes"])

    def collective(self, kind: str, n_bytes: int) -> None:
        self.collectives[kind] += int(n_bytes)

    def summary(self) -> dict:
        return {"flops": int(self.flops), "bytes": int(self.bytes), "matmul_flops": int(self.matmul_flops),
                "kernels": dict(self.kernels), "collectives": dict(self.collectives),
                "peak_bytes": int(self.peak_bytes), "replicated_ops": dict(self.replicated_ops),
                "local_writes": dict(self.local_writes)}


def estimate_fn_cost(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` once under an ``OpCounter`` -> its summary."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.summary()
