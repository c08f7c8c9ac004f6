"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x input
shape) on the production 256- and 512-rank meshes, the memory a rank
holds, and the roofline terms — computed on meta tensors, so nothing runs
on a card (as the JAX dry run runs on forced host devices).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape long_500k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cascade --multi-pod true

Each combination writes ``experiments/dryrun/<arch>__<shape>__<mesh>.json``
with the JAX record's keys.  PyTorch has no ``eval_shape``, SPMD
partitioner or ``memory_analysis``, so the pieces are the port's own:

* the world: one process on the ``fake`` process-group backend
  (``torch.testing._internal.distributed.fake_pg``) at 256 or 512 ranks,
  this process rank 0, so ``launch.mesh.make_production_mesh`` holds; more
  than one combination runs one subprocess each, as in JAX;
* ``params``, ``active_params``, ``status`` / ``reason``:
  ``models.counting.count_params`` and ``configs.shape_supported``; for
  ``long_500k`` an attention model's window is forced to its own or 4096;
* ``memory``: ``argument_bytes`` is exact — each leaf of the parameters,
  the AdamW moments (bf16 past 80e9 parameters, ``_moment_dtype``), the
  cache and the batch divided by the shard counts its ``logical_to_pspec``
  gives on the production axis sizes; ``temp_bytes`` is an estimate: the
  global meta run's peak live bytes of its temporaries divided by the
  ranks (``launch.op_cost``'s even-shard assumption, as ``jaxpr_cost``
  makes it); ``output_bytes`` the outputs that alias no input, divided
  likewise;
* ``roofline``: the global program's ``estimate_fn_cost`` divided by the
  ranks (``launch.roofline.roofline_terms`` with ``H100_SXM``): train is
  the step itself, forward, backward and AdamW on meta tensors (the
  kernels' autograd routes), prefill ``api.prefill``, decode
  ``api.decode_step``; ``lower_s`` is that run's seconds;
* the placed train step is the whole step too (``_placed_train_step``):
  gradients on their parameters' placements, the gradient norm's scalar
  all-reduce, AdamW on each rank's shards of the parameters and of the
  moments, which are placed like the parameters;
* ``collectives``: the same step on parameters, batch and cache as
  ``DTensor``s placed by ``logical_placements`` (their local blocks meta
  tensors), counted by an ``OpCounter``: what DTensor's sharding
  propagation issues, the counterpart of XLA's partitioner, with one
  difference the record states (``sharding_strategies``): among the
  strategies of an op, DTensor's planner is asked for the cost of each
  redistribution, and here that cost is priced greedily, mesh dim by mesh
  dim, with DTensor's own transition costs (``_greedy_strategy_costs``;
  on a 3-D mesh the planner otherwise searches a graph for each new
  (source, target) pair, hundreds a model), so a strategy it picks may
  differ from the one DTensor would.  A shard moved from one dim to another
  is charged as the all-to-all NCCL runs (``_shard_moves_as_all_to_all``),
  not as the all-gather DTensor falls back to on a CPU mesh.  The loss's
  logits stay sharded by vocabulary (``_vocab_sharded_ce``).  The kernels
  take plain tensors: a
  kernel entry's meta route given ``DTensor``s runs on each rank's blocks
  (``sharding.dtensor_calls``: the attention kernels by rows and heads,
  K and V gathered to the heads a rank reads, except a decode cache
  sharded along its sequence, which each rank attends in its own slice,
  the partial softmaxes merged by all-reduces of O(B·H·hd); the others on
  inputs gathered whole), and those collectives are counted, as XLA would
  issue them around an opaque custom call.  The ops ``op_cost`` replicates
  or writes locally are recorded (``replicated_ops``, ``local_writes``).
  The per-rank counts of that run are ``xla_cost`` (XLA's per-device
  ``cost_analysis`` counterpart) and its seconds ``compile_s``.  Any
  other failure fails the combination, which is recorded as ``status:
  "error"`` with its traceback;
* ``model_flops`` and ``useful_ratio``: 6·N·D (train) or 2·N·D, N the
  active non-embedding parameters (``models.counting``).

``--cascade`` dry-runs the ABC cascade step itself on a (2, 16, 16) world
(the ensemble's two qwen2.5-3b members on 'pod', one a pod, the batch on
'data'; on (16, 16) the members are replicated): each member's prefill
logits, their 'pod' gather into the vote (``deferral.vote_rule``, the
agreement kernel) and a 48-layer qwen2.5-14b-like tier 2's prefill.

The models read nothing back to the host (no ``.item()``, no
``nonzero``, no shape that depends on data), which a meta run requires.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_supported
from repro_torch.core import deferral
from repro_torch.core import ensemble as ens
from repro_torch.launch.mesh import make_production_mesh, production_axis_sizes
from repro_torch.launch.op_cost import tensors_of, estimate_fn_cost
from repro_torch.launch.roofline import collective_terms, roofline_terms
from repro_torch.models import api
from repro_torch.models.counting import count_params, model_flops_per_token
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import OptimConfig, adamw_update
from repro_torch.sharding.logical import axis_rules, logical_placements, logical_to_pspec, rules_for
from repro_torch.train.step import init_train_state, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

LONG_WINDOW = 4096  # sliding window forced for long_500k on attention archs

_BATCH_AXES = {
    "tokens": ("act_batch", None),
    "targets": ("act_batch", None),
    "mask": ("act_batch", None),
    "embeds": ("act_batch", None, None),
    "token": ("act_batch", None),
    "pos": (),
}


def fake_world(n_ranks: int) -> None:
    """This process as rank 0 of a world of ``n_ranks`` on the ``fake``
    backend: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def _walk(axes, tree):
    """(axes, leaf) pairs of a tree and its axes tree, in leaf order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(axes[k], tree[k])
    elif isinstance(tree, (list, tuple)):
        for a, t in zip(axes, tree):
            yield from _walk(a, t)
    else:
        yield axes, tree


def _shards(axes, shape, rules, sizes) -> int:
    """How many blocks ``logical_to_pspec`` cuts a leaf into on ``sizes``."""
    n = 1
    for entry in logical_to_pspec(axes, rules, shape=tuple(shape), mesh=sizes):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n *= sizes[a]
    return n


def bytes_per_rank(axes_tree, tree, rules, sizes) -> int:
    """A tree's bytes on one rank: each leaf's bytes over its shard count."""
    return sum(t.numel() * t.element_size() // _shards(a, t.shape, rules, sizes) for a, t in _walk(axes_tree, tree))


def _placed(axes, leaf, rules, mesh, sizes):
    """``leaf`` (meta) as a ``DTensor`` on ``mesh`` placed by its logical
    axes, its local block a meta tensor of the block's shape."""
    from torch.distributed.tensor import DTensor

    spec = logical_to_pspec(axes, rules, shape=tuple(leaf.shape), mesh=sizes)
    placements = logical_placements(spec, mesh, leaf.ndim)
    local = list(leaf.shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.mesh.shape[j]
    return DTensor.from_local(torch.empty(local, dtype=leaf.dtype, device="meta"), mesh, placements,
                              run_check=False, shape=leaf.shape, stride=leaf.stride())


def placed_tree(axes_tree, tree, rules, mesh, sizes):
    """Every leaf of a tree (dicts and the hybrid's lists) ``_placed``."""
    if isinstance(tree, dict):
        return {k: placed_tree(axes_tree[k], v, rules, mesh, sizes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(placed_tree(a, t, rules, mesh, sizes) for a, t in zip(axes_tree, tree))
    return _placed(axes_tree, tree, rules, mesh, sizes)


def _moment_dtype(cfg) -> str:
    # >= 80B params: bf16 AdamW moments (DESIGN.md §7)
    return "bfloat16" if count_params(cfg) > 80e9 else "float32"


def _meta(specs) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in specs.items()}


def _outputs_bytes(out, inputs) -> int:
    """Bytes of the returned tensors that alias no input's storage."""
    seen = {id(t.untyped_storage()) for t in tensors_of(inputs)}
    got = {}
    for t in tensors_of(out):
        if hasattr(t, "to_local"):
            t = t.to_local()
        if id(t.untyped_storage()) not in seen:
            got[id(t.untyped_storage())] = t.untyped_storage().nbytes()
    return sum(got.values())


def _program(cfg, shape, window, rules, sizes, mesh=None):
    """(fn, args, argument bytes a rank) of a shape's program on meta
    tensors: plain (``mesh`` None) or placed as ``DTensor``s on ``mesh``."""
    g = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, g, "meta")
    p_axes = api.param_axes(cfg)
    specs = api.input_specs(cfg, shape)
    batch = _meta(specs)
    b_axes = {k: _BATCH_AXES[k] for k in batch}
    arg_bytes = bytes_per_rank(p_axes, params, rules, sizes) + bytes_per_rank(b_axes, batch, rules, sizes)
    put = (lambda axes, tree: tree) if mesh is None else (lambda axes, tree: placed_tree(axes, tree, rules, mesh, sizes))
    if shape.kind == "train":
        ocfg = OptimConfig(moment_dtype=_moment_dtype(cfg))
        state = init_train_state(params, ocfg)
        arg_bytes += 2 * bytes_per_rank(p_axes, state.opt["m"], rules, sizes)
        if mesh is None:
            return make_train_step(cfg, ocfg, window_override=window), (state, batch), arg_bytes
        # placed: the whole step, the moments placed like the parameters
        return (_placed_train_step(cfg, ocfg, window),
                (put(p_axes, params), put(b_axes, batch), put(p_axes, state.opt["m"]), put(p_axes, state.opt["v"])),
                arg_bytes)
    run_cfg = dataclasses.replace(cfg, sliding_window=window) if window else cfg
    params = put(p_axes, params)
    if shape.kind == "prefill":
        return (lambda p, b: api.prefill(p, b, run_cfg)), (params, put(b_axes, batch)), arg_bytes
    cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
    c_axes = api.cache_axes(cfg)
    arg_bytes += bytes_per_rank(c_axes, cache, rules, sizes)
    batch = put(b_axes, batch)
    return ((lambda p, t, c, pos: api.decode_step(p, t, c, pos, run_cfg)),
            (params, batch["token"], put(c_axes, cache), batch["pos"]), arg_bytes)


STRATEGIES = "DTensor's, each redistribution priced greedily per mesh dim (launch.dryrun._greedy_strategy_costs)"


@contextlib.contextmanager
def _greedy_strategy_costs():
    """DTensor prices each candidate sharding strategy by the cost of the
    redistributions it needs, and on a 3-D mesh its planner searches a
    graph of placement states for each new (source, target) pair, hundreds
    of pairs a model.  Within this context a pair is priced mesh dim by
    mesh dim with DTensor's own transition costs (the greedy plan's
    steps), so the strategy chosen may differ from DTensor's own; the
    redistributions that run still take the planner's path.  It replaces
    private internals of ``torch.distributed.tensor`` and raises where the
    installed torch lacks any of them."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor._ops.utils as ops_utils
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    needed = {"redistribute_cost": ops_utils, "MeshTopoInfo": cu, "spec_to_bytes": cu,
              "_compute_placement_transition_cost": cu}
    missing = [n for n, mod in needed.items() if not hasattr(mod, n)]
    if missing or "shard_order" not in DTensorSpec.__dataclass_fields__:
        raise RuntimeError(f"torch {torch.__version__}: the dry run prices DTensor strategies through "
                           f"internals this version lacks ({missing or ['DTensorSpec.shard_order']})")

    def cost(current, target):
        if current.shard_order is None or target.shard_order is None:
            return float("inf")
        if current.placements == target.placements and current.shard_order == target.shard_order:
            return 0.0
        topo = cu.MeshTopoInfo.build_from_mesh(current.mesh)
        gb = cu.spec_to_bytes(current) / current.num_shards / 1024**3
        total = 0.0
        for j, (a, b) in enumerate(zip(current.placements, target.placements)):
            step, gb = cu._compute_placement_transition_cost(a, b, topo, j, gb)
            total += step
        return total

    saved = ops_utils.redistribute_cost
    ops_utils.redistribute_cost = cost
    try:
        yield
    finally:
        ops_utils.redistribute_cost = saved


@contextlib.contextmanager
def _shard_moves_as_all_to_all():
    """DTensor moves a shard from one dim to another (``Shard._to_new_shard_dim``)
    as an all-to-all, except on a mesh of device type 'cpu' (the dry run's
    world), where it gathers the whole dim and keeps its chunk, as gloo has
    no all-to-all.  On the cards the placed program models, NCCL runs the
    all-to-all: within this context the move keeps DTensor's local result
    and is charged as one all-to-all of that result's bytes, not as the
    all-gather of the whole dim.  It replaces a private internal of
    ``torch.distributed.tensor`` and raises where the installed torch lacks
    it."""
    import torch.distributed.tensor.placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.obs import op_charges

    if not hasattr(pt, "shard_dim_alltoall") or not hasattr(pt.Shard, "_custom_chunk"):
        raise RuntimeError(f"torch {torch.__version__}: the dry run charges shard moves through internals this "
                           "version lacks (placement_types.shard_dim_alltoall)")

    def all_to_all(local, gather_dim, shard_dim, mesh, mesh_dim):
        # the local result is built from this rank's block alone: right in
        # shape only, so only the dry run's meta blocks may pass
        assert local.device.type == "meta", f"shard move charged on a {local.device.type} tensor"
        n = mesh.size(mesh_dim)
        with _disable_current_modes():  # the local result's shape; no work of its own
            out = pt.Shard._custom_chunk(torch.cat([local] * n, dim=gather_dim), n, dim=shard_dim)
            out = out[mesh.get_local_rank(mesh_dim)].contiguous()
        op_charges.charge_collective("all-to-all", out.numel() * out.element_size())
        return out

    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


@contextlib.contextmanager
def _vocab_sharded_ce():
    """Within this context the loss's chunk sums keep the vocabulary sharded
    (``sharding.dtensor_calls.ce_chunk_vocab_sharded`` in place of
    ``models.api._ce_chunk``, whose target gather and argmax would gather
    the f32 logits whole on DTensors): the layout the JAX package
    constrains its logits to."""
    from repro_torch.sharding.dtensor_calls import ce_chunk_vocab_sharded

    saved = api._ce_chunk
    api._ce_chunk = ce_chunk_vocab_sharded
    try:
        yield
    finally:
        api._ce_chunk = saved


def _loss_grads(cfg, window):
    """(params, batch) -> every parameter's gradient of ``api.loss_fn``."""
    def fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = api.loss_fn(tree_unflatten(params, leaves), batch, cfg, window_override=window)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    return fn


def _replicas(x) -> int:
    """How many ranks hold each block of the ``DTensor`` ``x``: the sizes of
    the mesh dims it is not sharded over."""
    return math.prod(n for n, p in zip(x.device_mesh.mesh.shape, x.placements) if not p.is_shard())


def _placed_train_step(cfg, ocfg: OptimConfig, window):
    """(params, batch, m, v) as ``DTensor``s -> the train step of
    ``make_train_step`` on each rank's shards: the loss and its gradients,
    each gradient brought to its parameter's placements (the reduction a
    data-parallel step issues); the global gradient norm as each rank's sum
    of squares over its shards, each leaf's weighted by 1 / the ranks that
    hold the same block, then one all-reduce of that scalar over the mesh
    (a partial sum reduced to replicated); then AdamW leaf by leaf on the
    local shards (``to_local()``: elementwise, so DTensor's planner never
    sees the update's flattened slices), the clip by that norm included."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.optim.schedule import cosine_schedule

    loss_grads = _loss_grads(cfg, window)

    def step(params, batch, m, v):
        leaves = tree_leaves(params)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(loss_grads(params, batch), leaves)]
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
        local = [g.to_local() for g in grads]
        sq = sum(g.float().square().sum() / _replicas(p) for g, p in zip(local, leaves))
        mesh = leaves[0].device_mesh
        total = DTensor.from_local(sq, mesh, [Partial()] * mesh.ndim, run_check=False)
        gnorm = total.redistribute(mesh, [Replicate()] * mesh.ndim).to_local().sqrt()
        shards = lambda tree: tree_unflatten(params, [t.to_local() for t in tree_leaves(tree)])  # noqa: E731
        opt = {"m": shards(m), "v": shards(v), "count": torch.zeros((), dtype=torch.int32, device=gnorm.device)}
        step_no = torch.zeros((), dtype=torch.int32, device=gnorm.device)
        with torch.no_grad():
            return adamw_update(tree_unflatten(params, local), opt, shards(params), ocfg,
                                lr_scale=cosine_schedule(step_no, 10_000, 100), grad_norm=gnorm)

    return step


def _count(fn, args, kind: str, rules=None, mesh=None) -> tuple:
    """(op counter summary, outputs) of one run of ``fn(*args)``.  With a
    ``mesh`` (a placed run) the models' activations follow ``rules``
    (``sharding.logical.axis_rules``: the layouts the JAX package constrains
    them to) and the plain tensors they make (positions, masks) count as
    replicated (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    placed = mesh is not None
    out = {}

    def run():
        out["v"] = fn(*args)

    with torch.enable_grad() if kind == "train" else torch.no_grad(), \
            implicit_replication() if placed else contextlib.nullcontext(), \
            axis_rules(rules, mesh) if placed else contextlib.nullcontext(), \
            _greedy_strategy_costs() if placed else contextlib.nullcontext(), \
            _shard_moves_as_all_to_all() if placed else contextlib.nullcontext(), \
            _vocab_sharded_ce() if placed else contextlib.nullcontext():
        cost = estimate_fn_cost(run)
    return cost, out["v"]


def run_one(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
        "params": count_params(cfg), "active_params": count_params(cfg, active_only=True),
    }
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    window = None
    if shape_name == "long_500k" and not cfg.attention_free:
        window = cfg.sliding_window or LONG_WINDOW
        rec["window_override"] = window

    sizes = production_axis_sizes(multi_pod=multi_pod)
    fake_world(math.prod(sizes.values()))
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_chips = mesh.size()
    rules = rules_for(shape.kind, pod=multi_pod, batch=shape.global_batch)

    t0 = time.time()
    fn, args, arg_bytes = _program(cfg, shape, window, rules, sizes)
    cost, out = _count(fn, args, shape.kind)
    out_bytes = _outputs_bytes(out, args)
    del fn, args, out
    t_lower = time.time() - t0
    fn, args, _ = _program(cfg, shape, window, rules, sizes, mesh)
    local, _ = _count(fn, args, shape.kind, rules, mesh)
    del fn, args
    t_compile = time.time() - t0 - t_lower

    coll = collective_terms(local)
    per_chip = {"flops": cost["flops"] / n_chips, "bytes accessed": cost["bytes"] / n_chips}
    terms = roofline_terms(per_chip, sum(coll.values()), n_chips)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    per_tok = model_flops_per_token(cfg) / 6.0
    model_flops = (6.0 if shape.kind == "train" else 2.0) * per_tok * tokens
    temp = cost["peak_bytes"] // n_chips
    rec.update(
        status="ok",
        n_chips=n_chips,
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        collectives=coll,
        roofline=terms,
        kernels=cost["kernels"],
        matmul_flops=cost["matmul_flops"],
        xla_cost={"flops_per_dev": float(local["flops"]), "bytes_per_dev": float(local["bytes"])},
        sharding_strategies=STRATEGIES,
        replicated_ops=local["replicated_ops"],
        local_writes=local["local_writes"],
        model_flops=model_flops,
        useful_ratio=(model_flops / cost["flops"]) if cost["flops"] else None,
        memory={
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes // n_chips,
            "temp_bytes": temp,
            "peak_bytes": temp + arg_bytes,
        },
    )
    return rec


def run_cascade(multi_pod: bool) -> dict:
    """The paper's technique on the production mesh: a 2-member tier-1
    ensemble stacked on the 'ensemble' logical axis (on 'pod' on the
    2x16x16 mesh, one member a pod), the agreement vote over every
    member's logits, and tier 2's prefill on the whole batch (the masked
    form), as the JAX dry run's ``cascade_step``."""
    cfg1 = get_config("qwen2.5-3b")
    cfg2 = dataclasses.replace(cfg1, name="qwen2.5-14b-like", n_layers=48, d_model=5120, n_heads=40,
                               n_kv_heads=8, d_ff=13824, head_dim=128)
    B, S, E = 32, 8192, 2
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    sizes = production_axis_sizes(multi_pod=multi_pod)
    fake_world(math.prod(sizes.values()))
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_chips = mesh.size()
    rules = dict(rules_for("prefill", pod=multi_pod, batch=B))
    # the pod axis carries the ensemble, not the batch
    rules["act_batch"] = ("data",)
    rules["kv_batch"] = ("data",)
    rules["ensemble"] = "pod" if multi_pod else None

    def cascade_step(v1, v2, batch):
        logits1, _ = ens.ensemble_prefill(v1, batch, cfg1)  # (E, B, V)
        out = deferral.vote_rule(logits1, 0.67)
        logits2, _ = api.prefill(v2, batch, cfg2)
        pred = torch.where(out.defer, logits2.argmax(-1).to(torch.int32), out.pred)
        return pred, out.defer, out.score

    def program(placed: bool):
        g = torch.Generator().manual_seed(0)
        v1, v2 = ens.init_ensemble(cfg1, E, g, "meta"), api.init_params(cfg2, g, "meta")
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
        if placed:
            v1 = placed_tree(ens.ensemble_axes(cfg1), v1, rules, mesh, sizes)
            v2 = placed_tree(api.param_axes(cfg2), v2, rules, mesh, sizes)
            batch = {"tokens": _placed(("act_batch", None), batch["tokens"], rules, mesh, sizes)}
        return v1, v2, batch

    rec = {"arch": "abc-cascade-2tier", "shape": f"prefill_{S}", "mesh": mesh_name, "kind": "cascade",
           "n_layers": [cfg1.n_layers, cfg2.n_layers]}
    t0 = time.time()
    cost, _ = _count(cascade_step, program(False), "cascade")
    local, _ = _count(cascade_step, program(True), "cascade", rules, mesh)
    coll = collective_terms(local)
    per_chip = {"flops": cost["flops"] / n_chips, "bytes accessed": cost["bytes"] / n_chips}
    rec.update(
        status="ok",
        n_chips=n_chips,
        compile_s=round(time.time() - t0, 2),
        collectives=coll,
        kernels=cost["kernels"],
        sharding_strategies=STRATEGIES,
        replicated_ops=local["replicated_ops"],
        local_writes=local["local_writes"],
        roofline=roofline_terms(per_chip, sum(coll.values()), n_chips),
    )
    return rec


def _error(arch, shape_name, mesh_name, e) -> dict:
    """A combination that did not run: recorded, not skipped."""
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "error",
            "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="false", choices=["false", "true", "both"])
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--cascade", action="store_true",
                    help="dry-run the ABC cascade step itself (ensemble on the pod axis)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.cascade:
        mp = args.multi_pod == "true"
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        try:
            rec = run_cascade(mp)
        except Exception as e:
            rec = _error("abc-cascade-2tier", "prefill_8192", mesh_name, e)
        with open(os.path.join(args.out, f"abc-cascade__{mesh_name}.json"), "w") as f:
            json.dump(rec, f, indent=2)
        if rec["status"] != "ok":
            print(f"[error] abc-cascade x {mesh_name}: {rec['error']}")
            return 1
        t = rec["roofline"]
        print(f"[ok] abc-cascade x {mesh_name}: {rec['compile_s']}s coll={t['collective_bytes']:.3e} "
              f"bottleneck={t['bottleneck']} collectives={rec['collectives']}")
        return 0

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    pods = {"false": [False], "true": [True], "both": [False, True]}[args.multi_pod]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in pods]
    if len(combos) > 1:
        # one subprocess a combination: a world of its own size, and a
        # failure stays in its record
        failed = 0
        for a, s, mp in combos:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            out_file = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
            if os.path.exists(out_file):
                print(f"[skip existing] {out_file}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                   "--multi-pod", "true" if mp else "false", "--out", args.out]
            print(f"[dryrun] {a} x {s} x {mesh_name}", flush=True)
            failed += subprocess.run(cmd, env=dict(os.environ)).returncode != 0
        return 1 if failed else 0

    arch, shape_name, mp = combos[0]
    mesh_name = "pod2x16x16" if mp else "pod16x16"
    try:
        rec = run_one(arch, shape_name, mp)
    except Exception as e:  # recorded: these are bugs to fix
        rec = _error(arch, shape_name, mesh_name, e)
    with open(os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=2)
    if rec["status"] == "ok":
        t = rec["roofline"]
        print(f"[ok] {arch} x {shape_name} x {mesh_name}: {rec['lower_s']}s + {rec['compile_s']}s "
              f"flops={t['flops']:.3e} bytes={t['bytes']:.3e} coll={t['collective_bytes']:.3e} "
              f"bottleneck={t['bottleneck']}")
        return 0
    print(f"[{rec['status']}] {arch} x {shape_name} x {mesh_name}: {rec.get('reason', rec.get('error'))}")
    return 1 if rec["status"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
