"""Ranks of ``gloo`` worlds on the CPU for ``tests/test_torch_sharding.py``
and ``tests/test_torch_placement.py``.

    python tests/torch_mesh_world.py DIR CHECK [CHECK ...]

runs each CHECK in its world (``WORLDS``), one after another: this process
is rank 0 and starts the other ranks (``torch.multiprocessing``, from a
fork server that imports torch and the port once, single-threaded); they
meet through a ``FileStore`` under DIR, read
``DIR/setup.pt`` (the tiers' weights and the run's inputs, written by the
test) and each write ``DIR/<check>.rank<r>.json``.  ``pods`` (8 ranks):
the pod-placed classify on a (2, 2, 2) and a (4, 2, 1) mesh; ``one_rank``
(1 rank): the one-rank checks, and both tiers of a placement on one
rank's mesh; ``seq_decode`` (4 ranks): the dense decode over a cache
sharded along its sequence (``sharding.dtensor_calls.attention_call``'s
merge of the ranks' partial softmaxes), on three meshes, with the
collectives it issues; ``vocab_ce`` (4 ranks): the loss's chunk sums with
the vocabulary sharded (``sharding.dtensor_calls.ce_chunk_vocab_sharded``)
under the train rules, on three meshes.  Imports no JAX: the tests carry the JAX
package's weights over through numpy.  A rank that raises fails the run
(non-zero exit).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import multiprocessing
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def _tiers(setup, names, ks_here, theta, rule1="confidence"):
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeTier

    specs = [TierSpec("t1", rule1, theta, k=setup[names[0]]["k"], cost=1.0),
             TierSpec("t2", "confidence", -1.0, k=setup[names[1]]["k"], cost=50.0)]
    tiers = []
    for name, spec, here in zip(names, specs, ks_here):
        vals = setup[name]["values"]
        if not here:  # a tier this rank does not serve: no weight materialised
            vals = _meta(vals)
        tiers.append(CascadeTier(setup[name]["cfg"], vals, spec, device="cpu"))
    return tiers


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _result(res):
    return {"pred": res.pred.tolist(), "tier_of": res.tier_of.tolist(), "tier_counts": res.tier_counts.tolist(),
            "scores": res.scores.tolist(), "evaluated": res.evaluated.tolist(), "cost": res.cost}


def _stats(link):
    return {"hops": len(link.hops), "bytes": link.total_bytes, "examples": link.total_examples,
            "hop_list": [[h.src, h.dst, h.n_examples, h.payload_bytes] for h in link.hops]}


def _spy(tier, log):
    """Record the rows each call of ``tier``'s last logits was fed."""
    inner = tier.last_logits

    def spy(tokens, *, eager=False):
        log.append(int(tokens.shape[0]))
        return inner(tokens, eager=eager)

    tier.last_logits = spy


def _placed_run(setup, mesh, names, theta, *, shard_examples=True, spy=False):
    from repro_torch.core import cascade
    from repro_torch.serve import CascadeServer
    from repro_torch.serve.placement import pod_placement

    pl = pod_placement(mesh, 2, shard_examples=shard_examples)
    here = [h.mesh.get_coordinate() is not None for h in pl.hosts]
    server = CascadeServer(_tiers(setup, names, here, theta), device="cpu", placement=pl)
    fed = [[], []]
    if spy:
        for i, t in enumerate(server.tiers):
            _spy(t, fed[i])
    cascade.reset_host_fetch_stats()
    res = server.classify(setup["tokens"].numpy())
    out = {"result": _result(res), "link": _stats(pl.link(0)), "host_fetch": cascade.host_fetch_stats(),
           "here": here, "fed_rows": fed}
    # what each rank holds of each tier: its members (local blocks) or nothing
    out["held"] = [
        {"members": int(server.tiers[i].values["embed"].shape[0]),
         "meta": all(t.is_meta for t in _leaves(server.tiers[i].values)),
         "local_members": int(server.placed_values[i]["embed"].to_local().shape[0]),
         "local_meta": server.placed_values[i]["embed"].to_local().is_meta}
        for i in range(2)]
    return out, pl, server


def _serve_tiers(setup, names, here, temperature=0.0):
    """The serving cascade: tier 1 a two-member digest vote (defer when
    the members disagree), tier 2 answering every row."""
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeTier

    specs = [TierSpec("t1", "vote", setup["serve"]["theta"], k=setup[names[0]]["k"], cost=1.0),
             TierSpec("t2", "confidence", -1.0, k=setup[names[1]]["k"], cost=50.0)]
    return [CascadeTier(setup[n]["cfg"], setup[n]["values"] if h else _meta(setup[n]["values"]), spec,
                        temperature=temperature, device="cpu")
            for n, spec, h in zip(names, specs, here)]


def _requests(setup):
    from repro_torch.serve import Request

    return [Request(tokens=np.asarray(t, np.int32), max_new_tokens=m) for t, m in setup["serve"]["prompts"]]


def _served(reqs, done):
    order = {id(r): i for i, r in enumerate(reqs)}
    return {"out": [[r.output.tolist(), r.tier, r.truncated] for r in reqs], "order": [order[id(r)] for r in done]}


def _hops(link, n0):
    return [[h.n_examples, h.payload_bytes] for h in link.hops[n0:]]


def _report(report, arrivals):
    """An open-loop report with each request named by its arrival index."""
    idx = {id(r): i for i, r in enumerate(arrivals)}
    return {"offered": report.offered, "completed": [[idx[id(r)], r.tier, r.output.tolist()] for r in report.completed],
            "shed": [idx[id(r)] for r in report.shed], "goodput": report.goodput, "p50": report.p50_s,
            "p99": report.p99_s, "makespan": report.makespan_s, "actions": report.controller_actions}


def serve_modes(setup, placement_of, names, here):
    """generate (greedy and T = 0.8 under a seed), serve_continuous (greedy,
    T = 0.8 and speculative) and serve_open_loop under the greedy
    controller, each on a server over ``placement_of()`` (None: unplaced;
    a placement reused across the modes, its hops sliced a mode)."""
    from repro_torch.serve import CascadeServer, ServeConfig
    from repro_torch.serve.controller import ControllerConfig, GreedyController

    pl = placement_of()
    link = pl.link(0) if pl is not None else None
    out = {}
    toks = setup["tokens"].numpy()
    cfg = ServeConfig(n_slots=4, max_seq=32, page_size=8, seed=3)
    for T in (0.0, 0.8):
        server = CascadeServer(_serve_tiers(setup, names, here, T), device="cpu", placement=pl)
        n0 = len(link.hops) if link is not None else 0
        res = server.generate(toks, 3, seed=5)
        out[f"generate@{T:g}"] = {"result": _result(res), "hops": _hops(link, n0) if link is not None else None}
        reqs = _requests(setup)
        n0 = len(link.hops) if link is not None else 0
        done = server.serve_continuous(reqs, cfg)
        out[f"serve@{T:g}"] = dict(_served(reqs, done), hops=_hops(link, n0) if link is not None else None)
    server = CascadeServer(_serve_tiers(setup, names, here), device="cpu", placement=pl)
    reqs = _requests(setup)
    n0 = len(link.hops) if link is not None else 0
    done = server.serve_continuous(reqs, dataclasses.replace(cfg, speculative=True))
    out["speculative"] = dict(_served(reqs, done), hops=_hops(link, n0) if link is not None else None,
                              drafts=server.last_stream_stats[1].get("spec_drafts"))
    wl = _workload(setup)
    ctl = GreedyController(ControllerConfig(interval_s=0.05, shed_margin=1.0))
    n0 = len(link.hops) if link is not None else 0
    arrivals = []
    report = server.serve_open_loop(_Recorded(wl, arrivals), cfg, slo_s=0.2, step_time_s=0.01, controller=ctl)
    out["open_loop"] = dict(_report(report, arrivals), hops=_hops(link, n0) if link is not None else None)
    return out


class _Recorded:
    """A workload that keeps the requests it hands out, in arrival order."""

    def __init__(self, wl, into):
        self.wl, self.into = wl, into

    def __iter__(self):
        for t, r in self.wl:
            self.into.append(r)
            yield t, r


def _workload(setup):
    from repro_torch.serve.workload import bursty

    return bursty(2.0, 400.0, 16, seed=3, mean_on_s=0.5, mean_off_s=0.3, prompt_len=(4, 12),
                  max_new_tokens=(2, 4), vocab=64)


def world_of_8(setup, rank):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serve.placement import hosts_disjoint
    from repro_torch.serve.transport import ShardedDevicePutTransport

    out = {}
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    run, pl, _ = _placed_run(setup, mesh, ("small", "big"), setup["theta"])
    out["pod222"] = run
    out["pod222"]["hosts"] = [h.name for h in pl.hosts]
    out["pod222"]["disjoint"] = hosts_disjoint(pl)
    out["pod222"]["ranks"] = [sorted(h.devices()) for h in pl.hosts]
    out["pod222"]["sharded_link"] = isinstance(pl.link(0), ShardedDevicePutTransport)

    # the probe: 8 distinct rows land as 2 shards of 4 on slice 1, each rank
    # the block DTensor's own layout gives it
    link = pl.link(0)
    src = dist.get_rank() == 0
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    got = link.send_async("pod0", "pod1", {"x": x if src else torch.empty(8, 4, device="meta")}, n_examples=8)
    delivered = got.result()["x"]
    probe = {"local_shape": list(delivered.to_local().shape), "global_shape": list(delivered.shape),
             "shard_counts": link.shard_counts({"x": x})}
    if pl.hosts[1].mesh.get_coordinate() is not None:
        probe["full_equal"] = bool(torch.equal(delivered.full_tensor(), x))
        probe["local_rows"] = delivered.to_local()[:, 0].tolist()
    link.hops.pop()
    out["probe"] = probe

    rep, _, _ = _placed_run(setup, mesh, ("small", "big"), setup["theta"], shard_examples=False)
    out["pod222_replicated"] = rep
    # a threshold that defers ~3/4 of the rows: a tier-2 cover of two
    # chunks (8 + 4), each re-placed onto the link's example sharding
    hi, _, _ = _placed_run(setup, mesh, ("small", "big"), setup["theta_hi"], spy=True)
    out["pod222_two_chunks"] = hi

    mesh421 = init_device_mesh("cpu", (4, 2, 1), mesh_dim_names=("pod", "data", "model"))
    run, _, _ = _placed_run(setup, mesh421, ("small", "big2"), setup["theta"], spy=True)
    out["pod421"] = run
    run, _, _ = _placed_run(setup, mesh421, ("small", "big2"), setup["theta_hi"], spy=True)
    out["pod421_two_chunks"] = run

    # generate, serve_continuous and serve_open_loop over both meshes: on
    # (4, 2, 1) each tier's two members are split one a 'pod' rank
    from repro_torch.serve.placement import pod_placement

    for key, m in (("serve222", mesh), ("serve421", mesh421)):
        pl = pod_placement(m, 2)
        here = [h.mesh.get_coordinate() is not None for h in pl.hosts]
        out[key] = serve_modes(setup, lambda pl=pl: pl, ("near", "big2"), here)
    return out


def world_of_1(setup, rank):
    from repro_torch.launch.mesh import make_production_mesh, pod_submeshes
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig
    from repro_torch.serve.placement import pod_placement
    from repro_torch.serve.transport import ShardedDevicePutTransport
    from repro_torch.sharding.mesh import local_mesh

    out = {}
    mesh = local_mesh(("pod", "data", "model"), device="cpu")
    out["mesh_shape"] = list(mesh.mesh.shape)
    tr = ShardedDevicePutTransport(mesh).bind("cpu")
    payload = {"x": torch.ones(8, 4), "__idx": torch.arange(8, dtype=torch.int32)}
    got = tr.send("pod0", "pod1", payload, n_examples=8)
    out["sharded"] = {
        "shard_counts": tr.shard_counts(payload),
        "equal": all(torch.equal(got[k].to_local(), payload[k]) for k in payload),
        "bytes": tr.total_bytes, "examples": tr.total_examples,
        "data_size": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["data"],
        "spec": [None if a is None else a for a in tr.example_sharding(payload["x"]).spec],
    }
    try:
        make_production_mesh()
        out["production_mesh"] = "built"
    except RuntimeError as e:
        out["production_mesh"] = str(e)
    out["submeshes"] = len(pod_submeshes(mesh, 1))

    cfg = setup["small"]["cfg"]
    spec = TierSpec("t1", "confidence", setup["theta"], k=setup["small"]["k"])
    tier = CascadeTier(cfg, setup["small"]["values"], spec, device="cpu")
    placed = CascadeServer([tier], device="cpu", placement=pod_placement(mesh, 1))
    plain = CascadeServer([tier], device="cpu")
    toks = setup["tokens"].numpy()
    out["classify_equal"] = bool(np.array_equal(placed.classify(toks).pred, plain.classify(toks).pred))
    # the three modes a mesh placement once refused run and equal the
    # unplaced server's
    ran = {}
    reqs = [Request(tokens=toks[i], max_new_tokens=2) for i in range(4)]
    plain_reqs = [Request(tokens=toks[i], max_new_tokens=2) for i in range(4)]
    ran["generate"] = bool(np.array_equal(placed.generate(toks[:2], 2).pred, plain.generate(toks[:2], 2).pred))
    cfg2 = ServeConfig(n_slots=2, max_seq=32)
    placed.serve_continuous(reqs, cfg2)
    plain.serve_continuous(plain_reqs, cfg2)
    ran["serve_continuous"] = all(np.array_equal(a.output, b.output) for a, b in zip(reqs, plain_reqs))
    reports = [s.serve_open_loop(_workload(setup), cfg2, slo_s=0.2) for s in (placed, plain)]
    ran["serve_open_loop"] = all(
        [r.output.tolist() for r in a.completed] == [r.output.tolist() for r in b.completed]
        and (a.goodput, a.makespan_s) == (b.goodput, b.makespan_s) for a, b in [reports])
    out["refused"] = ran
    out["degenerate"] = _degenerate(setup, mesh)
    # both tiers of the serving cascade on the one rank's (1, 1, 1) mesh
    out["serve111"] = serve_modes(setup, lambda: _one_mesh_placement(mesh), ("near", "big2"), (True, True))
    return out


def _one_mesh_placement(mesh):
    from repro_torch.serve.placement import Host, TierPlacement
    from repro_torch.serve.transport import ShardedDevicePutTransport

    return TierPlacement((Host("pod0", "pod", mesh=mesh), Host("pod1", "pod", mesh=mesh)),
                         (ShardedDevicePutTransport(mesh, src_mesh=mesh),))


def _degenerate(setup, mesh):
    """Both tiers on the one rank's (1, 1, 1) mesh: hosts that are not
    disjoint, the mesh path's routing and metering with the hop's source
    its own destination."""
    from repro_torch.serve import CascadeServer
    from repro_torch.serve.placement import Host, TierPlacement, hosts_disjoint, pod_placement
    from repro_torch.serve.transport import ShardedDevicePutTransport

    try:
        pod_placement(mesh, 2)
        split = "split"
    except ValueError as e:
        split = str(e)
    pl = TierPlacement((Host("pod0", "pod", mesh=mesh), Host("pod1", "pod", mesh=mesh)),
                       (ShardedDevicePutTransport(mesh, src_mesh=mesh),))
    server = CascadeServer(_tiers(setup, ("small", "big"), (True, True), setup["theta"]), device="cpu",
                           placement=pl)
    res = server.classify(setup["tokens"].numpy())
    return {"result": _result(res), "link": _stats(pl.link(0)), "describe": pl.describe(),
            "disjoint": hosts_disjoint(pl), "devices": [sorted(h.devices()) for h in pl.hosts], "split": split,
            "placed": [type(v["embed"]).__name__ for v in server.placed_values]}


def seq_decode(setup, rank):
    """The dense decode on DTensors whose cache is sharded along its
    sequence: on a (2, 2) mesh (rows on 'data', q's heads and the cache's
    keys on 'model'), a (1, 4) one (keys over 4 ranks) and a (2, 2) one
    whose keys go over both dims (the long-context rules: q replicated),
    each case of ``setup["cases"]`` (window, starts, ragged cur_len); per
    mesh and case the whole output and the collectives' bytes by kind."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.sharding.dtensor_calls import attention_call

    out = {}
    q, k, v = setup["q"], setup["k"], setup["v"]
    meshes = {"data2_model2": ((2, 2), [Shard(0), Shard(2)], [Shard(0), Shard(2)]),
              "model4": ((1, 4), [Replicate(), Shard(2)], [Replicate(), Shard(2)]),
              "seq_over_both": ((2, 2), [Replicate(), Replicate()], [Shard(2), Shard(2)])}
    for name, (shape, qp, kp) in meshes.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        qd = DTensor.from_local(q, mesh, [Replicate()] * 2).redistribute(mesh, qp)
        kd, vd = (DTensor.from_local(t, mesh, [Replicate()] * 2).redistribute(mesh, kp) for t in (k, v))
        for i, case in enumerate(setup["cases"]):
            with OpCounter() as counter:
                got = attention_call(dec.decode_attention_plain, qd, (kd, vd), 1, case["cur"],
                                     seq_partial=dec.decode_attention_partial, window=case["window"],
                                     starts=case["starts"])
            out[f"{name}/{i}"] = {"out": got.full_tensor().tolist(), "placements": [str(p) for p in got.placements],
                                  "collectives": counter.summary()["collectives"]}
    return out


def vocab_ce(setup, rank):
    """The loss's chunk sums on DTensors placed by the train rules (rows on
    'data'; the head's embedding dim on 'data' and its vocabulary on
    'model'), the logits kept sharded by vocabulary, on a (2, 2), a (1, 4)
    and a (4, 1) mesh, for each case of ``setup["cases"]``: the whole sums
    and the collectives' bytes by kind."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.sharding.dtensor_calls import ce_chunk_vocab_sharded
    from repro_torch.sharding.logical import axis_rules, logical_placements, logical_to_pspec, rules_for

    rules = rules_for("train")
    out = {}
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        name = "x".join(map(str, shape))

        def put(t, axes):
            whole = DTensor.from_local(t, mesh, [Replicate()] * 2)
            return whole.redistribute(mesh, logical_placements(
                logical_to_pspec(axes, rules, shape=tuple(t.shape), mesh=dict(zip(("data", "model"), shape))),
                mesh, t.ndim))

        for i, case in enumerate(setup["cases"]):
            args = (put(case["h"], ("act_batch", "act_seq", "act_embed")), put(case["head"], ("embed", "vocab")),
                    put(case["t"], ("act_batch", "act_seq")), put(case["m"], ("act_batch", "act_seq")))
            with OpCounter() as counter, implicit_replication(), axis_rules(rules, mesh):
                got = ce_chunk_vocab_sharded(*args)
            out[f"{name}/{i}"] = {"sums": got.full_tensor().tolist(), "collectives": counter.summary()["collectives"]}
    return out


CHECKS = {"pods": world_of_8, "one_rank": world_of_1, "seq_decode": seq_decode, "vocab_ce": vocab_ce}


WORLDS = {"pods": 8, "one_rank": 1, "seq_decode": 4, "vocab_ce": 4}


def rank_main(rank, world, root, check):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(root, f"{check}.store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        setup = torch.load(os.path.join(root, "setup.pt"), weights_only=False)
        out = CHECKS[check](setup, rank)
        with open(os.path.join(root, f"{check}.rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def _child(i, world, root, check):
    rank_main(i + 1, world, root, check)


def run(root, check):
    """``check`` in its world: this process is rank 0, the other ranks are
    spawned; a rank that fails fails the run, and no rank outlives it."""
    world = WORLDS[check]
    ctx = None
    if world > 1:
        # a fork server imports torch and the port once and forks the ranks
        # from its single thread: the ranks skip those seconds of imports
        # (torch._dynamo too, which a process's first DTensor imports)
        multiprocessing.set_forkserver_preload(
            ["__main__", "torch.distributed.tensor", "torch._dynamo", "repro_torch.serve"])
        ctx = mp.start_processes(_child, args=(world, root, check), nprocs=world - 1, start_method="forkserver",
                                 join=False)
    try:
        rank_main(0, world, root, check)
        while ctx is not None and not ctx.join():
            pass
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()


if __name__ == "__main__":
    for check in sys.argv[2:]:
        run(sys.argv[1], check)
