"""Meshes and logical sharding in the port (``sharding/``, ``launch/mesh.py``,
the mesh half of ``serve/transport.py`` and ``serve/placement.py``, the
routed cascade across ranks) against the JAX package on the CPU.

Rule parity: ``tests/test_sharding.py``'s cases, then ``logical_to_pspec``
entry for entry equal to JAX's at every leaf of ``param_axes`` /
``ensemble_axes`` / ``cache_axes`` of the main path's two configs and
mixtral-8x22b at published shapes, under every rule kind, on the
production sizes (JAX's side on a ``Mesh`` of repeated CPU devices, the
port's on the ``{axis: size}`` mapping), and the axes trees of all ten
configs equal to JAX's ``unbox`` axes.

Across ranks: no pytest worker starts a process group.  One spawned
8-rank ``gloo`` world (``tests/torch_mesh_world.py``) runs the pod-placed
classify of ``tests/test_placement_transport.py``'s ``_POD_SCRIPT`` on a
(2, 2, 2) mesh, assertion for assertion, and on a (4, 2, 1) mesh with two
members a 'pod' rank, on the JAX package's own initial weights carried
over through numpy; a one-rank world holds the counterpart of
``test_sharded_transport_single_device_degrades_to_replication`` and the
mesh placement's refusal of generate and serve_continuous, in the same
subprocess, which also runs ``tests/test_torch_placement.py``'s
degenerate placement.  Both worlds meet through a ``FileStore`` under the
session's temporary directory and import no JAX; the ``mesh_worlds``
fixture runs them once a session for both files.
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock
from jax.sharding import Mesh

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import deferral as j_deferral
from repro.core import ensemble as j_ens
from repro.models import api as j_api
from repro.models.params import unbox
from repro.sharding import logical as jl
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.core import deferral
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec, bucket_chunks
from repro_torch.launch.mesh import make_production_mesh, production_axis_sizes
from repro_torch.models import api
from repro_torch.models.params import tree_map
from repro_torch.serve import CascadeServer, CascadeTier
from repro_torch.sharding import logical as tl
from repro_torch.sharding.mesh import local_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
KINDS = ("train", "prefill", "decode", "decode_long")


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(tuple(sizes.values())), tuple(sizes))


def _spec(p):
    """A PartitionSpec (either package's) as a plain tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases, on both packages
# ---------------------------------------------------------------------------

SIZES44 = {"data": 4, "model": 4}


def test_basic_translation():
    spec = tl.logical_to_pspec(("embed", "mlp"), tl.make_rules("train"), shape=(256, 512), mesh=SIZES44)
    assert spec == tl.PartitionSpec("data", "model")
    assert _spec(spec) == _spec(jl.logical_to_pspec(("embed", "mlp"), jl.make_rules("train"), shape=(256, 512),
                                                    mesh=_jmesh(SIZES44)))


def test_indivisible_axis_dropped():
    args = (("embed", "kv_heads", "head_dim"),)
    kw = dict(shape=(256, 2, 64))
    spec = tl.logical_to_pspec(*args, tl.make_rules("train"), mesh=SIZES44, **kw)
    assert spec[1] is None
    assert _spec(spec) == _spec(jl.logical_to_pspec(*args, jl.make_rules("train"), mesh=_jmesh(SIZES44), **kw))


@pytest.mark.parametrize("n_experts", [8, 2])
def test_expert_fallback_to_expert_mlp(n_experts):
    axes, shape = ("experts", "embed", "expert_mlp"), (n_experts, 256, 512)
    spec = tl.logical_to_pspec(axes, tl.make_rules("train"), shape=shape, mesh=SIZES44)
    if n_experts == 8:  # divisible: experts take 'model', expert_mlp loses it
        assert spec[0] == "model" and spec[2] is None
    else:  # not divisible: expert_mlp gets 'model' instead
        assert spec[0] is None and spec[2] == "model"
    assert _spec(spec) == _spec(jl.logical_to_pspec(axes, jl.make_rules("train"), shape=shape, mesh=_jmesh(SIZES44)))


def test_decode_long_rules():
    assert tl.rules_for("decode", batch=1)["kv_seq"] == ("data", "model")
    assert tl.rules_for("decode", batch=128)["kv_seq"] == "model"
    for kind in KINDS:
        for pod in (False, True):
            assert tl.make_rules(kind, pod=pod) == jl.make_rules(kind, pod=pod)
    assert tl.rules_for("decode", pod=True, batch=1) == jl.rules_for("decode", pod=True, batch=1)


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert tl.constrain(x, ("act_batch", "act_embed")) is x
    with tl.axis_rules(tl.make_rules("train"), SIZES44):
        assert tl.current_rules()["embed"] == ("data",) and tl.current_mesh() is SIZES44
        assert tl.constrain(x, ("act_batch", "act_embed")) is x  # a plain tensor: nothing to redistribute
    assert tl.current_rules() is None and tl.current_mesh() is None


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tl.logical_placements(tl.PartitionSpec(("pod", "data"), "model"), mesh, 2) == [Shard(0), Shard(0), Shard(1)]
    assert tl.logical_placements(tl.PartitionSpec(None, None), mesh, 2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tl.logical_placements(tl.PartitionSpec(("data", "pod")), mesh, 1)
    with pytest.raises(ValueError, match="more entries"):
        tl.logical_placements(tl.PartitionSpec(None, None), mesh, 1)


def test_tree_pspecs_and_no_card():
    axes = {"a": ("embed", "mlp"), "b": [("vocab", "embed")]}
    shapes = {"a": torch.empty(256, 512, device="meta"), "b": [torch.empty(102, 256, device="meta")]}
    got = tl.tree_pspecs(axes, tl.make_rules("train"), shapes, SIZES44)
    assert got == {"a": ("data", "model"), "b": [(None, "data")]}
    assert tl.tree_pspecs(axes, tl.make_rules("train")) == {"a": ("data", "model"), "b": [("model", "data")]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_mesh()  # None means the card: no fallback to the CPU
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# the axes trees and their specs at published shapes
# ---------------------------------------------------------------------------


def _norm(t):
    if isinstance(t, dict):
        return {k: _norm(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_norm(v) for v in t]
    return tuple(t)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_equal_jax(arch):
    """``param_axes``, ``ensemble_axes`` and ``cache_axes`` are the axes of
    the JAX package's boxed trees, key for key (the bridge carries values
    over the same structure)."""
    jc, c = j_get_config(arch).reduced(), get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    assert _norm(unbox(jax.eval_shape(lambda: j_api.init_params(jc, key)))[1]) == api.param_axes(c)
    assert _norm(unbox(jax.eval_shape(lambda: j_ens.init_ensemble(jc, 2, key)))[1]) == ens.ensemble_axes(c)
    if c.family == "encoder":
        with pytest.raises(ValueError):
            api.cache_axes(c)
        return
    assert _norm(unbox(jax.eval_shape(lambda: j_api.init_cache(jc, 2, 16)))[1]) == api.cache_axes(c)


def _walk(axes, shapes, path=()):
    if isinstance(axes, dict):
        for k in axes:
            yield from _walk(axes[k], shapes[k], path + (k,))
    elif isinstance(axes, list):
        for j, (a, s) in enumerate(zip(axes, shapes)):
            yield from _walk(a, s, path + (str(j),))
    else:
        yield "/".join(path), axes, tuple(shapes.shape)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internlm2-1.8b", "mixtral-8x22b"])
def test_pspecs_equal_jax_at_published_shapes(arch):
    """Every leaf of the params, the 3-member ensemble and a (128, 4096)
    cache, at the published widths (the port's trees on the meta device),
    under every rule kind: pod=False on the 256- and the 512-rank mesh,
    pod=True on the 512-rank one."""
    c = get_config(arch)
    g = torch.Generator().manual_seed(0)
    trees = [
        (api.param_axes(c), api.init_params(c, g, "meta")),
        (ens.ensemble_axes(c), ens.init_ensemble(c, 3, g, "meta")),
        (api.cache_axes(c), api.init_cache(c, 128, 4096, "meta")),
    ]
    n = 0
    for multi_pod in (False, True):
        sizes = production_axis_sizes(multi_pod=multi_pod)
        jmesh = _jmesh(sizes)
        for kind in KINDS:
            for pod in ((False, True) if multi_pod else (False,)):
                trules, jrules = tl.make_rules(kind, pod=pod), jl.make_rules(kind, pod=pod)
                for axes_tree, shapes_tree in trees:
                    for path, axes, shape in _walk(axes_tree, shapes_tree):
                        got = tl.logical_to_pspec(axes, trules, shape=shape, mesh=sizes)
                        want = jl.logical_to_pspec(axes, jrules, shape=shape, mesh=jmesh)
                        assert _spec(got) == _spec(want), (arch, kind, pod, path, shape, got, want)
                        n += 1
    assert n > 100


# ---------------------------------------------------------------------------
# across ranks: the spawned gloo worlds
# ---------------------------------------------------------------------------

_BASE = dict(family="dense", remat=False, dtype="float32", vocab_size=64)
# tests/test_placement_transport.py's _POD_SCRIPT tiers, in float32
SMALL = JModelConfig(name="tiny-s", n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2, **_BASE)
BIG = JModelConfig(name="tiny-b", n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4, **_BASE)
B, S = 16, 8


def _port(jcfg, seed, k):
    """The JAX package's initial ensemble, carried over through numpy, and
    its JAX values."""
    values = jax.jit(lambda key: unbox(j_ens.init_ensemble(jcfg, k, key))[0])(jax.random.PRNGKey(seed))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    port = {"cfg": cfg, "k": k, "values": params_from_numpy(jax.tree.map(np.asarray, values), cfg, device="cpu")}
    return port, values


def _setup():
    """The tiers' weights and the run's inputs, and the JAX package's
    routing of those inputs on the same weights."""
    small, j_small = _port(SMALL, 0, 2)
    toks = np.random.default_rng(2).integers(0, 64, (B, S)).astype(np.int32)
    probe = CascadeTier(small["cfg"], small["values"], TierSpec("t1", "confidence", 0.0, k=2), device="cpu")
    score = deferral.confidence_rule(probe.last_logits(toks, eager=True), 0.0).score.numpy()
    # median-confidence threshold -> partial deferral, so 'only the deferred
    # slice crossed' is a strict statement; the 0.75 quantile defers ~12 of
    # 16 rows: a tier-2 cover of two chunks
    setup = {"small": small, "tokens": torch.from_numpy(toks),
             "theta": float(np.median(score)), "theta_hi": float(np.quantile(score, 0.75))}
    big2, j_big2 = _port(BIG, 1, 2)
    setup["big2"] = big2
    setup["big"] = dict(big2, k=1, values=tree_map(lambda t: t[:1].clone(), big2["values"]))
    logits = {name: np.asarray(jax.jit(lambda v, t: j_ens.ensemble_last_logits(v, {"tokens": t}, jcfg))(
        jv, jnp.asarray(toks))) for name, jv, jcfg in (("small", j_small, SMALL), ("big2", j_big2, BIG))}
    logits["big"] = logits["big2"][:1]  # 'big' is big2's first member
    return setup, {f"{names[1]}/{hi}": _jax_routing(logits, names, setup[hi])
                   for names in (("small", "big"), ("small", "big2")) for hi in ("theta", "theta_hi")}


def _jax_routing(logits, names, theta):
    """The JAX package's routing on the tiers' member logits: tier 1's
    confidence rule at ``theta``, the deferred rows answered by tier 2's
    (at -1, which takes every row).  -> {pred, tier_of}."""
    first = j_deferral.apply_rule("confidence", jnp.asarray(logits[names[0]]), theta)
    second = j_deferral.apply_rule("confidence", jnp.asarray(logits[names[1]]), -1.0)
    defer = np.asarray(first.defer)
    return {"pred": np.where(defer, np.asarray(second.pred), np.asarray(first.pred)).tolist(),
            "tier_of": defer.astype(np.int32).tolist()}


def _unplaced(setup, names, theta):
    specs = [TierSpec("t1", "confidence", theta, k=setup[names[0]]["k"], cost=1.0),
             TierSpec("t2", "confidence", -1.0, k=setup[names[1]]["k"], cost=50.0)]
    return CascadeServer([CascadeTier(setup[n]["cfg"], setup[n]["values"], s, device="cpu")
                          for n, s in zip(names, specs)], device="cpu").classify(setup["tokens"].numpy())


WORLD_CHECKS = ("pods", "one_rank")


def run_world(root, setup, timeout):
    """``tests/torch_mesh_world.py``'s worlds, each in its world of ranks,
    on ``setup``, leaving each rank's JSON under ``root``."""
    torch.save(setup, root / "setup.pt")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_world.py"), str(root),
                        *WORLD_CHECKS],
                       env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]


def _read_worlds(root):
    setup = torch.load(root / "setup.pt", weights_only=False)
    worlds = {c: [json.loads((root / f"{c}.rank{r}.json").read_text())
                  for r in range(len(list(root.glob(f"{c}.rank*.json"))))] for c in WORLD_CHECKS}
    return SimpleNamespace(setup=setup, worlds=worlds, jax=json.loads((root / "jax.json").read_text()))


@pytest.fixture(scope="session")
def mesh_worlds(tmp_path_factory):
    """The spawned worlds, run once a session: the first test that asks runs
    them under a lock in the session's shared temporary directory (shared
    by every xdist worker), the others read what it left there.  ->
    ``setup`` (the weights and inputs), ``worlds`` (check -> each rank's
    JSON) and ``jax`` (the JAX package's routing of the same inputs on the
    same weights, keyed by tier 2 and threshold, e.g. ``big/theta_hi``)."""
    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    root = (tmp_path_factory.getbasetemp().parent if shared else tmp_path_factory.getbasetemp()) / "mesh_worlds"
    root.mkdir(exist_ok=True)
    with FileLock(str(root / "lock")):
        if not (root / "done").exists():
            setup, ref = _setup()
            (root / "jax.json").write_text(json.dumps(ref))
            run_world(root, setup, timeout=300)
            (root / "done").touch()
    return _read_worlds(root)


def _same_result(got, ref):
    np.testing.assert_array_equal(got["pred"], ref.pred)
    np.testing.assert_array_equal(got["tier_of"], ref.tier_of)
    np.testing.assert_array_equal(got["tier_counts"], ref.tier_counts)
    np.testing.assert_array_equal(np.asarray(got["scores"], np.float32), ref.scores)
    np.testing.assert_array_equal(got["evaluated"], ref.evaluated)


def _shard_count(rows, sizes):
    """What JAX's logical_to_pspec gives a (rows, S) chunk landing on a slice
    of these axis sizes: the number of example-axis shards."""
    spec = jl.logical_to_pspec(("act_batch", None), jl.make_rules("decode", pod=True), shape=(rows, S),
                               mesh=_jmesh(sizes))
    names = () if spec[0] is None else (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
    return int(np.prod([sizes[a] for a in names]))


def test_pod_placement_across_eight_ranks(mesh_worlds):
    """JAX's _POD_SCRIPT on a (2, 2, 2) mesh of 8 gloo ranks, and a (4, 2, 1)
    mesh with each tier's two members one a 'pod' rank: the placed classify
    equals the port's unplaced server on the JAX package's weights on every
    rank, and that server the JAX package's routing of the same tokens,
    meters the replicated baseline's bytes, reads one count a
    transition, keeps each tier's weights on its slice, and feeds each
    tier-2 chunk ``rows / shard_count`` rows a rank.  Then, in the same
    subprocess, a world of one rank: the counterpart of
    ``test_sharded_transport_single_device_degrades_to_replication`` and
    the mesh placement's refusals."""
    setup, worlds = mesh_worlds.setup, mesh_worlds.worlds
    ranks = worlds["pods"]
    assert len(ranks) == 8
    # the unplaced server the ranks are held to, itself held to the JAX
    # package's routing of the same tokens on the same weights
    refs = {}
    for names in (("small", "big"), ("small", "big2")):
        for hi in ("theta", "theta_hi"):
            refs[names[1], hi] = ref = _unplaced(setup, names, setup[hi])
            want = mesh_worlds.jax[f"{names[1]}/{hi}"]
            np.testing.assert_array_equal(ref.pred, want["pred"])
            np.testing.assert_array_equal(ref.tier_of, want["tier_of"])
    ref, ref_hi = refs["big", "theta"], refs["big", "theta_hi"]
    ref2, ref2_hi = refs["big2", "theta"], refs["big2", "theta_hi"]
    n_def = int(ref.tier_counts[1])
    assert 0 < n_def < B
    n_pad = min(sum(bucket_chunks(n_def, 8)), B)
    slice222 = {"pod": 1, "data": 2, "model": 2}
    slice421 = {"pod": 2, "data": 2, "model": 1}
    for r, out in enumerate(ranks):
        run = out["pod222"]
        assert run["hosts"] == ["pod0", "pod1"] and run["disjoint"] and run["sharded_link"]
        assert run["ranks"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        _same_result(run["result"], ref)
        _same_result(out["pod222_replicated"]["result"], ref)
        link, link_rep = run["link"], out["pod222_replicated"]["link"]
        assert link["examples"] == n_def and link["hops"] == 1
        assert link["bytes"] == n_pad * (S * 4 + 4) < B * (S * 4 + 4)  # only the deferred slice
        assert link_rep == link
        # one count scalar a transition, then the (B,) results and counts
        assert run["host_fetch"] == {"bytes": 4 + B * 4 * 3 + 2 * 4, "calls": 2}
        # each rank holds its own slice's members and nothing of the other tier
        tier = 0 if r < 4 else 1
        assert run["here"] == [tier == 0, tier == 1]
        for i, held in enumerate(run["held"]):
            assert held["meta"] == (i != tier) and held["local_meta"] == (i != tier)
            if i == tier:
                assert held["members"] == held["local_members"] == setup[("small", "big")[i]]["k"]
        # the probe: 8 rows land as 2 shards of 4 on slice 1, block by
        # DTensor's own layout (data coordinate d holds rows 4d .. 4d+3)
        probe = out["probe"]
        assert probe["shard_counts"] == [2] and probe["global_shape"] == [8, 4]
        if r >= 4:
            d = ((r - 4) // 2) % 2
            assert probe["local_shape"] == [4, 4] and probe["full_equal"]
            assert probe["local_rows"] == [float(4 * (4 * d + j)) for j in range(4)]
        else:
            assert probe["local_shape"] == [0]
        # the two-chunk cover: each tier-2 chunk fed rows / shard_count a rank
        hi = out["pod222_two_chunks"]
        _same_result(hi["result"], ref_hi)
        n_def3 = int(ref_hi.tier_counts[1])
        assert n_def3 > 8
        chunks = bucket_chunks(n_def3, 8)
        assert len(chunks) >= 2
        want = [c // _shard_count(c, slice222) for c in chunks] if r >= 4 else []
        assert hi["fed_rows"][1] == want, (r, hi["fed_rows"], chunks)
        assert hi["fed_rows"][0] == ([B] if r < 4 else [])
        # (4, 2, 1): two members one a 'pod' rank in both tiers; tier 2's rows
        # shard over ('pod', 'data') too, so its ranks trade rows over 'pod'
        for key, want_ref, theta in (("pod421", ref2, "theta"), ("pod421_two_chunks", ref2_hi, "theta_hi")):
            run = out[key]
            _same_result(run["result"], want_ref)
            tier = 0 if r < 4 else 1
            for i, held in enumerate(run["held"]):
                if i == tier:
                    assert held["members"] == held["local_members"] == 1
            assert run["host_fetch"]["calls"] == 2
            n = int(want_ref.tier_counts[1])
            fed = [c // _shard_count(c, slice421) for c in bucket_chunks(n, 8)] if r >= 4 else []
            assert run["fed_rows"][1] == [f * 2 for f in fed]  # the 'pod' peers' rows join the rank's
            assert run["link"]["examples"] == n
    # then a world of one rank: a (1, 1, 1) pod mesh has nowhere to shard, so
    # the sharded hand-off degrades to replication with metering unchanged;
    # a one-tier pod placement classifies as the unplaced server; generate
    # and serve_continuous over a mesh placement raise; the production mesh
    # needs its 256 ranks
    (out,) = worlds["one_rank"]
    assert out["mesh_shape"] == [1, 1, 1]
    sh = out["sharded"]
    assert sh["shard_counts"] == [1, 1] and sh["equal"]
    assert sh["bytes"] == 8 * 4 * 4 + 8 * 4 and sh["examples"] == 8
    assert sh["data_size"] == 1 and sh["spec"] == [["pod", "data"], None]  # size-1 axes divide: one shard
    assert "needs 256 ranks" in out["production_mesh"] and out["submeshes"] == 1
    assert out["classify_equal"]
    for what in ("generate", "serve_continuous"):
        assert out["refused"][what].startswith(f"{what} over a mesh placement is not ported yet")
