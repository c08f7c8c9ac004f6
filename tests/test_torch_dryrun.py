"""The port's dry run (``launch/op_cost.py``, ``launch/roofline.py``,
``launch/dryrun.py`` and the kernels' meta routes) on the CPU.

The counterparts of ``tests/test_cost_model_stack.py``, case for case,
against the port's op counter and ``roofline_terms`` with the H100
figures; each kernel entry's meta route against its ``cost``; the port's
matmul FLOPs at published widths equal to the JAX walker's ``dot_general``
FLOPs outside ``pallas_call`` (both sides trace without computing); and one
run of the CLI in a subprocess for a 256-rank and a 512-rank world (no
pytest worker starts a process group).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.kernels import config as kcfg
from repro.launch.jaxpr_cost import _dot_flops, _sub_jaxprs
from repro.models import api as j_api
from repro.models.counting import count_params as j_count_params
from repro.models.params import unbox
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels import build
from repro_torch.launch.op_cost import OpCounter, estimate_fn_cost
from repro_torch.obs.op_charges import charge_collective
from repro_torch.launch.roofline import collective_terms, roofline_terms
from repro_torch.models import api
from repro_torch.models.counting import count_params

ROOT = os.path.join(os.path.dirname(__file__), "..")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the op counter: tests/test_cost_model_stack.py's walker cases
# ---------------------------------------------------------------------------


def test_matmul_flops_exact():
    a, b = meta(256, 512), meta(512, 128)
    c = estimate_fn_cost(lambda x, y: x @ y, a, b)
    assert c["flops"] == c["matmul_flops"] == 2 * 256 * 512 * 128
    # einsum's batched product too, and a linear's bias add beside its product
    c = estimate_fn_cost(lambda x, y: torch.einsum("ebd,edf->ebf", x, y), meta(3, 64, 32), meta(3, 32, 16))
    assert c["matmul_flops"] == 2 * 3 * 64 * 32 * 16
    c = estimate_fn_cost(torch.nn.functional.linear, meta(8, 32), meta(16, 32), meta(16))
    assert c["matmul_flops"] == 2 * 8 * 32 * 16 and c["flops"] == c["matmul_flops"] + 8 * 16


def test_python_loop_counts_every_trip():
    """The models loop over layers in Python: a loop of 10 counts 10 times
    (the JAX walker multiplies a scan body by its trip count)."""
    a = meta(64, 64)

    def f(x):
        y = x
        for _ in range(10):
            y = y @ x
        return y

    c1 = estimate_fn_cost(lambda x: x @ x, a)
    c10 = estimate_fn_cost(f, a)
    assert c10["flops"] >= 10 * c1["flops"]
    assert c10["flops"] < 11 * c1["flops"] + 64 * 64 * 20


class _Square(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x @ x

    @staticmethod
    def backward(ctx, g):
        return g


class _Outer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = torch.nn.Sequential(torch.nn.Identity())

    def forward(self, x):
        return self.inner(_Square.apply(x))


def test_autograd_function_and_nested_module_are_counted():
    """A call through an ``autograd.Function`` (the kernels' training
    wrappers) and a nested module is counted (the JAX walker must descend
    into an inner jit)."""
    c = estimate_fn_cost(_Outer(), meta(128, 128))
    assert c["flops"] >= 2 * 128**3


@pytest.mark.parametrize("how", ["copy_", "index_copy_"])
def test_slice_write_charged_for_slice_only(how):
    """A write into a slice (the KV cache's update) is charged 2x the slice,
    not the 4 MB buffer, as ``dynamic_update_slice`` is."""
    buf, upd = meta(1024, 1024), meta(1, 1024)

    def write(b, u):
        if how == "copy_":
            b[5:6] = u
        else:
            b.index_copy_(0, torch.full((1,), 5, dtype=torch.int64, device="meta"), u)

    c = estimate_fn_cost(write, buf, upd)
    assert 0 < c["bytes"] <= 4 * 1024 * 2 + 1024


def test_decode_meta_route_charges_the_kv_sweep():
    """The decode kernel on meta tensors computes nothing, launches nothing
    and charges at least the K + V sweep of every visible row: all of them
    where the lengths are unknown (a meta tensor), its own rows otherwise."""
    from repro_torch.kernels.decode_attention import ops as dops

    B, KVH, S, hd, H = 2, 2, 2048, 64, 4
    q, kc = meta(B, 1, H, hd, dtype=torch.bfloat16), meta(B, KVH, S, hd, dtype=torch.bfloat16)
    sweep = B * KVH * S * hd * 2 * 2  # k + v streamed once
    before = build.launch_counts()
    for cur, rows in ((meta(B, dtype=torch.int32), B * S), (S, B * S), (100, B * 100)):
        c = estimate_fn_cost(lambda q, k, v: dops.decode_attention_bksd(q, k, v, cur), q, kc, kc)
        assert c["kernels"]["decode_attention"]["calls"] == 1
        assert c["bytes"] >= sweep * rows // (B * S)
        assert c["kernels"]["decode_attention"] == dict(calls=1, **{k: v for k, v in dops.cost(q, kc, kc, cur).items()
                                                                     if k != "unit"})
    assert build.launch_counts() == before


def test_flash_meta_route_charges_the_causal_half():
    from repro_torch.kernels.flash_attention import ops as fops

    B, S, H, hd = 1, 512, 2, 64
    q = meta(B, S, H, hd, dtype=torch.bfloat16)
    c = estimate_fn_cost(lambda q, k, v: fops.flash_attention(q, k, v), q, q, q)
    assert c["flops"] >= 2 * 2 * B * H * S * S * hd // 2  # at least the causal half
    assert fops.visible_pairs(S, S, True) == S * (S + 1) // 2
    assert fops.visible_pairs(S, S, True, 64) == sum(min(i + 1, 64) for i in range(S))
    assert fops.visible_pairs(3, 5, False) == 15


def test_collective_in_a_loop_counts_every_trip():
    """A collective inside a loop of 7 counts 7 times (the HLO parser
    multiplies a while body's collectives by its trip count); the counter's
    kinds are the parser's."""
    with OpCounter() as c:
        for _ in range(7):
            charge_collective("all-reduce", 1024 * 32 * 4)
        charge_collective("all-gather", 64 * 128 * 2)
    coll = collective_terms(c)
    assert coll["all-reduce"] == 7 * 1024 * 32 * 4 and coll["all-gather"] == 64 * 128 * 2
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
    charge_collective("all-reduce", 1)  # no counter active: nothing to charge, no error
    assert collective_terms(c.summary())["all-reduce"] == 7 * 1024 * 32 * 4


def test_roofline_terms_bottleneck():
    hw = H100_SXM
    t = roofline_terms({"flops": hw["peak_flops_bf16"], "bytes accessed": 1.0}, 0, 256)
    assert t["bottleneck"] == "compute" and abs(t["t_compute_s"] - 1.0) < 1e-9
    t2 = roofline_terms({"flops": 1.0, "bytes accessed": hw["hbm_bw"]}, 0, 256)
    assert t2["bottleneck"] == "memory" and abs(t2["t_memory_s"] - 1.0) < 1e-9
    t3 = roofline_terms({"flops": 0.0, "bytes accessed": 0.0}, 256 * hw["ici_bw"], 256)
    assert t3["bottleneck"] == "collective" and abs(t3["t_collective_s"] - 1.0) < 1e-9
    assert (hw["peak_flops_bf16"], hw["hbm_bw"], hw["ici_bw"]) == (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# every kernel entry's meta route: the outputs' shapes, its cost charged,
# nothing launched
# ---------------------------------------------------------------------------


def _entries():
    from repro_torch.kernels.agreement import ops as ag
    from repro_torch.kernels.compaction import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.rwkv6_wkv import ops as wk

    bf = torch.bfloat16
    x = meta(3, 8, 1000)
    tree, mask = {"t": meta(16, 8, dtype=torch.int32), "i": meta(16, dtype=torch.int32)}, meta(16, dtype=torch.bool)
    kp, pages = meta(3, 9, 2, 16, 64, dtype=bf), meta(4, 2, dtype=torch.int32)
    q = meta(2, 40, 8, 64, dtype=bf)
    kv = meta(2, 40, 2, 64, dtype=bf)
    qd, kc = meta(4, 1, 8, 64, dtype=bf), meta(4, 2, 50, 64, dtype=bf)
    qp, cur = meta(12, 1, 8, 64, dtype=bf), meta(4, dtype=torch.int32)
    xs, dt, A, Bm = meta(2, 30, 4, 32, dtype=bf), meta(2, 30, 4), meta(4), meta(2, 30, 1, 16, dtype=bf)
    r, lw, u = meta(2, 30, 4, 32, dtype=bf), meta(2, 30, 4, 32), meta(4, 32)
    return {
        "agreement": ("agreement", lambda: ag.member_stats(x), ag.cost(x), [(3, 8)] * 3),
        "compaction": ("compaction", lambda: cp.compact_tree(tree, mask), cp.compact_cost(tree, mask), None),
        "gather_rows": ("compaction", lambda: cp.gather_rows(tree["t"], meta(5, dtype=torch.int32)),
                        cp.gather_cost(tree["t"], meta(5, dtype=torch.int32)), [(5, 8)]),
        "paged_kv_view": ("compaction", lambda: cp.paged_kv_view(kp, kp, pages), cp.paged_kv_view_cost(kp, kp, pages),
                          [(12, 2, 32, 64)] * 2),
        "flash_attention": ("flash_attention", lambda: fl.flash_attention(q, kv, kv), fl.cost(q, kv, kv),
                            [tuple(q.shape)]),
        "decode_attention": ("decode_attention", lambda: dec.decode_attention_bksd(qd, kc, kc, 30),
                             dec.cost(qd, kc, kc, 30), [tuple(qd.shape)]),
        "decode_attention_paged": ("decode_attention_paged", lambda: dec.decode_attention_paged(qp, kp, kp, pages, cur),
                                   dec.paged_cost(qp, kp, kp, pages, cur), [tuple(qp.shape)]),
        "mamba2_ssd": ("mamba2_ssd", lambda: ssd.ssd(xs, dt, A, Bm, Bm, return_final_state=True),
                       ssd.cost(xs, dt, A, Bm, Bm), [(2, 30, 4, 32), (2, 4, 16, 32)]),
        "rwkv6_wkv": ("rwkv6_wkv", lambda: wk.wkv6(r, r, r, lw, u, return_final_state=True), wk.cost(r, r, r, lw, u),
                      [(2, 30, 4, 32), (2, 4, 32, 32)]),
    }


@pytest.mark.parametrize("entry", ["agreement", "compaction", "gather_rows", "paged_kv_view", "flash_attention",
                                   "decode_attention", "decode_attention_paged", "mamba2_ssd", "rwkv6_wkv"])
def test_kernel_meta_route_charges_its_cost(entry):
    name, call, cost, shapes = _entries()[entry]
    before = build.launch_counts()
    with OpCounter() as c:
        out = call()
    assert c.kernels[name] == {"calls": 1, "flops": cost["flops"], "bytes": cost["bytes"]}
    assert cost["bytes"] > 0 and cost["unit"] in ("bf16", "tf32", "f32")
    leaves = [t for t in (out if isinstance(out, (tuple, list)) else [out]) if isinstance(t, torch.Tensor)]
    assert all(t.is_meta for t in leaves)
    if shapes is not None:
        assert [tuple(t.shape) for t in leaves] == shapes
    assert build.launch_counts() == before  # a meta call launches nothing


@pytest.mark.parametrize("scan", ["mamba2_ssd", "rwkv6_wkv"])
def test_scan_meta_route_under_grad_counts_its_backward(scan):
    """Under grad a scan's meta route goes through its autograd Function,
    so a training step's count holds the backward's recompute of the plain
    scan as well as the kernel's forward, and every input gets a
    gradient."""
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.rwkv6_wkv import ops as wk

    bf = torch.bfloat16
    if scan == "mamba2_ssd":
        args = [meta(2, 30, 4, 32, dtype=bf), meta(2, 30, 4), meta(4), meta(2, 30, 1, 16, dtype=bf),
                meta(2, 30, 1, 16, dtype=bf)]
        call, cost = ssd.ssd, ssd.cost
    else:
        args = [meta(2, 30, 4, 32, dtype=bf)] * 3 + [meta(2, 30, 4, 32), meta(4, 32)]
        args = [a.clone() for a in args]
        call, cost = wk.wkv6, wk.cost
    leaves = [a.requires_grad_(True) for a in args]
    with OpCounter() as c:
        y = call(*leaves)
        grads = torch.autograd.grad(y.float().sum(), leaves)
    assert c.kernels[scan]["calls"] == 1 and c.kernels[scan]["flops"] == cost(*args)["flops"]
    assert c.matmul_flops > 0  # the plain scan's recompute (the kernel charges no aten product)
    assert all(g is not None and g.is_meta and g.shape == a.shape for g, a in zip(grads, args))


# ---------------------------------------------------------------------------
# parity with the JAX package at published widths
# ---------------------------------------------------------------------------


def _jax_dots(jaxpr) -> int:
    """``dot_general`` FLOPs of a jaxpr outside ``pallas_call``, through
    the JAX walker's own ``_dot_flops`` and ``_sub_jaxprs``."""
    total = 0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        if p == "pallas_call":
            continue
        subs = _sub_jaxprs(eqn)
        if subs:
            for item in subs:
                if item[0] == "COND":
                    total += max(_jax_dots(j) for j in item[1])
                else:
                    total += item[1] * _jax_dots(item[0])
            continue
        if p == "dot_general":
            total += _dot_flops(eqn)
    return total


PARITY = [("qwen2.5-3b", "prefill_32k"), ("qwen2.5-3b", "decode_32k"), ("mixtral-8x22b", "prefill_32k")]


@pytest.fixture(scope="module")
def jax_dots():
    """The JAX walker's matmul FLOPs of each parity case, traced once on
    abstract inputs with the kernels as ``pallas_call``s."""
    out = {}
    for arch, shp in PARITY:
        cfg, shape = j_get_config(arch), J_SHAPES[shp]
        p_shapes, _ = unbox(jax.eval_shape(functools.partial(j_api.init_params, cfg), jax.random.PRNGKey(0)))
        specs = j_api.input_specs(cfg, shape)
        with kcfg.use_impl("pallas"):
            if shape.kind == "prefill":
                j = jax.make_jaxpr(lambda p, b: j_api.prefill(p, b, cfg))(p_shapes, specs)
            else:
                c_shapes, _ = unbox(jax.eval_shape(lambda: j_api.init_cache(cfg, shape.global_batch, shape.seq_len)))
                j = jax.make_jaxpr(lambda p, t, c, pos: j_api.decode_step(p, t, c, pos, cfg))(
                    p_shapes, specs["token"], c_shapes, specs["pos"])
        out[arch, shp] = _jax_dots(j.jaxpr)
    return out


@pytest.mark.parametrize("arch,shp", PARITY)
def test_matmul_flops_equal_jax_at_published_width(jax_dots, arch, shp):
    """The port's matmul FLOPs equal the JAX walker's ``dot_general`` FLOPs
    outside ``pallas_call`` exactly: qwen2.5-3b at prefill_32k and
    decode_32k, and mixtral-8x22b at prefill_32k, whose experts both
    packages reach through the same products (a token-choice dispatch into
    per-expert (capacity, D) batches), so there the equality is exact too."""
    cfg, shape = get_config(arch), INPUT_SHAPES[shp]
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in api.input_specs(cfg, shape).items()}
    with torch.no_grad():
        if shape.kind == "prefill":
            c = estimate_fn_cost(lambda: api.prefill(params, batch, cfg))
        else:
            cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
            c = estimate_fn_cost(lambda: api.decode_step(params, batch["token"], cache, batch["pos"], cfg))
    assert c["matmul_flops"] == jax_dots[arch, shp] > 0
    kernel = "flash_attention" if shape.kind == "prefill" else "decode_attention"
    assert c["kernels"][kernel]["calls"] == cfg.n_layers


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_equal_jax(arch):
    assert count_params(get_config(arch)) == j_count_params(j_get_config(arch))
    assert count_params(get_config(arch), active_only=True) == j_count_params(j_get_config(arch), active_only=True)


# ---------------------------------------------------------------------------
# the CLI, in a subprocess (a world of 256 and one of 512 fake ranks)
# ---------------------------------------------------------------------------


def _cli(tmp_path, *args):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(tmp_path)],
                       env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return r


def test_dryrun_cli_long_500k(tmp_path):
    """One combination on the 256-rank world: status ok, every rank's
    argument bytes at least the unsharded program's over 256, the window
    forced, the decode kernel charged once a layer."""
    _cli(tmp_path, "--arch", "qwen2.5-3b", "--shape", "long_500k")
    rec = json.loads((tmp_path / "qwen2.5-3b__long_500k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["roofline"]["flops"] > 0 and rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["window_override"] == 4096
    cfg, shape = get_config("qwen2.5-3b"), INPUT_SHAPES["long_500k"]
    nb = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))
    whole = (nb(api.init_params(cfg, torch.Generator(), "meta"))
             + nb(api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")) + 4 * shape.global_batch + 4)
    assert rec["memory"]["argument_bytes"] * 256 >= whole
    assert rec["memory"]["argument_bytes"] < whole  # sharded: a rank holds less than all of it
    assert rec["kernels"]["decode_attention"]["calls"] == cfg.n_layers
    assert rec["params"] == j_count_params(j_get_config("qwen2.5-3b"))
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "params", "active_params", "status", "n_chips", "lower_s",
                        "compile_s", "collectives", "roofline", "xla_cost", "model_flops", "useful_ratio", "memory"}


def test_dryrun_cli_cascade_multi_pod(tmp_path):
    """The cascade step on the (2, 16, 16) world at its published widths
    and depths: the members on 'pod' and their logits gathered into the
    vote (an all-gather counted)."""
    _cli(tmp_path, "--cascade", "--multi-pod", "true")
    rec = json.loads((tmp_path / "abc-cascade__pod2x16x16.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 512 and rec["n_layers"] == [36, 48]
    assert rec["roofline"]["flops"] > 0 and rec["collectives"]["all-gather"] > 0
    assert rec["kernels"]["agreement"]["calls"] == 1
    assert rec["kernels"]["flash_attention"]["calls"] == 36 + 48  # the members folded into one call a layer
    assert rec["replicated_ops"] == {} and "greedily" in rec["sharding_strategies"]


_DTENSOR_CASES = """
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=32)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.op_cost import OpCounter

mesh = init_device_mesh("cpu", (2, 16), mesh_dim_names=("pod", "model"))


def placed(shape, local, placements):
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


x = placed((8, 128), (4, 8), [Shard(0), Shard(1)])
with OpCounter() as c:  # no sharding strategy: replicated, its gathers counted
    y = x.renorm(2, 0, 1.0)
assert c.replicated_ops == {"renorm": 1} and c.collectives["all-gather"] > 0 and tuple(y.shape) == (8, 128), c.summary()
dst = torch.empty(8, 256, device="meta")
with OpCounter() as c:  # a slice write into a plain tensor: each rank's own
    dst[:, :128] = x
assert c.local_writes == {"copy_": 1} and sum(c.collectives.values()) == 0, c.summary()
buf = torch.zeros(8, 128, device="meta")
with OpCounter() as c:  # another in-place op into a plain tensor: replicated, the plain tensor whole
    out = buf.add_(x)
assert out is buf and c.replicated_ops == {"add_": 1} and c.collectives["all-gather"] > 0, c.summary()
h = placed((1, 80, 64), (1, 3, 64), [Shard(1), Shard(1)])
with OpCounter() as c:  # 80 heads over 32 ranks under a view: gathered whole first
    v = h.reshape(1, 5120)
assert tuple(v.shape) == (1, 5120) and c.collectives["all-gather"] > 0 and not c.replicated_ops, c.summary()
g = placed((1, 8, 1, 320), (1, 8, 1, 20), [Replicate(), Shard(3)])
with OpCounter() as c:  # a view DTensor cannot carry 16 shards through (5 groups): replicated
    w = g.reshape(1, 8, 1, 5, -1)
assert tuple(w.shape) == (1, 8, 1, 5, 64) and c.replicated_ops == {"view": 1}, c.summary()
try:
    with OpCounter() as c:  # anything else propagates: here a plain tensor beside a DTensor
        x + torch.empty(8, 128, device="meta")
except RuntimeError as e:
    assert "mixed torch.Tensor and DTensor" in str(e), e
else:
    raise AssertionError("a failed op was swallowed")
assert not c.replicated_ops and not c.local_writes
print("OK")"""


def test_op_counter_takes_dtensor_failures_apart():
    """On DTensors (a fake 32-rank world, in a subprocess) the counter
    replicates only an op DTensor has no strategy for, a view DTensor
    cannot carry a sharding through and another in-place op into a plain
    tensor, keeps a slice write into a plain tensor local, gathers an
    unevenly sharded dim before a view, and lets any other failure
    propagate."""
    r = subprocess.run([sys.executable, "-c", _DTENSOR_CASES], env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stdout[-3000:] + r.stderr[-6000:]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the decode over a sequence-sharded cache: the ranks' partial softmaxes
# merged by all-reduces (4 gloo ranks, tests/torch_mesh_world.py)
# ---------------------------------------------------------------------------

SEQ_DECODE_CASES = [  # cur_len ragged, a window, left-pad starts (every row sees some key)
    dict(cur=[64, 37, 5, 50], window=None, starts=None),
    dict(cur=[64, 37, 9, 50], window=20, starts=None),
    dict(cur=[60, 40, 30, 64], window=None, starts=[0, 17, 3, 33]),
    dict(cur=[64, 33, 12, 50], window=24, starts=[2, 0, 5, 40]),
]


def test_seq_sharded_decode_merges_to_the_unsharded_answer(tmp_path):
    """The dense decode on DTensors whose (B, KVH, S, hd) cache is sharded
    along S: each rank attends its own keys (their global offsets in
    ``cur_len``, the window and ``starts``), and the merge of the partial
    softmaxes equals ``decode_attention_plain`` on the whole cache within
    1e-5 (f32), on every rank and mesh; no all-gather moves more than q's
    bytes (the cache stays put) and the merge's all-reduces move O(B·H·hd)."""
    from repro_torch.kernels.decode_attention import ops as dec

    rng = np.random.default_rng(11)
    B, H, KVH, S, hd = 4, 8, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, KVH, S, hd)).astype(np.float32)) for _ in range(2))
    cases = [dict(cur=torch.tensor(c["cur"], dtype=torch.int32), window=c["window"],
                  starts=None if c["starts"] is None else torch.tensor(c["starts"], dtype=torch.int32))
             for c in SEQ_DECODE_CASES]
    torch.save({"q": q, "k": k, "v": v, "cases": cases}, tmp_path / "setup.pt")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_world.py"), str(tmp_path),
                        "seq_decode"], env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    ranks = [json.loads((tmp_path / f"seq_decode.rank{i}.json").read_text()) for i in range(4)]
    q_bytes, out_bytes = q.numel() * 4, q.numel() * 4
    for i, c in enumerate(cases):
        want = dec.decode_attention_plain(q, k, v, c["cur"], window=c["window"], starts=c["starts"])
        for mesh in ("data2_model2", "model4", "seq_over_both"):
            for rank in ranks:
                got = rank[f"{mesh}/{i}"]
                torch.testing.assert_close(torch.tensor(got["out"]), want, rtol=1e-5, atol=1e-5)
                coll = got["collectives"]
                assert coll["all-gather"] <= q_bytes, (mesh, coll)
                assert 0 < coll["all-reduce"] <= 2 * 3 * out_bytes, (mesh, coll)


# ---------------------------------------------------------------------------
# the loss with the vocabulary sharded (4 gloo ranks, tests/torch_mesh_world.py)
# ---------------------------------------------------------------------------

VOCAB_CE_MESHES = ("2x2", "1x4", "4x1")
VOCAB_CE_CASES = 3  # B 4, c 6, D 4, V 16; integer logits, so the maxima tie


def _vocab_ce_case(rng, i):
    """h and head in {-1, 0, 1} (integer logits, exact in f32: most rows
    tie at their maximum); targets drawn a third each from the first index
    of the maximum, a later tied index and anywhere; a mask with zeros in
    case 1 and 2."""
    B, c, D, V = 4, 6, 4, 16
    h = rng.integers(-1, 2, (B, c, D)).astype(np.float32)
    head = rng.integers(-1, 2, (D, V)).astype(np.float32)
    logits = h @ head
    t = rng.integers(0, V, (B, c))
    for b in range(B):
        for j in range(c):
            top = np.flatnonzero(logits[b, j] == logits[b, j].max())
            kind = (b * c + j) % 3
            t[b, j] = top[0] if kind == 0 else top[-1] if kind == 1 else t[b, j]
    m = np.ones((B, c), np.float32) if i == 0 else (rng.random((B, c)) < 0.7).astype(np.float32)
    return {k: torch.from_numpy(x) for k, x in dict(h=h, head=head, t=t.astype(np.int64), m=m).items()}


@pytest.fixture(scope="module")
def vocab_ce_world(tmp_path_factory):
    rng = np.random.default_rng(5)
    cases = [_vocab_ce_case(rng, i) for i in range(VOCAB_CE_CASES)]
    root = tmp_path_factory.mktemp("vocab_ce")
    torch.save({"cases": cases}, root / "setup.pt")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_world.py"), str(root), "vocab_ce"],
                       env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return cases, [json.loads((root / f"vocab_ce.rank{i}.json").read_text()) for i in range(4)]


@pytest.mark.parametrize("case", range(VOCAB_CE_CASES))
@pytest.mark.parametrize("mesh", VOCAB_CE_MESHES)
def test_vocab_sharded_loss_sums_equal_the_plain_ones(vocab_ce_world, mesh, case):
    """The dry run's placed loss (``dtensor_calls.ce_chunk_vocab_sharded``,
    the logits sharded by vocabulary) gives ``models.api._ce_chunk``'s sums
    on the same inputs, on every rank: nll and z within 1e-5 (f32, other
    summation orders), the mask and correct counts exactly — ties at the
    maximum included, decided by the first index as ``argmax`` does (the
    cases hold targets at later tied indices, which count as wrong).  No
    all-gather moves the (B, c, V) f32 logits."""
    from repro_torch.models import api

    cases, ranks = vocab_ce_world
    c = cases[case]
    logits = c["h"] @ c["head"]
    first = logits.argmax(-1)
    assert bool(((logits.gather(-1, c["t"][..., None])[..., 0] == logits.amax(-1)) & (c["t"] != first)).any())
    want = api._ce_chunk(c["h"], c["head"], c["t"], c["m"])
    for rank in ranks:
        got = rank[f"{mesh}/{case}"]
        sums = torch.tensor(got["sums"])
        torch.testing.assert_close(sums[:2], want[:2], rtol=1e-5, atol=1e-5)
        assert sums[2:].tolist() == want[2:].tolist(), (sums, want)
        assert got["collectives"]["all-gather"] < logits.numel() * 4, got["collectives"]


_PLACED_TRAIN = """
import dataclasses
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.sharding.logical import rules_for

cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=2)
shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=4, seq_len=32)
sizes = {"data": 2, "model": 4}
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
rules = rules_for("train", batch=shape.global_batch)
fn, args, _ = dryrun._program(cfg, shape, None, rules, sizes, mesh)
step, _ = dryrun._count(fn, args, "train", rules, mesh)
grads_only, _ = dryrun._count(dryrun._loss_grads(cfg, None), args[:2], "train", rules, mesh)
params, _, m, v = args
n_local = sum(p.to_local().numel() for p in dryrun.tree_leaves(params))
extra = step["bytes"] - grads_only["bytes"]
print("RESULT", step["collectives"]["all-reduce"], grads_only["collectives"]["all-reduce"], extra, n_local)
"""


def test_placed_train_step_runs_adamw_and_reduces_the_norm():
    """The dry run's placed train pass (a reduced qwen2.5-3b, 2 layers, on a
    fake (2, 4) world, in a subprocess) is the whole step: over the loss
    and gradients alone it adds the gradient norm's all-reduce and AdamW's
    traffic — at least the local parameter, moment and gradient slices
    written and read (the update's slice writes charge 2x each, f32 moments
    and parameters: >= 3 x 2 x 4 bytes a local parameter element)."""
    r = subprocess.run([sys.executable, "-c", _PLACED_TRAIN], env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    step_ar, grads_ar, extra, n_local = map(int, r.stdout.split("RESULT")[1].split())
    assert step_ar > grads_ar  # the norm's scalar all-reduce, on top of the gradients' reductions
    assert extra >= 3 * 2 * 4 * n_local, (extra, n_local)
