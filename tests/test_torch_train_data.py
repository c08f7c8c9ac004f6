"""The port's data, optimiser, schedules and checkpoints against the JAX
package's: ``MixtureTask``, ``sequence_task`` and ``batches`` bitwise for
every seed, host_id and host_count; ``linear_warmup``/``cosine_schedule``
and ``adamw_update`` (global-norm clip, f32 and bf16 moments, weight decay
on every leaf) within 1e-6; checkpoints written by either package restore
bitwise in the other (bf16 included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.data import pipeline as j_pipe
from repro.data import synthetic as j_syn
from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_sched
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ModelConfig
from repro_torch.data import pipeline as t_pipe
from repro_torch.data import synthetic as t_syn
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedule as t_sched

OPT_TOL = 1e-6


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_mixture_task_bitwise(seed):
    jt, tt = j_syn.MixtureTask(seed=seed, seq_len=16), t_syn.MixtureTask(seed=seed, seq_len=16)
    assert np.array_equal(jt.w, tt.w) and np.array_equal(jt.markers, tt.markers)
    for a, b in zip(jt.sample(64, seed=seed + 1), tt.sample(64, seed=seed + 1)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed,order", [(0, 2), (5, 3)])
def test_sequence_task_bitwise(seed, order):
    a = j_syn.sequence_task(16, 24, vocab=64, order=order, seed=seed)
    b = t_syn.sequence_task(16, 24, vocab=64, order=order, seed=seed)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("seed,host_id,host_count", [(0, 0, 1), (1, 0, 2), (1, 1, 2), (7, 2, 4)])
def test_batches_bitwise(seed, host_id, host_count):
    rows = np.arange(40 * 9, dtype=np.int32).reshape(40, 9)
    kw = dict(seed=seed, epochs=2, host_id=host_id, host_count=host_count)
    got = list(t_pipe.batches(t_pipe.TokenDataset(rows), 8, **kw))
    ref = list(j_pipe.batches(j_pipe.TokenDataset(rows), 8, **kw))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k])


def test_to_device_dtypes():
    b = t_pipe.make_lm_batch(np.arange(12, dtype=np.int32).reshape(2, 6))
    b["embeds"] = np.ones((2, 5, 3), np.float32)
    t = t_pipe.to_device(b, "cpu")
    assert t["tokens"].dtype == t["targets"].dtype == torch.int64
    assert t["mask"].dtype == t["embeds"].dtype == torch.float32
    assert np.array_equal(t["tokens"].numpy(), b["tokens"])


def test_schedules_match():
    for s in range(0, 130, 7):
        for warm in (0, 10):
            np.testing.assert_allclose(float(t_sched.linear_warmup(s, warm)), float(j_sched.linear_warmup(s, warm)),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            got = t_sched.cosine_schedule(torch.tensor(s, dtype=torch.int32), 120, warm)
            np.testing.assert_allclose(float(got), float(j_sched.cosine_schedule(jnp.int32(s), 120, warm)),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def _tree(seed, big=False):
    """A small parameter tree: f32 matrices and vectors and a bf16 leaf."""
    rng = np.random.default_rng(seed)
    scale = 1e6 if big else 1.0
    return {
        "a": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
              "b": (rng.standard_normal(5) * scale).astype(np.float32)},
        "n": {"scale": (1 + 0.1 * rng.standard_normal(5)).astype(np.float32)},
        "h": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
    }


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict (JAX flattens dicts in
    sorted key order, the port in insertion order: compare by path)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _close(got, ref, tol=OPT_TOL):
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    for k in g:
        b = np.asarray(r[k], np.float32)
        np.testing.assert_allclose(g[k].float().numpy(), b, rtol=tol, atol=tol * max(1.0, np.abs(b).max()), err_msg=k)


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches(clip, moments):
    jc = j_adamw.OptimConfig(lr=1e-2, clip_norm=clip, moment_dtype=moments)
    tc = t_adamw.OptimConfig(lr=1e-2, clip_norm=clip, moment_dtype=moments)
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    jo, to = j_adamw.adamw_init(jp, jc), t_adamw.adamw_init(tp, tc)
    assert all(m.dtype == (torch.bfloat16 if moments == "bfloat16" else torch.float32) for m in tree_leaves(to["m"]))
    for i in range(3):  # the bias corrections follow the count
        grads = _tree(10 + i)
        jp, jo, jm = j_adamw.adamw_update(jax.tree.map(jnp.asarray, grads), jo, jp, jc, lr_scale=0.5)
        tp, to, tm = t_adamw.adamw_update(_t(grads), to, tp, tc, lr_scale=torch.tensor(0.5))
        _close(tp, jp)
        _close(to["m"], jo["m"])
        _close(to["v"], jo["v"])
        assert int(to["count"]) == int(jo["count"]) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=OPT_TOL)


def test_adamw_updates_in_place():
    """The new values land in the given tensors (and are returned), in their
    dtypes: f32 parameters, bf16 moments."""
    tc = t_adamw.OptimConfig(lr=1e-2, moment_dtype="bfloat16")
    p = _t(_tree(0))
    o = t_adamw.adamw_init(p, tc)
    before = [t.clone() for t in tree_leaves(p)]
    n, s, _ = t_adamw.adamw_update(_t(_tree(1)), o, p, tc)
    assert n is p and s is o and int(o["count"]) == 1
    assert all(a is b for a, b in zip(tree_leaves(n), tree_leaves(p)))
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(p)))
    assert all(m.dtype == torch.bfloat16 and m.abs().max() > 0 for m in tree_leaves(o["m"]))


def test_adamw_groups_bound_leaves():
    assert t_adamw._groups([5, 5, 5], limit=10) == [range(0, 2), range(2, 3)]
    assert t_adamw._groups([20, 1, 1], limit=10) == [range(0, 1), range(1, 3)]
    assert t_adamw._groups([], limit=10) == []


def test_adamw_slices_large_leaves(monkeypatch):
    """Leaves larger than GROUP_ELEMENTS go a slice at a time: the same
    values, bitwise, as the update that takes each leaf whole (no clip: the
    norm sums its slices in another order), and the same norm to rounding."""
    tc = t_adamw.OptimConfig(lr=1e-2, clip_norm=None)
    out = []
    for limit in (t_adamw.GROUP_ELEMENTS, 7):
        monkeypatch.setattr(t_adamw, "GROUP_ELEMENTS", limit)
        p = _t(_tree(0))
        o = t_adamw.adamw_init(p, tc)
        for i in range(2):
            p, o, m = t_adamw.adamw_update(_t(_tree(10 + i)), o, p, tc)
        out.append((tree_leaves(p), tree_leaves(o["m"]), tree_leaves(o["v"]), m["grad_norm"]))
    assert max(t.numel() for t in out[0][0]) > 7
    for a, b in zip(out[0][:3], out[1][:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_allclose(float(out[1][3]), float(out[0][3]), rtol=1e-6)
    assert t_adamw._pieces([torch.zeros(3, 5), torch.zeros(0), torch.zeros(2)], 7) == \
        [(0, 0, 7), (0, 7, 14), (0, 14, 15), (1, 0, 0), (2, 0, 2)]


def test_grad_clip_bounds_update_matches():
    """A 1e6 gradient under clip_norm 1e-3 moves each weight by at most
    lr (the step is bounded), in both packages alike."""
    jc = j_adamw.OptimConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    tc = t_adamw.OptimConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    jp, tp = {"w": jnp.ones((4, 4))}, {"w": torch.ones((4, 4))}
    jn, _, jm = j_adamw.adamw_update({"w": jnp.full((4, 4), 1e6)}, j_adamw.adamw_init(jp, jc), jp, jc)
    tn, _, tm = t_adamw.adamw_update({"w": torch.full((4, 4), 1e6)}, t_adamw.adamw_init(tp, tc), tp, tc)
    assert float(tm["grad_norm"]) > 1e5
    assert float((tn["w"] - 1.0).abs().max()) < 1.5
    _close(tn, jn)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=OPT_TOL)


def test_global_norm_matches():
    tree = _tree(4, big=True)
    np.testing.assert_allclose(float(t_adamw.global_norm(_t(tree))),
                               float(j_adamw.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=OPT_TOL)


TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, d_ff=128, vocab_size=128, n_heads=4,
                   n_kv_heads=2, remat=False)


def _model_tree(seed):
    """The TINY model's tree, bf16 weights and f32 norm scales, from numpy."""
    from repro_torch.models import api as t_api

    return params_to_numpy(t_api.init_params(TINY, torch.Generator().manual_seed(seed), "cpu"))


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_jax_checkpoint_restores_in_port(tmp_path):
    host = _model_tree(0)
    j_save(str(tmp_path), 5, jax.tree.map(jnp.asarray, host))
    assert latest_step(str(tmp_path)) == 5
    template = params_from_numpy(host, TINY, device="cpu")
    back = restore_checkpoint(str(tmp_path), template)
    got, ref = _flat(params_to_numpy(back)), _flat(host)
    assert got.keys() == ref.keys()
    for k in got:
        _bitwise(got[k], ref[k])
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(back))


def test_port_checkpoint_restores_in_jax(tmp_path):
    host = _model_tree(1)
    save_checkpoint(str(tmp_path), 9, params_from_numpy(host, TINY, device="cpu"))
    back = j_restore(str(tmp_path), jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), host))
    got, ref = _flat(back), _flat(host)
    assert got.keys() == ref.keys()
    for k in got:
        _bitwise(np.asarray(got[k]), ref[k])


def test_port_checkpoint_roundtrip_and_latest(tmp_path):
    t = params_from_numpy(_model_tree(2), TINY, device="cpu")
    save_checkpoint(str(tmp_path), 3, t)
    save_checkpoint(str(tmp_path), 12, t)
    assert latest_step(str(tmp_path)) == 12 and latest_step(str(tmp_path / "none")) is None
    back = restore_checkpoint(str(tmp_path), t, step=3)
    for a, b in zip(tree_leaves(t), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), t)
