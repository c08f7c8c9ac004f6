"""The weight bridge carries the JAX package's unboxed values into the port
leaf for leaf: same tree, same shapes, same dtypes, equal values (bf16
through f32 is exact)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import ensemble as j_ens
from repro.models import api as j_api
from repro.models.params import unbox
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import ensemble as t_ens
from repro_torch.models import api as t_api

SMALL = JModelConfig(
    name="tiny-s", family="dense", n_layers=2, d_model=64, d_ff=128,
    vocab_size=64, n_heads=4, n_kv_heads=2, remat=False,
)


def numpy_values(cfg, seed, k=None):
    """A values tree with the JAX package's structure, shapes and dtypes
    (from ``jax.eval_shape`` of its init), filled from a numpy seed: weights
    N(0, 1/sqrt(fan_in)), embed/head N(0, 0.02), norm scales near one and
    biases non-zero so the bias paths are exercised."""
    def init(key):
        boxed = j_api.init_params(cfg, key) if k is None else j_ens.init_ensemble(cfg, k, key)
        return unbox(boxed)[0]

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape)
        if name == "scale":
            x = 1.0 + 0.1 * x
        elif name in ("embed", "lm_head"):
            x = 0.02 * x
        elif name.startswith("b"):
            x = 0.1 * x
        else:
            x = x / np.sqrt(s.shape[-2])
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _check_round_trip(values, cfg):
    got = params_from_numpy(values, port_cfg(cfg), device="cpu")
    fv, fg = flat(values), flat(got)
    assert fv.keys() == fg.keys()
    for name, a in fv.items():
        t = fg[name]
        assert tuple(t.shape) == a.shape, name
        want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        assert t.dtype == want, name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32), err_msg=name)


@pytest.mark.parametrize("arch", ["small", "qwen2.5-3b", "internlm2-1.8b"])
@pytest.mark.parametrize("k", [None, 3])
def test_round_trip_every_leaf(arch, k):
    cfg = SMALL if arch == "small" else j_get_config(arch).reduced()
    _check_round_trip(numpy_values(cfg, seed=0, k=k), cfg)


def test_round_trip_of_jax_init():
    """The tree the JAX package's own init returns (bf16 weights, f32 norm
    scales, stacked ensemble) crosses exactly."""
    values = jax.jit(lambda key: unbox(j_ens.init_ensemble(SMALL, 2, key))[0])(jax.random.PRNGKey(0))
    _check_round_trip(jax.tree.map(np.asarray, values), SMALL)


def test_tree_matches_port_init():
    """The bridged tree and the port's own init have the same structure,
    shapes and dtypes — the port computes on either."""
    cfg = j_get_config("qwen2.5-3b").reduced()
    values = numpy_values(cfg, seed=1, k=2)
    got = flat(params_from_numpy(values, port_cfg(cfg), device="cpu"))
    own = flat(t_ens.init_ensemble(get_config("qwen2.5-3b").reduced(), 2, torch.Generator().manual_seed(0), "cpu"))
    assert got.keys() == own.keys()
    for name in got:
        assert got[name].shape == own[name].shape and got[name].dtype == own[name].dtype, name


def test_port_init_stds():
    """Seeded init draws N(0, 1/sqrt(fan_in)) like the JAX package (embed and
    head at 0.02, wo at 1/sqrt(H*hd)); norm scales start at one."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), dtype="float32")
    p = t_api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["layers"]["mlp"]["w_down"].std().item() - cfg.d_ff ** -0.5) < 3e-3
    H, hd = cfg.n_heads, cfg.head_dim
    assert abs(p["layers"]["attn"]["wo"].std().item() - (H * hd) ** -0.5) < 3e-3
    assert abs(p["layers"]["attn"]["wq"].std().item() - H ** -0.5) < 2e-2
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))


def test_layer_axis_mismatch_raises():
    values = numpy_values(SMALL, seed=2)
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(values, port_cfg(dataclasses.replace(SMALL, n_layers=3)), device="cpu")
