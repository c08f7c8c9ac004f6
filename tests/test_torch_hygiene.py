"""Port hygiene: the port never imports JAX or the JAX package, never runs
on the CPU unless asked, and launches no kernel on a CPU call."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig
c1, c2 = get_config("qwen2.5-3b").reduced(), get_config("internlm2-1.8b").reduced()
g = torch.Generator().manual_seed(0)
server = CascadeServer([
    CascadeTier(c1, ens.init_ensemble(c1, 3, g, "cpu"), TierSpec("s", "vote", 0.5, k=3), device="cpu"),
    CascadeTier(c2, ens.init_ensemble(c2, 1, g, "cpu"), TierSpec("b", "confidence", -1.0), device="cpu"),
], device="cpu")
res = server.classify(np.random.default_rng(0).integers(0, 512, (8, 16)).astype(np.int32))
assert res.tier_counts.sum() == 8, res
reqs = [Request(tokens=np.arange(3 + i, dtype=np.int32), max_new_tokens=2) for i in range(4)]
assert len(server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32, page_size=8))) == 4
c3, c4 = get_config("zamba2-2.7b").reduced(), get_config("rwkv6-7b").reduced()
server = CascadeServer([
    CascadeTier(c3, ens.init_ensemble(c3, 3, g, "cpu"), TierSpec("h", "vote", 0.5, k=3), device="cpu"),
    CascadeTier(c4, ens.init_ensemble(c4, 1, g, "cpu"), TierSpec("r", "confidence", -1.0), device="cpu"),
], device="cpu")
assert len(server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32))) == 4
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
assert not bad, bad
print("OK")
"""


def test_subprocess_classify_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-2000:]


FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b[\s.])", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py")) + ["chip_smoke.py", "chip_scan_compare.py", "chip_adamw_compare.py",
                                   "chip_member_products.py", "dryrun_compare.py"])
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def _tiny_server(device_kw, arch="internlm2-1.8b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=1)
    vals = ens.init_ensemble(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    tier = CascadeTier(cfg, vals, TierSpec("only", "confidence", -1.0), device="cpu")
    return CascadeServer([tier], **device_kw)


def test_no_gpu_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_server({})
    cfg = get_config("internlm2-1.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeTier(cfg, {}, TierSpec("x", "confidence", -1.0))


def test_cpu_call_launches_no_kernel():
    kernels.reset_launch_counts()
    toks = np.random.default_rng(0).integers(0, 512, (8, 8)).astype(np.int32)
    reqs = [Request(tokens=toks[i], max_new_tokens=2) for i in range(3)]
    for arch, modes in (("internlm2-1.8b", (True, False)), ("zamba2-2.7b", (False,)), ("rwkv6-7b", (False,))):
        server = _tiny_server({"device": "cpu"}, arch)
        server.classify(toks)
        server.generate(toks, 2)
        for paged in modes:
            server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32, page_size=8, paged=paged))
    assert set(kernels.launch_counts()) == {
        "agreement", "compaction", "flash_attention", "decode_attention", "decode_attention_paged",
        "mamba2_ssd", "rwkv6_wkv",
    }
    assert kernels.launch_counts() == {n: 0 for n in kernels.launch_counts()}


FAMILIES_SCRIPT = r"""
import sys
import numpy as np, torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ensemble as ens
from repro_torch.models import api
g = torch.Generator().manual_seed(0)
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced()
    vals = ens.init_ensemble(cfg, 2, g, "cpu")
    rng = np.random.default_rng(0)
    if cfg.is_encoder:
        batch = {"embeds": torch.randn(2, 8, cfg.frontend_dim, generator=g).to(torch.bfloat16)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
        if cfg.n_vision_tokens:
            batch["embeds"] = torch.randn(2, cfg.n_vision_tokens, cfg.frontend_dim, generator=g).to(torch.bfloat16)
    assert torch.isfinite(ens.ensemble_last_logits(vals, batch, cfg)).all(), arch
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
assert not bad, bad
print("OK")
"""


def test_subprocess_all_ten_configs_import_no_jax():
    """Every config module, the MoE block and the frontends run with no JAX
    and nothing of the JAX package in the process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", FAMILIES_SCRIPT], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-2000:]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b", "internvl2-26b"])
def test_cpu_call_of_new_families_launches_no_kernel(arch):
    kernels.reset_launch_counts()
    toks = np.random.default_rng(0).integers(0, 512, (4, 8)).astype(np.int32)
    reqs = [Request(tokens=toks[i], max_new_tokens=2) for i in range(3)]
    cfg = get_config(arch).reduced()  # llama4's interleave needs its 2 layers
    vals = ens.init_ensemble(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    server = CascadeServer([CascadeTier(cfg, vals, TierSpec("only", "confidence", -1.0), device="cpu")], device="cpu")
    server.classify(toks)
    server.generate(toks, 2)
    for paged in (True, False):
        server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32, page_size=8, paged=paged))
    assert kernels.launch_counts() == {n: 0 for n in kernels.launch_counts()}


def test_kernel_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source and every csrc header the
    source includes (directly or through a header), so editing a shared
    header rebuilds each library that uses it and no other."""
    from repro_torch.kernels import build

    assert [p.name for p in build._sources_of("flash_attention")] == ["flash_attention.cu", "attention_common.cuh"]
    assert [p.name for p in build._sources_of("decode_attention")] == ["decode_attention.cu", "attention_common.cuh"]
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\n")
    a, b = build._target("a"), build._target("b")
    (tmp_path / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert build._target("a") != a and build._target("b") == b



TRAIN_SCRIPT = r"""
import sys, tempfile
import numpy as np, torch
import repro_torch.checkpoint, repro_torch.data, repro_torch.optim, repro_torch.train
from repro_torch.launch import train as cli
with tempfile.TemporaryDirectory() as d:
    hist = cli.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                     "--n-examples", "8", "--ckpt-dir", d, "--device", "cpu"])
    assert np.isfinite(hist[-1]["loss"]) and repro_torch.checkpoint.latest_step(d) == 2
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
assert not bad, bad
print("OK")
"""


def test_subprocess_training_imports_no_jax():
    """The training subpackages (data, optim, checkpoint, train, launch)
    run the train CLI with no JAX and nothing of the JAX package loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-2000:]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b", "mixtral-8x22b", "hubert-xlarge"])
def test_cpu_train_step_launches_no_kernel(arch):
    from repro_torch.models import api
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    if cfg.is_encoder:
        batch["embeds"] = rng.standard_normal((2, 8, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    state = init_train_state(api.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), OptimConfig())
    kernels.reset_launch_counts()
    state, m = make_train_step(cfg, OptimConfig(), total_steps=4, warmup_steps=1)(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert kernels.launch_counts() == {n: 0 for n in kernels.launch_counts()}
