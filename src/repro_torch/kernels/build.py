"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (loaded with ``ctypes``), so the build needs no
PyTorch headers and takes seconds.  All sources compile in parallel on the
first ``library()`` call, into ``build/torch_kernels/`` under the repo root
(git-ignored); a library whose hash (its source and the ``csrc`` headers it
includes, such as ``attention_common.cuh``) matches is reused.

Launch counting: each wrapper owns a ``kernels.<name>.launches`` counter on
the process-wide registry and adds one where it launches a kernel — never
on the plain CPU path.  ``KERNELS`` names every counter; a source may hold
more than one kernel (``decode_attention.cu`` holds the dense and the paged
decode kernels).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from repro_torch.obs import global_registry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("agreement", "compaction", "flash_attention", "decode_attention", "mamba2_ssd", "rwkv6_wkv")
KERNELS = SOURCES + ("decode_attention_paged",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_longlong, ctypes.c_float
# argtypes of every exported entry point (all return a cudaError_t as int)
SIGNATURES = {
    "agreement": {"agreement_member_stats": [_P, _P, _P, _P, _I, _I, _P]},
    "compaction": {
        "compaction_compact": [_P, _I, _P, _P, _P, _I, _P],
        "compaction_gather": [_P, _I, _P, _I, _P],
        "compaction_paged_kv_view": [_P] * 5 + [_I] * 5 + [_LL, _I, _P],
    },
    "flash_attention": {
        "flash_attention_fwd": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P],
        "flash_attention_fwd_f16": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P],
        "flash_attention_fwd_f32": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P],
    },
    "decode_attention": {
        "decode_attention_fwd": [_P] * 5 + [_I, _P] + [_I] * 6 + [_F] * 2 + [_P],
        "decode_attention_fwd_f16": [_P] * 5 + [_I, _P] + [_I] * 6 + [_F] * 2 + [_P],
        "decode_attention_fwd_f32": [_P] * 5 + [_I, _P] + [_I] * 6 + [_F] * 2 + [_P],
        "decode_attention_paged_fwd": [_P] * 6 + [_I] * 9 + [_F] * 2 + [_P],
        "decode_attention_paged_fwd_f16": [_P] * 6 + [_I] * 9 + [_F] * 2 + [_P],
        "decode_attention_paged_fwd_f32": [_P] * 6 + [_I] * 9 + [_F] * 2 + [_P],
    },
    "mamba2_ssd": {"mamba2_ssd_fwd": [_P] * 8 + [_I] * 7 + [_L] * 6 + [_I, _P]},
    "rwkv6_wkv": {"rwkv6_wkv_fwd": [_P] * 8 + [_I] * 6 + [_P]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_ONLY = False


def load_only() -> None:
    """From now on this process loads the kernels and builds none:
    ``build_all`` raises where a library is missing.  For ranks that share a
    card with the process that built the kernels before starting them."""
    global _LOAD_ONLY
    _LOAD_ONLY = True


def launch_counter(name: str):
    return global_registry().counter(f"kernels.{name}.launches")


def launch_counts() -> Dict[str, int]:
    return {n: launch_counter(n).value for n in KERNELS}


def reset_launch_counts() -> None:
    for n in KERNELS:
        launch_counter(n).reset()


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return exe


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).exists()]
    return seen


def _target(name: str) -> Path:
    """The library path for ``name``: named by a hash of its source and the
    headers it includes, so an edited shared header rebuilds every user."""
    h = hashlib.sha256()
    for path in _sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once.
    Returns name -> library path; ptxas reports go to ``<lib>.log``."""
    targets = {n: _target(n) for n in SOURCES}
    missing = [str(so) for so in targets.values() if not so.exists()]
    if _LOAD_ONLY and missing:
        raise RuntimeError(f"this process only loads kernels, and these are not built: {missing}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, log)
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n}: nvcc exit {rc}\n{targets[n].with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (building on first use)."""
    with _LOCK:
        if name not in _LIBS:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


@functools.cache
def entry(name: str, fn: str):
    """The ctypes function ``fn`` of ``csrc/<name>.cu``, looked up once, so
    a wrapper's later calls skip ``library()``'s lock."""
    return getattr(library(name), fn)


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw handle a
    launch takes.  The raw getter (the one Triton's launcher uses) skips
    building a ``torch.cuda.Stream`` object, which cost several µs of host
    time a launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.kernel_error_string(rc).decode()})")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and some input requires grad: a kernel's output must
    then carry a ``grad_fn``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def inference_only(op: str, *tensors) -> None:
    """Refuse a launch whose output autograd would need: a kernel whose
    output is allocated here and filled through ``ctypes`` carries no
    ``grad_fn``, so under grad mode a loss through it would leave every
    upstream weight without a gradient, silently.  The kernels with a
    training route wrap theirs in a ``torch.autograd.Function``; the others
    (agreement, compaction, decode) are inference-only and raise here."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{op}: inference-only CUDA kernel called on a tensor that requires grad "
            "(it has no backward); run it under torch.no_grad() or detach its inputs"
        )


def recompute_grads(ctx, plain, saved, grads_out):
    """Input gradients by recomputing the plain version under autograd:
    ``saved`` the forward's inputs (None where absent), ``grads_out`` the
    gradients of its outputs (None where unused)."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*inputs)
    pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    want = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs], allow_unused=True)
               if pairs and want else [None] * len(want))
    return tuple(next(got) if t is not None and t.requires_grad else None for t in inputs)


def require_cuda(t: torch.Tensor, name: str, dtypes, *, align: int = 16) -> None:
    """Wrapper-side validation: the kernels take contiguous tensors of
    the listed dtypes on a CUDA device, ``align``-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer must be {align}-byte aligned")


# ---------------------------------------------------------------------------
# a kernel's work, which its meta route charges (``obs.op_charges``) and
# chip_smoke.py's bounds divide by the card's rates.  A meta tensor
# computes nothing, so that route is no fallback.
# ---------------------------------------------------------------------------


def nbytes(*ts) -> int:
    """Bytes of the given tensors (None skipped), numel x element size."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_cost(n_bytes: int, n_ops: int, unit: str) -> dict:
    """A kernel call's work: the bytes it must move (each operand read
    once, each output written once), the operations it does and the unit
    they run on ('bf16' or 'tf32' tensor cores, 'f32' CUDA cores) — what a
    bound divides by the card's rates and the op counter charges."""
    return {"bytes": int(n_bytes), "flops": int(n_ops), "unit": unit}
