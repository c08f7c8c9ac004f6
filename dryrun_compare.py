#!/usr/bin/env python3
"""The port's dry run against the JAX package's, cell by cell: the
collective bytes a rank moves, by kind, side by side.

    python3 dryrun_compare.py --out DIR [--arch qwen2.5-3b] [--shape decode_32k prefill_32k train_4k]

Runs, each in a subprocess of its own, ``python -m repro.launch.dryrun``
(the JAX package's: XLA's partitioner on 256 forced host devices, the
collectives parsed from the compiled HLO) and ``python -m
repro_torch.launch.dryrun`` (the port's: DTensor on a 256-rank fake world)
for every shape on the ``pod16x16`` mesh, their records under
``DIR/jax`` and ``DIR/port``, then prints one JSON line a cell: each
kind's bytes, the port's over the reference's, and the kinds where the
port moves more than twice the reference's bytes.  The port's dry run
charges a shard moved from one dim to another as the all-to-all NCCL
runs (``launch.dryrun._shard_moves_as_all_to_all``); it runs a second
time with that accounting off (records under ``DIR/port_gathers``: each
move charged as the all-gather DTensor issues on a CPU mesh), so the
program's own collectives read apart from that accounting
(``port_gathers`` in the line).  Needs no card; keep DIR out of the
repository.

The JAX dry run builds its mesh with ``jax.make_mesh``, whose axes are
explicit by default on JAX 0.9 (sharding in types), where the reference
was written for axes that are not: its embedding gather then fails with
``DuplicateSpecError``.  Its subprocess therefore makes ``jax.make_mesh``
build Auto axes before running the module unchanged.  This script imports
neither JAX nor either package itself.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the JAX dry run as its module runs, with jax.make_mesh building Auto axes
JAX_RUNNER = (
    "import os, runpy, sys; "
    "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=512'; "
    "import jax; from jax.sharding import AxisType; _mm = jax.make_mesh; "
    "jax.make_mesh = lambda shape, axes, **kw: _mm(shape, axes, "
    "axis_types=(AxisType.Auto,) * len(axes), **{k: v for k, v in kw.items() if k != 'axis_types'}); "
    "sys.argv = ['dryrun'] + sys.argv[1:]; runpy.run_module('repro.launch.dryrun', run_name='__main__')"
)

# the port's dry run with each shard move charged as the all-gather DTensor
# issues on a CPU mesh
PORT_GATHERS_RUNNER = (
    "import contextlib, sys; from repro_torch.launch import dryrun; "
    "dryrun._shard_moves_as_all_to_all = contextlib.nullcontext; sys.exit(dryrun.main(sys.argv[1:]))"
)


def run(cmd, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run(cmd + ["--out", out_dir], env=env, capture_output=True, text=True, timeout=3600)
    if r.returncode:
        raise SystemExit(f"{' '.join(cmd[:3])}: exit {r.returncode}\n{r.stdout[-2000:]}{r.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", nargs="+", default=["decode_32k", "prefill_32k", "train_4k"])
    args = ap.parse_args(argv)
    for shape in args.shape:
        cell = ["--arch", args.arch, "--shape", shape, "--multi-pod", "false"]
        run([sys.executable, "-c", JAX_RUNNER] + cell, os.path.join(args.out, "jax"))
        run([sys.executable, "-m", "repro_torch.launch.dryrun"] + cell, os.path.join(args.out, "port"))
        run([sys.executable, "-c", PORT_GATHERS_RUNNER] + cell, os.path.join(args.out, "port_gathers"))
        name = f"{args.arch}__{shape}__pod16x16.json"
        recs = {side: json.load(open(os.path.join(args.out, side, name))) for side in ("jax", "port", "port_gathers")}
        coll = {side: {k: recs[side]["collectives"].get(k, 0) for k in KINDS} for side in recs}
        ratio = {k: (coll["port"][k] / coll["jax"][k]) if coll["jax"][k] else None for k in KINDS}
        over = [k for k in KINDS if coll["port"][k] > 2 * coll["jax"][k]]
        print(json.dumps({"cell": f"{args.arch} {shape} pod16x16", "jax": coll["jax"], "port": coll["port"],
                          "port_gathers": coll["port_gathers"], "port_over_jax": ratio, "port_over_2x": over,
                          "bottleneck": {s: recs[s]["roofline"]["bottleneck"] for s in recs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
