"""Roofline terms of a dry run (port of ``repro.launch.roofline``).

compute term    = FLOPs per rank / peak FLOP/s
memory term     = bytes per rank / HBM bytes a second
collective term = collective bytes / (ranks x link bytes a second)

The FLOPs and bytes come from ``launch.op_cost`` over the global program,
divided by the ranks; the collective bytes are the output bytes of every
collective the sharded step issues, by kind (``collective_terms``), where
the JAX package parses them from the partitioned HLO: PyTorch has no HLO,
and DTensor's sharding propagation issues its collectives as ops the op
counter sees.  The rates are ``core.cost_model.H100_SXM``'s, the card's
spec-sheet figures.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.cost_model import H100_SXM
from repro_torch.launch.op_cost import KINDS


def collective_terms(counter) -> Dict[str, int]:
    """Bytes moved by collectives, by kind (all-gather, all-reduce,
    reduce-scatter, all-to-all, collective-permute), of an ``OpCounter``
    or its ``summary()``."""
    coll = counter["collectives"] if isinstance(counter, dict) else counter.collectives
    return {k: int(coll.get(k, 0)) for k in KINDS}


def roofline_terms(cost: dict, collective_bytes: int, n_chips: int, hw: dict = H100_SXM) -> dict:
    """``cost``: per-rank ``{"flops", "bytes accessed"}``; the JAX
    function's inputs, keys and ``bottleneck``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = byts / hw["hbm_bw"]
    t_collective = collective_bytes / n_chips / hw["ici_bw"]
    terms = {
        "flops": flops,
        "bytes": byts,
        "collective_bytes": collective_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
    }
    dom = max(("compute", t_compute), ("memory", t_memory), ("collective", t_collective), key=lambda kv: kv[1])
    terms["bottleneck"] = dom[0]
    terms["t_bound_s"] = dom[1]
    return terms
