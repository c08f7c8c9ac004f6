"""ABC cost model (paper §4.1, §4.4, §5.2) and the paper's published cost
constants (a copy of ``repro.core.cost_model``, numpy only), kept verbatim
so the dollar and latency tables reproduce offline.

The JAX package's TPU roofline constants are not copied: no TPU figure
enters the port.  Its counterpart is ``H100_SXM``, the card's spec-sheet
figures, which the roofline (``launch/roofline.py``) and ``chip_smoke.py``'s
bounds read; the card's own numbers come from measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------------------
# Eq. 1 and Prop 4.1.2
# ---------------------------------------------------------------------------


def ensemble_cost(c0: float, k: int, rho: float) -> float:
    """C(H^k) = c0 · k^(1-ρ): ρ=1 fully parallel, ρ=0 sequential."""
    assert 0.0 <= rho <= 1.0 and k >= 1
    return c0 * k ** (1.0 - rho)


def two_level_expected_cost(gamma: float, k: int, rho: float, defer_rate: float, c_large: float = 1.0) -> float:
    """Prop 4.1.2 as the paper prints it: E[C(M_r)] = (k^ρ·γ + P(r=1)) · C(h2)."""
    return (k**rho * gamma + defer_rate) * c_large


def fraction_cost_saved(gamma: float, k: int, rho: float, selection_rate: float) -> float:
    """Fig. 3: 1 - E[C]/C(h2); the lower tier always runs (cost
    k^(1-ρ)·γ·C), the large model runs on deferrals."""
    lower = ensemble_cost(gamma, k, rho)
    expected = lower + (1.0 - selection_rate)
    return 1.0 - expected


def multi_tier_expected_cost(
    tier_costs: Sequence[float], ks: Sequence[int], rho: float, reach_probs: Sequence[float]
) -> float:
    """E[C] = Σ_i P(reach tier i) · C_i(k_i, ρ)."""
    assert len(tier_costs) == len(ks) == len(reach_probs)
    return float(sum(p * ensemble_cost(c, k, rho) for c, k, p in zip(tier_costs, ks, reach_probs)))


# ---------------------------------------------------------------------------
# Published constants (paper Tables 1 & 4, §5.2.1 delay grid)
# ---------------------------------------------------------------------------

# Table 4 — Lambda Cloud GPU rental (USD/hour, September 2024)
LAMBDA_GPU_PRICES = {"V100": 0.50, "A6000": 0.80, "A100": 1.29, "H100": 2.49}

# §5.2.1 — edge-to-cloud delay grid (seconds)
EDGE_DELAYS = {"local_ipc": 1e-6, "small": 10e-3, "medium": 100e-3, "large": 1.0}

# NVIDIA H100 SXM5 roofline constants, from NVIDIA's H100 datasheet (dense
# tensor-core rates, no sparsity), with the keys of the JAX package's
# ``TPU_V5E``.  ``ici_bw`` is the link figure: NVLink 4, 450e9 B/s each way
# per GPU (900e9 both ways) between the 8 GPUs of one node; ranks past one
# node cross InfiniBand, at far less (50e9 B/s a 400 Gb/s NIC).
H100_SXM = {
    "peak_flops_bf16": 989e12,  # FLOP/s per GPU, dense bf16 tensor cores
    "peak_flops_tf32": 495e12,  # dense TF32 tensor cores
    "peak_flops_f32": 67e12,  # f32 on the CUDA cores, outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s per GPU, HBM3
    "ici_bw": 450e9,  # B/s per GPU each way, NVLink 4 within a node
}

# Table 1 — Together.ai serverless pricing (USD per million tokens)
TOGETHER_PRICES = {
    "llama3.1-8b-instruct-turbo": 0.18,
    "gemma2-9b-it": 0.30,
    "llama3-8b-instruct-lite": 0.10,
    "llama3.1-70b-instruct-turbo": 0.88,
    "gemma2-27b-instruct": 0.80,
    "qwen2-72b-instruct": 0.90,
    "llama3.1-405b-instruct-turbo": 5.00,
}

API_TIERS = {
    1: ["llama3.1-8b-instruct-turbo", "gemma2-9b-it", "llama3-8b-instruct-lite"],
    2: ["llama3.1-70b-instruct-turbo", "gemma2-27b-instruct", "qwen2-72b-instruct"],
    3: ["llama3.1-405b-instruct-turbo"],
}


@dataclasses.dataclass(frozen=True)
class EdgeCloudCost:
    """§5.2.1: the response latency is dominated by the edge->cloud delay,
    paid only on deferral; on-device inference pays local IPC."""

    delay: float  # seconds per deferred request
    local: float = 1e-6

    def mean_latency(self, defer_rate: float, edge_compute: float = 0.0) -> float:
        return edge_compute + self.local + defer_rate * self.delay


def gpu_rental_cost(tier_gpus: Sequence[str], tier_fracs: Sequence[float]) -> float:
    """§5.2.2: Σ fraction of requests served · GPU $/hour, per tier (the
    paper's Table 5 'Total GPU Cost' columns)."""
    return float(sum(LAMBDA_GPU_PRICES[g] * f for g, f in zip(tier_gpus, tier_fracs)))


def api_cost_per_query(
    tier_prices: Sequence[float], reach_probs: Sequence[float], tokens_per_query: float = 1000.0
) -> float:
    """§5.2.3: expected $ per query; every reached tier's members are billed."""
    return float(sum(p * c * tokens_per_query / 1e6 for c, p in zip(tier_prices, reach_probs)))
