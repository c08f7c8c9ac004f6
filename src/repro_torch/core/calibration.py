"""Threshold estimation (paper Appendix B; a copy of
``repro.core.calibration``, numpy only).

Given validation scores s(x) and correctness indicators for a tier, pick the
smallest θ whose plug-in failure-rate estimate

    p̂(θ) = (1/n) Σ 1[s(x_i) > θ ∧ wrong_i]

is ≤ ε.  The smallest feasible θ maximises the selection rate P(s > θ)
while keeping the rule safe (Def. 4.1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def failure_rate(scores: np.ndarray, correct: np.ndarray, theta: float) -> float:
    """p̂(θ) = P(select ∧ wrong) with selection s > θ."""
    scores = np.asarray(scores, np.float64)
    correct = np.asarray(correct, bool)
    return float(np.mean((scores > theta) & ~correct))


def selection_rate(scores: np.ndarray, theta: float) -> float:
    return float(np.mean(np.asarray(scores, np.float64) > theta))


def estimate_threshold(
    scores: np.ndarray, correct: np.ndarray, epsilon: float, *, n_samples: Optional[int] = None, seed: int = 0
) -> Tuple[float, dict]:
    """Returns (theta, info).  With no feasible θ the rule degenerates to
    'always defer' (θ = 1.0, selection rate 0), which is still safe."""
    scores = np.asarray(scores, np.float64)
    correct = np.asarray(correct, bool)
    if n_samples is not None and n_samples < len(scores):
        idx = np.random.default_rng(seed).choice(len(scores), size=n_samples, replace=False)
        scores, correct = scores[idx], correct[idx]

    # candidate thresholds: midway between distinct scores, each score, and
    # the extremes
    cand = np.unique(scores)
    cands = np.unique(np.concatenate([[-np.inf], (cand[1:] + cand[:-1]) / 2.0, cand, [1.0]]))
    best_theta, best_sel = 1.0, 0.0
    for theta in cands:
        if failure_rate(scores, correct, theta) <= epsilon:
            sel = selection_rate(scores, theta)
            if sel > best_sel or (sel == best_sel and theta < best_theta):
                best_theta, best_sel = float(theta), sel
    info = {
        "selection_rate": best_sel,
        "failure_rate": failure_rate(scores, correct, best_theta),
        "n": len(scores),
        "epsilon": epsilon,
    }
    return best_theta, info


def threshold_stability_curve(
    scores: np.ndarray, correct: np.ndarray, epsilon: float, sample_sizes=(100, 200, 400, 800, 1600, 3200), seed: int = 0
):
    """Fig. 6: θ̂ as a function of the number of calibration samples."""
    out = []
    for n in sample_sizes:
        if n > len(scores):
            break
        theta, info = estimate_threshold(scores, correct, epsilon, n_samples=n, seed=seed)
        out.append({"n": n, "theta": theta, **info})
    return out
