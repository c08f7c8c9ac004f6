"""Theory quantities (Prop 4.1, Appendix A; a copy of
``repro.core.theory``, numpy only).

Every function works on empirical arrays, so the theorem's inequalities can
be checked exactly on finite samples where the proof's decomposition is an
identity.
"""
from __future__ import annotations

import numpy as np


def risk(pred: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean(np.asarray(pred) != np.asarray(y)))


def cascade_risk_decomposition(small_pred: np.ndarray, large_pred: np.ndarray, defer: np.ndarray, y: np.ndarray):
    """R(M_r) = P(r=0, H1≠y) + P(r=1, h2≠y)  (proof of Prop 4.1.1)."""
    defer = np.asarray(defer, bool)
    t1 = np.mean(~defer & (small_pred != y))
    t2 = np.mean(defer & (large_pred != y))
    casc = np.where(defer, large_pred, small_pred)
    assert abs((t1 + t2) - risk(casc, y)) < 1e-12
    return float(t1), float(t2), risk(casc, y)


def safe_rule_epsilon(small_pred, defer, y) -> float:
    """ε̂ = P(r=0 ∧ H1 wrong) — the Def 4.1 failure mass."""
    defer = np.asarray(defer, bool)
    return float(np.mean(~defer & (np.asarray(small_pred) != np.asarray(y))))


def excess_risk(small_pred, large_pred, defer, y) -> float:
    """R_excess = R(M_r) - R(h2)  (Appendix A, Eq. 6)."""
    casc = np.where(np.asarray(defer, bool), large_pred, small_pred)
    return risk(casc, y) - risk(large_pred, y)


def excess_risk_identity(small_pred, large_pred, defer, y) -> float:
    """Appendix A Eq. 6: R_excess = (P(H1≠y | r=0) - P(h2≠y | r=0)) · P(r=0)."""
    defer = np.asarray(defer, bool)
    sel = ~defer
    if not sel.any():
        return 0.0
    p_sel = sel.mean()
    a = np.mean(np.asarray(small_pred)[sel] != np.asarray(y)[sel])
    b = np.mean(np.asarray(large_pred)[sel] != np.asarray(y)[sel])
    return float((a - b) * p_sel)


def admissible(small_pred, large_pred, defer, y) -> bool:
    """Def A.1: the cascade is admissible iff its excess risk <= 0."""
    return excess_risk(small_pred, large_pred, defer, y) <= 1e-12
