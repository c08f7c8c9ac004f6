"""Training loop: step + metrics logging + periodic checkpoints (port of
``repro.train.loop``).  The step runs eagerly; metrics are read back to
the host only on logged steps."""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional


def train_loop(
    train_step: Callable,
    state,
    data_iter: Iterator[dict],
    *,
    steps: int,
    log_every: int = 10,
    checkpoint_every: Optional[int] = None,
    checkpoint_fn: Optional[Callable] = None,
    log_fn=print,
):
    """Runs ``steps`` steps; returns (state, history), one history entry
    (the step's metrics as floats, plus ``wall`` seconds) for the first
    step and every ``log_every``-th."""
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = next(data_iter)
        state, metrics = train_step(state, batch)
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall"] = time.time() - t0
            history.append(m)
            log_fn(
                f"step {i+1:5d}  loss={m['loss']:.4f}  ce={m.get('ce', 0):.4f}  "
                f"acc={m.get('acc', 0):.3f}  gnorm={m.get('grad_norm', 0):.2f}  "
                f"({m['wall']:.1f}s)"
            )
        if checkpoint_every and checkpoint_fn and (i + 1) % checkpoint_every == 0:
            checkpoint_fn(state, i + 1)
    return state, history
