"""AdamW and LR schedules on tensors (port of ``repro.optim``)."""
from repro_torch.optim.adamw import OptimConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["OptimConfig", "adamw_init", "adamw_update", "global_norm", "cosine_schedule", "linear_warmup"]
