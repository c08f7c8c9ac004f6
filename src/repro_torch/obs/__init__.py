from repro_torch.obs.registry import Counter, MetricsRegistry, global_registry

__all__ = ["Counter", "MetricsRegistry", "global_registry"]
