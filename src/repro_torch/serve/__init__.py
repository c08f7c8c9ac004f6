from repro_torch.serve.cascade_server import CascadeServer, CascadeTier

__all__ = ["CascadeServer", "CascadeTier"]
