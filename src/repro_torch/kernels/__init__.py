"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel package keeps the JAX layout: ``ops.py`` holds the public
wrapper (dispatch by the input tensor's device), the plain version and the
launch counter; ``ref.py`` a naive oracle.  The CUDA sources live in
``repro_torch/csrc`` and are built by ``kernels.build``.
"""
from repro_torch.kernels.build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
