"""PyTorch/CUDA port of the agreement-based cascade (``repro``'s twin).

Module names mirror the JAX package: ``repro_torch.core.cascade`` is the
port of ``repro.core.cascade`` and so on.  The package imports torch and
numpy only; each kernel under ``kernels/`` dispatches on the device of its
input tensor (the plain PyTorch version for a CPU tensor, the hand-written
CUDA kernel in ``csrc/`` for a CUDA tensor).
"""
