"""The JAX package's five examples on the port, each a module with
``main(argv=None)`` that takes ``--device`` (default: the card, raising
without one) and the reference script's size options, and prints the
reference script's lines:

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_cascade
    PYTHONPATH=src python -m repro_torch.examples.continuous_batching
    PYTHONPATH=src python -m repro_torch.examples.edge_to_cloud
    PYTHONPATH=src python -m repro_torch.examples.train_then_cascade --steps 300

Weights are drawn from ``torch.Generator``s seeded as the reference seeds
its PRNG keys, so the port's numbers are its own, not the reference's.
"""
