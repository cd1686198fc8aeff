"""PyTorch/CUDA port of the FedAT reproduction (the JAX package ``repro``
is the reference).

Mirrors ``src/repro/`` module for module at the same relative paths.  It
imports torch and numpy only — never jax, never ``repro``.  Entry points
run on the card unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).
"""
