"""PyTorch/CUDA port of the edge LLM-partitioning system.

The JAX package ``repro`` is the reference; each module here names its
counterpart there.  Nothing in this package imports JAX or ``repro``.
"""
