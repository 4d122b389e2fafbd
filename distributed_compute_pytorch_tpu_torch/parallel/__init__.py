"""Parallel strategies of the port (``parallel/`` of the JAX package)."""
