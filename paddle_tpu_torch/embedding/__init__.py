"""Embedding plumbing of the port (parity: the JAX package's embedding/),
reduced to the static-shape dedup that the sparse optimizer merge needs.
The sharded lookup wire, vocab tables and tiers wait for later slices."""
from .lookup import dedup_plan  # noqa: F401

__all__ = ['dedup_plan']
