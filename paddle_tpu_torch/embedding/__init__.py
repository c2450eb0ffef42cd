"""Embedding plumbing of the port (parity: the JAX package's embedding/),
reduced to the static-shape dedup that the sparse optimizer merge needs
and the int8 row codec of the delta publisher (quant_rows). The sharded
lookup wire and the tier store wait for later slices."""
from . import quant_rows  # noqa: F401
from .lookup import dedup_plan  # noqa: F401

__all__ = ['dedup_plan', 'quant_rows']
