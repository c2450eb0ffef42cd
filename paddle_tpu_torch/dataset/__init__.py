"""Datasets of the port (parity: the JAX package's paddle_tpu.dataset),
reduced to what the training slice reads: wmt16 for Transformer. As in the
JAX package, with no download the readers yield a deterministic synthetic
corpus from a seeded generator."""
from . import common  # noqa: F401
from . import wmt16  # noqa: F401

__all__ = ['common', 'wmt16']
