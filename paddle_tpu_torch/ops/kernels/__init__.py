"""Kernels of the port that replace the JAX package's ops/kernels/ (the
Pallas kernel layer). There is no registry and no enablement knob: every
wrapper launches its CUDA kernel for tensors on the card and runs its
plain torch version for tensors on the CPU. The paged decode attention
(ops/kernels/paged_attention.py) waits for the DecodeEngine slice."""
from .sparse_optim import fused_sparse_adagrad, fused_sparse_adam, \
    fused_sparse_adagrad_plain, fused_sparse_adam_plain  # noqa: F401

__all__ = ['fused_sparse_adagrad', 'fused_sparse_adam',
           'fused_sparse_adagrad_plain', 'fused_sparse_adam_plain']
