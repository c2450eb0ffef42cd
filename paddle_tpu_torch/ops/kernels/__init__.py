"""Kernels of the port that replace the JAX package's ops/kernels/ (the
Pallas kernel layer). There is no registry and no enablement knob: every
wrapper launches its CUDA kernel for tensors on the card and runs its
plain torch version for tensors on the CPU."""
from .paged_attention import attend, paged_attention, \
    paged_attention_plain  # noqa: F401
from .sparse_optim import fused_sparse_adagrad, fused_sparse_adam, \
    fused_sparse_adagrad_plain, fused_sparse_adam_plain, \
    fused_sparse_adagrad_rows, fused_sparse_adam_rows, \
    fused_sparse_adagrad_rows_plain, fused_sparse_adam_rows_plain, \
    merge_rows  # noqa: F401

__all__ = ['fused_sparse_adagrad', 'fused_sparse_adam',
           'fused_sparse_adagrad_plain', 'fused_sparse_adam_plain',
           'fused_sparse_adagrad_rows', 'fused_sparse_adam_rows',
           'fused_sparse_adagrad_rows_plain', 'fused_sparse_adam_rows_plain',
           'merge_rows',
           'paged_attention', 'paged_attention_plain', 'attend']
