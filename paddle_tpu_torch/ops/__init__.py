"""Hand-written CUDA kernels of the port, each beside its plain torch
version (parity: the JAX package's ops/, whose Pallas TPU kernels these
replace). `KERNELS` names every kernel; `build_all()` compiles them."""
from ._cuda import KERNELS, build_all  # noqa: F401
from .flash_attention import flash_attention, flash_attention_lse, \
    flash_attention_lse_plain, flash_attention_bwd_plain  # noqa: F401
from . import kernels  # noqa: F401  (registers the kernels of ops/kernels)

__all__ = ['flash_attention', 'flash_attention_lse',
           'flash_attention_lse_plain', 'flash_attention_bwd_plain',
           'kernels', 'KERNELS', 'build_all']
