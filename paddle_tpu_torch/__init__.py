"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package (paddle_tpu) is the reference; this package mirrors its
structure and names, written in PyTorch's idiom, and runs on an NVIDIA
H100. Its hot kernels are hand-written CUDA C++ for Hopper (ops/, csrc/),
each beside a plain torch version used for CPU tensors. It never imports
jax or paddle_tpu.

Entry points run on the card unless the caller asks for the CPU:
Executor() and inference.Predictor(dirname) default to CUDAPlace(0) and
raise when no card is present.
"""
from . import obs  # noqa: F401
from . import fluid  # noqa: F401
from . import ops  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from .batch import batch  # noqa: F401

__all__ = ['fluid', 'obs', 'ops', 'reader', 'dataset', 'batch']
