"""fluid.contrib of the port: the half-precision inference transpiler and
the decoder library.

Parity: the JAX package's fluid/contrib/__init__.py, reduced to
float16_transpiler and decoder; memory_usage_calc waits for a later
slice.
"""
from . import decoder
from . import float16_transpiler
from .float16_transpiler import Float16Transpiler, BF16Transpiler

__all__ = ['decoder', 'float16_transpiler', 'Float16Transpiler',
           'BF16Transpiler']
